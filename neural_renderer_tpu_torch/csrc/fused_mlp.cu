// Fused MLP of the tcnn-layout shell network on wgmma (replaces the TPU
// kernel neural_renderer_tpu/ops/fused_network.py::_mlp_kernel, :41,
// pallas_call :70).
//
// The function: encode_inputs' [N, 112] f32 rows -> [16, N] f32 outputs,
// channel-major. Each feature is rounded to bf16 (round to nearest even),
// then four bias-free hidden layers of width 128 with LeakyReLU 0.01, each
// hidden activation re-rounded to bf16, and a linear 16-row output layer;
// bf16 operands, f32 accumulation.
//
// Bound on the H100 (ops/bounds.py::mlp_seconds): 65,536 multiply-adds a
// row on the bf16 tensor cores against 448 B read and 64 B written a row.
// At 131,072 rows the bytes decide it (0.0200 ms against 0.0174 ms of
// operations), so the kernel has to keep device memory streaming while the
// tensor cores run at most of their rate. The design:
//
// - Persistent blocks, one per SM, 288 threads: two consumer warpgroups and
//   one producer warp. The producer's first lane copies the weight image
//   (ops/fused_network.py::pack_weights, 135,168 B, bf16, K-major and
//   128-byte swizzled as a wgmma shared-memory descriptor reads it) into
//   shared memory once with bulk asynchronous copies, one mbarrier a
//   matrix so that layer 0 starts when its 32 KB have landed, then streams
//   the
//   block's 64-row input tiles (28,672 contiguous bytes of f32 rows; the
//   ragged last tile only its rows) into a two-stage ring with
//   cp.async.bulk and mbarrier complete_tx. Tile i of a block goes to
//   stage i % 2 and to consumer warpgroup i % 2.
// - Each warpgroup forms layer 0's A operand in registers from its staged
//   f32 rows (7 k16 steps; the 8th would be the zero padding and is
//   skipped) and releases the stage at once (after fence.proxy.async: the
//   mbarrier alone does not order its generic reads before the next bulk
//   copy, which then overwrote rows still being read), so the next tile's
//   copy runs under this tile's five layers. Every layer is
//   wgmma.mma_async.m64n128k16 bf16 -> f32 (64 accumulators a thread), the
//   output layer m64n16k16; LeakyReLU and the bf16 rounding run on the
//   accumulators, which are already the next layer's register A fragments
//   (after wgmma.fence). Activations never touch memory.
// - The two warpgroups ping-pong on named barriers: one issues a layer's
//   products while the other runs its epilogue, so the tensor cores see
//   one warpgroup's products at a time. On an H100 (PERF.md) the kernel
//   without the turns ran 8-27% slower, and three consumer warpgroups with
//   three stages (FM_CONSUMERS 3, which the code takes as it is) no
//   faster.
// - Bank conflicts: the rows keep their 448-byte stride in shared memory
//   (one contiguous bulk copy per tile). Read as A fragments in the plain
//   k order, lanes g and g + 2 would hit the same banks (a 4-way
//   conflict). Instead the image orders layer 0's columns so that thread
//   (g, t) of a k16 step reads features 4t .. 4t + 3 of its rows, one
//   16-byte load a row: an 8-lane phase of a 128-bit load then covers two
//   rows of 64 bytes at stride 448 = 16 banks apart, all 32 banks, no
//   conflict. The order is a permutation of the k sum and changes no
//   product.
// - Output: stored directly, not staged in shared memory: each store
//   instruction of a warp writes four whole 32-byte sectors (8
//   consecutive rows of 4 channels), so device memory sees the bytes a
//   staged 256-byte row would write. On an H100 (PERF.md) a version that
//   staged each warpgroup's 64 x 16 tile and wrote 256-byte channel rows
//   in 16-byte stores ran within the direct stores' spread, at 131,072
//   and at 2^21 rows.
//
// Shared memory: 135,168 weights + 2 x 28,672 stages + 9 barriers + 1 KB
// to align the image to the 1024-byte swizzle atom = 193,608 bytes.
#include <cuda_bf16.h>
#include <stdint.h>

#include "mt.cuh"

#define FM_IN 112                   // encoded features a row
#define FM_OUT 16
#define FM_TILE 64                  // rows a wgmma tile
#define FM_K0_STEPS (FM_IN / 16)    // layer 0's k16 steps
#define FM_CONSUMERS 2              // consumer warpgroups
#define FM_THREADS (FM_CONSUMERS * 128 + 32)
#define FM_MAT_BYTES (128 * 128 * 2)          // one hidden matrix
#define FM_HALF_BYTES (128 * 64 * 2)          // its 64-column half
#define FM_OUT_OFFSET (4 * FM_MAT_BYTES)      // the output matrix
#define FM_OUT_HALF_BYTES (FM_OUT * 64 * 2)
#define FM_IMAGE_BYTES (FM_OUT_OFFSET + FM_OUT * 128 * 2)   // 135,168
#define FM_ROW_BYTES (FM_IN * 4)
#define FM_STAGE_BYTES (FM_TILE * FM_ROW_BYTES)             // 28,672
#define FM_BARRIERS (2 * FM_CONSUMERS + 5)  // full[], empty[], 5 matrices
#define FM_SMEM (1024 + FM_IMAGE_BYTES + FM_CONSUMERS * FM_STAGE_BYTES + \
                 FM_BARRIERS * 8)

__device__ __forceinline__ uint32_t fm_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void fm_mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fm_mbar_expect_tx(uint32_t bar,
                                                  uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Orders this thread's generic-proxy accesses of shared memory before the
// async proxy's later ones (here: its reads of a stage before the bulk copy
// that refills it, which the mbarrier release alone does not order).
__device__ __forceinline__ void fm_fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void fm_mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void fm_mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` from global `src` to shared `dst`, completing on barrier `bar`.
__device__ __forceinline__ void fm_bulk_copy(uint32_t dst, const void* src,
                                             uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Named barriers 1 .. FM_CONSUMERS: a warpgroup's turn, granted by the
// warpgroup before it (256 threads: the two of them).
__device__ __forceinline__ void fm_bar_sync(uint32_t id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void fm_bar_arrive(uint32_t id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// Shared-memory descriptor of a K-major bf16 B operand in the 128-byte
// swizzle: rows of 128 bytes, 8-row atoms 1024 bytes apart (SBO), layout
// type 1 (SWIZZLE_128B) in bits 62-63, LBO unused (1).
__device__ __forceinline__ uint64_t fm_desc(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void fm_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void fm_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void fm_wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of an accumulator across a
// wgmma issue or wait.
__device__ __forceinline__ void fm_fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// d[64] (+)= A (64 x 16, register fragments a) x B (16 x 128, descriptor).
__device__ __forceinline__ void fm_wgmma128(float* d, const uint32_t* a,
                                            uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d[8] (+)= A (64 x 16) x B (16 x 16).
__device__ __forceinline__ void fm_wgmma16(float* d, const uint32_t* a,
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// Two neighbouring columns rounded to a bf16 pair, column 0 in the low half.
__device__ __forceinline__ uint32_t fm_pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// LeakyReLU 0.01 as the twin's where(v > 0, v, 0.01 v), in two
// instructions: for v < 0, 0.01 v > v.
__device__ __forceinline__ float fm_leaky(float v) {
  return fmaxf(v, 0.01f * v);
}

__global__ void __launch_bounds__(FM_THREADS, 1)
fused_mlp_kernel(const float* __restrict__ x, int n,
                 const uint8_t* __restrict__ image, float* __restrict__ out) {
  extern __shared__ uint8_t fm_raw[];
  // The swizzle pattern repeats every 1024 bytes of shared address.
  uint8_t* smem = fm_raw + ((1024 - (fm_smem(fm_raw) & 1023)) & 1023);
  const uint32_t s_image = fm_smem(smem);
  const float* stages =
      reinterpret_cast<const float*>(smem + FM_IMAGE_BYTES);
  const uint32_t s_stages = s_image + FM_IMAGE_BYTES;
  const uint32_t s_bar = s_stages + FM_CONSUMERS * FM_STAGE_BYTES;
  // full[s] at s_bar + 8 s, empty[s] after them, then one a matrix.
  const uint32_t s_empty = s_bar + 8 * FM_CONSUMERS;
  const uint32_t s_wbar = s_empty + 8 * FM_CONSUMERS;

  const int tiles = (n + FM_TILE - 1) / FM_TILE;
  const int my_tiles = tiles > (int)blockIdx.x
                           ? (tiles - 1 - (int)blockIdx.x) / gridDim.x + 1
                           : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < FM_CONSUMERS; ++s) {
      fm_mbar_init(s_bar + 8 * s, 1);
      fm_mbar_init(s_empty + 8 * s, 128);
    }
    for (int m = 0; m < 5; ++m) fm_mbar_init(s_wbar + 8 * m, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == FM_CONSUMERS) {
    // ---- producer: one lane issues every copy -------------------------
    if (threadIdx.x % 32 != 0) return;
    // One barrier a matrix: layer 0 starts once its 32 KB have landed.
    for (int m = 0; m < 5; ++m) {
      const uint32_t bytes = m < 4 ? FM_MAT_BYTES : FM_OUT * 128 * 2;
      fm_mbar_expect_tx(s_wbar + 8 * m, bytes);
      fm_bulk_copy(s_image + m * FM_MAT_BYTES, image + m * FM_MAT_BYTES,
                   bytes, s_wbar + 8 * m);
    }
    for (int i = 0; i < my_tiles; ++i) {
      const int s = i % FM_CONSUMERS;
      // Wait for the stage's previous use to be released (the first use
      // passes: parity 1 names the phase before the barrier's first).
      fm_mbar_wait(s_empty + 8 * s, ((i / FM_CONSUMERS) & 1) ^ 1);
      const long long row0 =
          ((long long)blockIdx.x + (long long)i * gridDim.x) * FM_TILE;
      const int rows = (int)min((long long)FM_TILE, n - row0);
      const uint32_t bytes = rows * FM_ROW_BYTES;
      fm_mbar_expect_tx(s_bar + 8 * s, bytes);
      fm_bulk_copy(s_stages + s * FM_STAGE_BYTES, x + row0 * FM_IN, bytes,
                   s_bar + 8 * s);
    }
    return;
  }

  // ---- consumers: warpgroup wg takes the block's tiles wg,
  // wg + FM_CONSUMERS, ... in stage wg ------------------------------------
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const uint32_t my_turn = 1 + wg;
  const uint32_t their_turn = 1 + (wg + 1) % FM_CONSUMERS;
  const float* stage = stages + wg * (FM_TILE * FM_IN);
  // Every warpgroup takes turns for ceil(my_tiles / FM_CONSUMERS) tiles;
  // one short of them, a warpgroup only passes its last turns on.
  const int rounds = (my_tiles + FM_CONSUMERS - 1) / FM_CONSUMERS;
  const int mine = (my_tiles - wg + FM_CONSUMERS - 1) / FM_CONSUMERS;
  if (wg == FM_CONSUMERS - 1) fm_bar_arrive(1);  // warpgroup 0 goes first

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;

  // No branch inside this loop splits the warpgroup around a wgmma (ptxas
  // then serializes them): the ragged tile's missing rows read its last
  // row, and only its stores are predicated.
  for (int j = 0; j < mine; ++j) {
    const long long row0 =
        ((long long)blockIdx.x + (long long)(FM_CONSUMERS * j + wg) *
                                     gridDim.x) *
        FM_TILE;
    const int rows = (int)min((long long)FM_TILE, n - row0);
    const int r_lo = warp * 16 + g, r_hi = r_lo + 8;
    uint32_t a[8][4];
    fm_mbar_wait(s_bar + 8 * wg, j & 1);
#pragma unroll
    for (int kk = 0; kk < FM_K0_STEPS; ++kk) {
      const int c = kk * 16 + 4 * t;
      float4 lo = *reinterpret_cast<const float4*>(
          stage + min(r_lo, rows - 1) * FM_IN + c);
      float4 hi = *reinterpret_cast<const float4*>(
          stage + min(r_hi, rows - 1) * FM_IN + c);
      a[kk][0] = fm_pack(lo.x, lo.y);
      a[kk][1] = fm_pack(hi.x, hi.y);
      a[kk][2] = fm_pack(lo.z, lo.w);
      a[kk][3] = fm_pack(hi.z, hi.w);
    }
    fm_fence_proxy_async();
    fm_mbar_arrive(s_empty + 8 * wg);  // the stage is free again

#pragma unroll
    for (int layer = 0; layer < 4; ++layer) {
      fm_bar_sync(my_turn);
      fm_mbar_wait(s_wbar + 8 * layer, 0);  // at once after the first tile
      fm_wgmma_fence();
      const uint32_t w = s_image + layer * FM_MAT_BYTES;
#pragma unroll
      for (int kk = 0; kk < (layer == 0 ? FM_K0_STEPS : 8); ++kk)
        fm_wgmma128(d, a[kk],
                    fm_desc(w + (kk / 4) * FM_HALF_BYTES + (kk % 4) * 32),
                    kk > 0);
      fm_wgmma_commit();
      fm_bar_arrive(their_turn);
      fm_wgmma_wait();
#pragma unroll
      for (int i = 0; i < 64; ++i) fm_fence_operand(d[i]);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        a[kk][0] = fm_pack(fm_leaky(d[8 * kk]), fm_leaky(d[8 * kk + 1]));
        a[kk][1] = fm_pack(fm_leaky(d[8 * kk + 2]), fm_leaky(d[8 * kk + 3]));
        a[kk][2] = fm_pack(fm_leaky(d[8 * kk + 4]), fm_leaky(d[8 * kk + 5]));
        a[kk][3] = fm_pack(fm_leaky(d[8 * kk + 6]), fm_leaky(d[8 * kk + 7]));
      }
    }

    // Output layer: 16 outputs, linear, stored channel-major.
    float o[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) o[q] = 0.0f;
    fm_bar_sync(my_turn);
    fm_mbar_wait(s_wbar + 8 * 4, 0);
    fm_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      fm_wgmma16(o, a[kk],
                 fm_desc(s_image + FM_OUT_OFFSET +
                         (kk / 4) * FM_OUT_HALF_BYTES + (kk % 4) * 32),
                 kk > 0);
    fm_wgmma_commit();
    fm_bar_arrive(their_turn);
    fm_wgmma_wait();
#pragma unroll
    for (int q = 0; q < 8; ++q) fm_fence_operand(o[q]);
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      const long long c = nb * 8 + 2 * t;
      if (r_lo < rows) {
        out[c * n + row0 + r_lo] = o[4 * nb];
        out[(c + 1) * n + row0 + r_lo] = o[4 * nb + 1];
      }
      if (r_hi < rows) {
        out[c * n + row0 + r_hi] = o[4 * nb + 2];
        out[(c + 1) * n + row0 + r_hi] = o[4 * nb + 3];
      }
    }
  }
  if (mine < rounds) {  // the turns of a missing last tile
    for (int round = 0; round < 5; ++round) {
      fm_bar_sync(my_turn);
      fm_bar_arrive(their_turn);
    }
  }
  // The last warpgroup's last arrival on barrier 1 has no turn after it.
  if (wg == 0) fm_bar_sync(1);
}

extern "C" int fused_mlp(const float* x, int n, const void* image,
                         float* out, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        FM_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = (n + FM_TILE - 1) / FM_TILE;
  const int grid = tiles < sms ? tiles : sms;
  if (grid > 0) {
    fused_mlp_kernel<<<grid, FM_THREADS, FM_SMEM, stream>>>(
        x, n, static_cast<const uint8_t*>(image), out);
  }
  return static_cast<int>(cudaGetLastError());
}

NR_ERROR_STRING_ENTRY
