// Backward of the fused lane-grid network in training layout (replaces the
// TPU kernel neural_renderer_tpu/ops/lane_grid_train_kernel.py::_bwd_kernel).
//
// Inputs: x [12, n] f32, the output cotangent g [16, n] f32, the f32 master
// tables as [P*L*F*rows, 128] rows (entry = row * 128 + lane; training
// layout, no bf16 packing) and the bf16 weights. Outputs, summed over the n
// rays: table gradients [P*L*F*rows, 128] f32 and MLP weight gradients
// dW0..dW3 [128, 128] and dWout [16, 128] f32 (with respect to the bf16
// weights). The input cotangent is not computed: inputs are data.
//
// Rounding points (the PyTorch twin, ops/lane_grid_train_kernel.py::
// backward_twin, rounds at the same places): the forward is recomputed with
// bf16 activations and the LeakyReLU masks of its f32 pre-activations; g is
// rounded to bf16; each layer's delta is masked, then rounded to bf16; dW
// sums products of bf16 operands in f32; d_enc stays f32; each table
// contribution is bf16(d_enc * corner weight), added in f32.
//
// The TPU kernel carries every gradient accumulator (1.5 MiB of tables,
// 67,584 MLP entries) in VMEM across a sequential grid. Blocks of a GPU run
// in parallel and in no order and have at most 227 KB of shared memory, so
// the sums are split into two passes:
//   1. lane_grid_backward_rays: one thread per ray, persistent blocks of 256
//      threads with the bf16 weights in shared memory (as in
//      lane_grid_forward.cu). Recomputes the ray's forward, keeps the masks
//      in registers, backpropagates the delta through the layers, and writes
//      the bf16 activations h0..h4 and the bf16 deltas db0..db3 and g to
//      scratch ([rows, stride] bf16, rays contiguous). The last product
//      W0^T db0 gives d_enc, whose table contributions go to the f32 table
//      gradient by atomicAdd (768 per ray at 3 points x 8 levels x 4
//      features x 8 corners; the 1.5 MiB gradient stays in L2).
//   2. lane_grid_backward_dw: dW[l] = sum over rays of db_l (x) h_l as a
//      split-K reduction over the ray axis: each block owns a 64 x 64 tile
//      of one layer's dW and a range of rays, stages 32-ray slices of both
//      operands in shared memory as f32, accumulates 4 x 4 outputs per
//      thread in FP32 FMAs, and adds its tile to dW by atomicAdd.
// f32 atomics reorder the sums from run to run.
//
// Bound: operations. Per ray 3 x 67,584 multiply-adds (forward recompute,
// the delta chain, the dW products), which this version runs on the FP32
// pipes; the bound is taken against the bf16 tensor-core peak. On top come
// 768 table reads and 768 scattered f32 atomic adds per ray.
#include <stdint.h>

#include "lane_grid.cuh"
#include "mt.cuh"

#define LB_THREADS 256
#define LB_SMEM_W (4 * LG_WIDTH * LG_WIDTH * 2)
#define LB_SMEM_WOUT (LG_WIDTH * LG_OUT * 2)
#define LB_SMEM_H (LG_WIDTH * LB_THREADS * 2)
#define LB_SMEM (LB_SMEM_W + LB_SMEM_WOUT + LB_SMEM_H)
// Scratch rows: activations h0..h4, deltas db0..db3 then the bf16 g.
#define LB_H_ROWS (5 * LG_WIDTH)
#define LB_D_ROWS (4 * LG_WIDTH + LG_OUT)
#define LB_SLICE 32   // rays per shared-memory slice of the reduction
#define LB_TILE 64    // dW tile edge of the reduction

__device__ __forceinline__ float bf16_round(float v) {
  return bf16_bits_to_f32(f32_to_bf16_bits(v));
}

// acc[0..7] += w[0..7] * hv (eight bf16 weights of a 16-byte word).
__device__ __forceinline__ void fma8(float* acc, uint4 w, float hv) {
  const uint32_t v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    acc[2 * e] = __fmaf_rn(bf16_lo(v[e]), hv, acc[2 * e]);
    acc[2 * e + 1] = __fmaf_rn(bf16_hi(v[e]), hv, acc[2 * e + 1]);
  }
}

// acc + sum_e w[e] * d[e] over eight bf16 weights and eight bf16 values
// (four packed words), in element order.
__device__ __forceinline__ float dot8(float acc, uint4 w, const uint32_t* d) {
  const uint32_t v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    acc = __fmaf_rn(bf16_lo(v[e]), bf16_lo(d[e]), acc);
    acc = __fmaf_rn(bf16_hi(v[e]), bf16_hi(d[e]), acc);
  }
  return acc;
}

// sum_o W[o][i] * d[o] for one input i: row i of the [in][out] weight
// against the 128 packed bf16 values d.
__device__ __forceinline__ float dot_row(const uint16_t* wt_row,
                                         const uint32_t* d) {
  const uint4* w = reinterpret_cast<const uint4*>(wt_row);
  float acc = 0.0f;
#pragma unroll
  for (int q = 0; q < LG_WIDTH / 8; ++q) acc = dot8(acc, w[q], d + 4 * q);
  return acc;
}

__device__ __forceinline__ void load_column(uint32_t* hc, const uint16_t* sh,
                                            int tid) {
#pragma unroll
  for (int i2 = 0; i2 < LG_WIDTH / 2; ++i2)
    hc[i2] = (uint32_t)sh[(2 * i2) * LB_THREADS + tid] |
             ((uint32_t)sh[(2 * i2 + 1) * LB_THREADS + tid] << 16);
}

__global__ void __launch_bounds__(LB_THREADS, 1)
lane_grid_backward_rays(const float* __restrict__ x,
                        const float* __restrict__ g, int n, int stride,
                        const float* __restrict__ tables,
                        const uint16_t* __restrict__ w_hidden,
                        const uint16_t* __restrict__ w_out,
                        const float* __restrict__ scales, int n_points,
                        int n_levels, int rows, int encoded_dims,
                        uint16_t* __restrict__ hs, uint16_t* __restrict__ ds,
                        float* __restrict__ d_tables) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* sw = reinterpret_cast<uint16_t*>(smem);
  uint16_t* swo = reinterpret_cast<uint16_t*>(smem + LB_SMEM_W);
  uint16_t* sh = reinterpret_cast<uint16_t*>(smem + LB_SMEM_W + LB_SMEM_WOUT);

  {  // weights -> shared memory, 16 bytes per thread per step
    const uint4* src = reinterpret_cast<const uint4*>(w_hidden);
    uint4* dst = reinterpret_cast<uint4*>(sw);
    for (int i = threadIdx.x; i < LB_SMEM_W / 16; i += blockDim.x)
      dst[i] = src[i];
    const uint4* src2 = reinterpret_cast<const uint4*>(w_out);
    uint4* dst2 = reinterpret_cast<uint4*>(swo);
    for (int i = threadIdx.x; i < LB_SMEM_WOUT / 16; i += blockDim.x)
      dst2[i] = src2[i];
  }
  __syncthreads();

  const int tid = threadIdx.x;
  const uint32_t n_entries = (uint32_t)(rows * LG_GROUP);
  const long long ls = stride;

  for (long long base = (long long)blockIdx.x * LB_THREADS; base < stride;
       base += (long long)gridDim.x * LB_THREADS) {
    const long long r = base + tid;
    if (r >= stride) continue;
    if (r >= n) {  // padding rays of the scratch: zero columns
      for (int j = 0; j < LB_H_ROWS; ++j) hs[j * ls + r] = 0;
      for (int j = 0; j < LB_D_ROWS; ++j) ds[j * ls + r] = 0;
      continue;
    }

    // ---- forward recompute: encode -> h0 ----
    int k = 0;
    for (int p = 0; p < n_points; ++p) {
      const float px = x[(3 * p) * (long long)n + r];
      const float py = x[(3 * p + 1) * (long long)n + r];
      const float pz = x[(3 * p + 2) * (long long)n + r];
      for (int level = 0; level < n_levels; ++level) {
        uint32_t idx[8];
        float wc[8];
        lg_corners(px, py, pz, scales[level], n_entries, idx, wc);
        const long long base_row =
            (long long)((p * n_levels + level) * 4) * rows;
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const uint32_t sub = idx[c] >> 7;
          const uint32_t lane = idx[c] & (LG_GROUP - 1);
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const long long row = base_row + (long long)f * rows + sub;
            acc[f] = acc[f] + __ldg(tables + row * LG_GROUP + lane) * wc[c];
          }
        }
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const uint16_t b = f32_to_bf16_bits(acc[f]);
          sh[(k + f) * LB_THREADS + tid] = b;
          hs[(k + f) * ls + r] = b;
        }
        k += 4;
      }
    }
    {
      const long long d0 = (3 * n_points) * (long long)n + r;
      float shv[16];
      lg_sh16(x[d0], x[d0 + n], x[d0 + 2LL * n], shv);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const uint16_t b = f32_to_bf16_bits(shv[j]);
        sh[(k + j) * LB_THREADS + tid] = b;
        hs[(k + j) * ls + r] = b;
      }
      for (int j = encoded_dims; j < LG_WIDTH; ++j) {
        sh[j * LB_THREADS + tid] = 0;
        hs[j * ls + r] = 0;
      }
    }

    // ---- forward recompute: hidden layers -> h1..h4 and the masks ----
    uint32_t mask[16];  // bit q of word 4 * layer + chunk: a > 0
    uint32_t hc[LG_WIDTH / 2];
    for (int layer = 0; layer < 4; ++layer) {
      load_column(hc, sh, tid);
      const uint16_t* wl = sw + layer * LG_WIDTH * LG_WIDTH;
      for (int chunk = 0; chunk < LG_WIDTH / 32; ++chunk) {
        float acc[32];
#pragma unroll
        for (int q = 0; q < 32; ++q) acc[q] = 0.0f;
#pragma unroll
        for (int i = 0; i < LG_WIDTH; ++i) {
          const float hv = (i & 1) ? bf16_hi(hc[i >> 1]) : bf16_lo(hc[i >> 1]);
          const uint4* wrow =
              reinterpret_cast<const uint4*>(wl + i * LG_WIDTH + chunk * 32);
#pragma unroll
          for (int q = 0; q < 4; ++q) fma8(acc + 8 * q, wrow[q], hv);
        }
        uint32_t bits = 0;
#pragma unroll
        for (int q = 0; q < 32; ++q) {
          const float a = acc[q];
          if (a > 0.0f) bits |= 1u << q;
          const uint16_t b = f32_to_bf16_bits(a > 0.0f ? a : 0.01f * a);
          const int o = chunk * 32 + q;
          sh[o * LB_THREADS + tid] = b;
          hs[((layer + 1) * LG_WIDTH + o) * ls + r] = b;
        }
        mask[4 * layer + chunk] = bits;
      }
    }

    // ---- backward: g -> db3 through the output layer ----
    uint32_t gp[LG_OUT / 2];  // bf16(g), packed in pairs
#pragma unroll
    for (int o2 = 0; o2 < LG_OUT / 2; ++o2) {
      const uint16_t lo = f32_to_bf16_bits(g[(2 * o2) * (long long)n + r]);
      const uint16_t hi = f32_to_bf16_bits(g[(2 * o2 + 1) * (long long)n + r]);
      gp[o2] = (uint32_t)lo | ((uint32_t)hi << 16);
      ds[(4 * LG_WIDTH + 2 * o2) * ls + r] = lo;
      ds[(4 * LG_WIDTH + 2 * o2 + 1) * ls + r] = hi;
    }
    for (int i = 0; i < LG_WIDTH; ++i) {
      const uint4* w = reinterpret_cast<const uint4*>(swo + i * LG_OUT);
      float acc = dot8(0.0f, w[0], gp);
      acc = dot8(acc, w[1], gp + 4);
      const bool m = (mask[12 + (i >> 5)] >> (i & 31)) & 1u;
      const uint16_t b = f32_to_bf16_bits(m ? acc : 0.01f * acc);
      sh[i * LB_THREADS + tid] = b;
      ds[(3 * LG_WIDTH + i) * ls + r] = b;
    }

    // ---- backward: db_l -> db_{l-1} through hidden layer l ----
    for (int layer = 3; layer >= 1; --layer) {
      load_column(hc, sh, tid);
      const uint16_t* wl = sw + layer * LG_WIDTH * LG_WIDTH;
      for (int i = 0; i < LG_WIDTH; ++i) {
        const float acc = dot_row(wl + i * LG_WIDTH, hc);
        const bool m =
            (mask[4 * (layer - 1) + (i >> 5)] >> (i & 31)) & 1u;
        const uint16_t b = f32_to_bf16_bits(m ? acc : 0.01f * acc);
        sh[i * LB_THREADS + tid] = b;
        ds[((layer - 1) * LG_WIDTH + i) * ls + r] = b;
      }
    }

    // ---- d_enc = W0^T db0 (f32) -> table gradients ----
    load_column(hc, sh, tid);
    k = 0;
    for (int p = 0; p < n_points; ++p) {
      const float px = x[(3 * p) * (long long)n + r];
      const float py = x[(3 * p + 1) * (long long)n + r];
      const float pz = x[(3 * p + 2) * (long long)n + r];
      for (int level = 0; level < n_levels; ++level) {
        uint32_t idx[8];
        float wc[8];
        lg_corners(px, py, pz, scales[level], n_entries, idx, wc);
        const long long base_row =
            (long long)((p * n_levels + level) * 4) * rows;
        for (int f = 0; f < 4; ++f) {
          const float dfeat = dot_row(sw + (k + f) * LG_WIDTH, hc);
          float* dt = d_tables + (base_row + (long long)f * rows) * LG_GROUP;
#pragma unroll
          for (int c = 0; c < 8; ++c)
            atomicAdd(dt + (idx[c] >> 7) * LG_GROUP + (idx[c] & (LG_GROUP - 1)),
                      bf16_round(dfeat * wc[c]));
        }
        k += 4;
      }
    }
  }
}

// Tiles of the reduction: layers 0..3 are 128 x 128 (2 x 2 tiles of 64),
// the output layer 16 x 128 (1 x 2 tiles, 16 of 64 rows live).
#define LB_TILES (4 * 4 + 2)

__global__ void __launch_bounds__(LB_THREADS)
lane_grid_backward_dw(const uint16_t* __restrict__ hs,
                      const uint16_t* __restrict__ ds, int stride,
                      int slices_per_block, float* __restrict__ d_w) {
  __shared__ __align__(16) float sd[LB_SLICE][LB_TILE];
  __shared__ __align__(16) float shh[LB_SLICE][LB_TILE];
  const int tile = blockIdx.x;
  const int layer = tile < 16 ? tile / 4 : 4;
  const int o_tile = tile < 16 ? (tile % 4) / 2 : 0;
  const int i_tile = tile < 16 ? tile % 2 : tile - 16;
  const int o_rows = layer < 4 ? LB_TILE : LG_OUT;  // live rows of the tile
  const uint16_t* dsrc =
      ds + (long long)(layer * LG_WIDTH + o_tile * LB_TILE) * stride;
  const uint16_t* hsrc =
      hs + (long long)(layer * LG_WIDTH + i_tile * LB_TILE) * stride;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  // Loader: thread -> (tile row, 8-ray part of the slice).
  const int lrow = tid / 4, lpart = tid % 4;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;

  const long long slices = stride / LB_SLICE;
  const long long s0 = (long long)blockIdx.y * slices_per_block;
  const long long s1 = min(slices, s0 + slices_per_block);
  for (long long s = s0; s < s1; ++s) {
    const long long r0 = s * LB_SLICE + lpart * 8;
    const uint4 hv =
        *reinterpret_cast<const uint4*>(hsrc + (long long)lrow * stride + r0);
    uint4 dv = make_uint4(0u, 0u, 0u, 0u);
    if (lrow < o_rows)
      dv = *reinterpret_cast<const uint4*>(dsrc + (long long)lrow * stride +
                                           r0);
    __syncthreads();
    const uint32_t hw[4] = {hv.x, hv.y, hv.z, hv.w};
    const uint32_t dw[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      shh[lpart * 8 + 2 * e][lrow] = bf16_lo(hw[e]);
      shh[lpart * 8 + 2 * e + 1][lrow] = bf16_hi(hw[e]);
      sd[lpart * 8 + 2 * e][lrow] = bf16_lo(dw[e]);
      sd[lpart * 8 + 2 * e + 1][lrow] = bf16_hi(dw[e]);
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < LB_SLICE; ++rr) {
      const float4 a = *reinterpret_cast<const float4*>(&sd[rr][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&shh[rr][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          acc[u][v] = __fmaf_rn(av[u], bv[v], acc[u][v]);
    }
  }
  if (s0 >= s1) return;
  float* out = d_w + (long long)layer * LG_WIDTH * LG_WIDTH;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int o = ty * 4 + u;
    if (o >= o_rows) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v)
      atomicAdd(out + (o_tile * LB_TILE + o) * LG_WIDTH + i_tile * LB_TILE +
                    tx * 4 + v,
                acc[u][v]);
  }
}

// x [12, n] and g [16, n] f32, contiguous; stride = n rounded up to
// LB_SLICE; hs [LB_H_ROWS, stride] and ds [LB_D_ROWS, stride] bf16 scratch;
// d_tables and d_w (4 x 128 x 128 + 16 x 128 f32) zeroed by the caller.
extern "C" int lane_grid_backward(const float* x, const float* g, int n,
                                  int stride, const float* tables,
                                  const uint16_t* w_hidden,
                                  const uint16_t* w_out, const float* scales,
                                  int n_points, int n_levels, int rows,
                                  int encoded_dims, uint16_t* hs,
                                  uint16_t* ds, float* d_tables, float* d_w,
                                  cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        lane_grid_backward_rays, cudaFuncAttributeMaxDynamicSharedMemorySize,
        LB_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  if (stride % LB_SLICE != 0 || stride < n) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int blocks_needed = (stride + LB_THREADS - 1) / LB_THREADS;
  const int grid = blocks_needed < sms ? blocks_needed : sms;
  if (grid == 0) return 0;
  lane_grid_backward_rays<<<grid, LB_THREADS, LB_SMEM, stream>>>(
      x, g, n, stride, tables, w_hidden, w_out, scales, n_points, n_levels,
      rows, encoded_dims, hs, ds, d_tables);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // Split the ray axis so that about four reduction blocks run per SM.
  const int slices = stride / LB_SLICE;
  int splits = (4 * sms + LB_TILES - 1) / LB_TILES;
  if (splits > slices) splits = slices;
  const int per_block = (slices + splits - 1) / splits;
  splits = (slices + per_block - 1) / per_block;
  lane_grid_backward_dw<<<dim3(LB_TILES, splits), LB_THREADS, 0, stream>>>(
      hs, ds, stride, per_block, d_w);
  return static_cast<int>(cudaGetLastError());
}

NR_ERROR_STRING_ENTRY
