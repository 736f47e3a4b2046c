// The matrix formulation of the dense closest hit with bf16 products: the
// trace-kernel ablation's mxu_hi3 and mxu_lo (replaces the TPU kernel
// neural_renderer_tpu/ops/trace_mxu.py::_mxu_kernel as
// scripts/ablate_trace_kernel.py :361-395 runs it, with pair_eval_raw's dots
// at Precision.HIGH or DEFAULT).
//
// On the TPU, DEFAULT is one bf16 pass and HIGH is bf16_3x: the operands
// are split into bf16 halves, hi = bf16(x) and lo = bf16(x - hi), and the
// dot sums hi·hi + hi·lo + lo·hi. This kernel takes those products from the
// same bf16 operands on mma.sync.aligned.m16n8k16 (bf16 in, f32
// accumulate): RAY_K = 16 feature rows are exactly one k-step. A TF32 split
// (3xTF32, 1xTF32) would keep 10 mantissa bits to bf16's 7 and so compute a
// different, more precise function than the TPU did; bf16 keeps its
// operands. Each product of bf16 values is exact; the tensor core's f32
// sums differ from the twin's (float64, rounded once) by a few f32 ulps of
// the largest term.
//
// K8's design (csrc/mt_mxu.cuh, "the dense kernels"), in three launches:
// - Features once per call: bm_features builds every triangle's four
//   feature columns (trace_mxu.tri_features' rows, f32 op by op), splits
//   them into bf16 parts and writes them to a scratch in B-fragment order,
//   BM_FRAG words of 8 bytes per 8-triangle n-tile (2 KB; 2.4 MB for 9,216
//   triangles, L2-resident). No CTA builds a feature.
// - The walk: CTAs of BM_WARPS warps, each warp four 16-ray m-tiles with
//   their A fragments (hi, and lo for three passes) in registers, over a
//   slice of the triangles, whose chunks of BM_CHUNK n-tiles are staged by
//   16-byte cp.async into a double buffer. Per n-tile a warp loads its B
//   fragments once and runs, per m-tile, the products of det, u·det and
//   v·det: 3 (one pass) or 9 (three) mma.sync; then a branch-free FP32
//   prefilter on those f32 accumulators, and only where some lane's pair
//   may hit, t·det's products and, per pair slot (rows g or g + 8, even or
//   odd columns) where some lane's pair may hit, the epilogue. Each lane
//   keeps the best (t, id) of its two rows per m-tile (a strict < suffices:
//   it visits its ids in increasing order); the quad reduces them at the
//   end by (t, smallest id).
// - With more than one slice, nr_dense_fold merges the slices' rows per ray
//   (csrc/dense_slices.cuh; the slice count from nr_dense_slices, so that
//   the launch reaches BM_CTAS_PER_SM CTAs per SM).
// Each accumulator takes its products in one mma.sync sequence (the small
// terms first: lo·hi, hi·lo, then hi·hi) whatever the launch shape, so a
// pair's f32 sums, and the outputs, do not depend on it.
// ANY mode, no skip mask: the reference ablation calls K8 with neither.
//
// Prefilter. pair_eval_raw's epilogue (csrc/mt_mxu.cuh::nr_mxu_epilogue)
// takes u = rn(u·det rn(1/det)) and v likewise from f32 det, u·det and
// v·det, exactly as csrc/mt.cuh::nr_mt_t does, so the argument of the FP32
// dense kernels' rule (csrc/mt_dense.cuh) carries over; this kernel tests
// the same interval centred, in fewer instructions. With a = |det|, num =
// u·det or v·det, x = rn(2 num - det) (one fused multiply-add) and h =
// rn(a (1 + 2^-19)), the pair is rejected where |x| >= h for either num
// (or where x is NaN). Then |2 num - det| >= h / (1 + 2^-24) >= a (1 +
// 2^-19)(1 - 2^-23) > a (1 + 2^-20) (a >= 1e-8: smaller |det| is culled
// anyway, and the values are normal), and 2 num - det = sgn(det) (2 w -
// a) with w = num sgn(det), so w <= -2^-21 a or w >= (1 + 2^-21) a. As
// mt_dense.cuh argues (rn(1/det) within 2^-22 of 1/det), the first
// gives a quotient below -2^-22, u < 0; the second one at least (1 +
// 2^-21)(1 - 2^-22)(1 - 2^-24) > 1 + 2^-24, which rounds above 1 (and v >
// 1 with u >= 0 gives u + v > 1). NaN in det, u·det or v·det fails the
// epilogue's compares; det = inf gives t = 0. The rule costs a multiply,
// two fused multiply-adds and two compares a pair; mt_dense.cuh's own
// (two multiplies, two sign flips, four compares) made the kernel 1.2-1.5x
// as long (scripts/sweep_ablate_mxu_bf16.py, PERF.md).
// ops/trace_ablation.py::mxu_bf16_rule is the rule on the CPU, held against
// this kernel's twin by tests/test_torch_ablate_prefilter.py.
//
// Four m-tiles a warp, 48 CTAs a SM and 8-n-tile chunks were the fastest
// of the shapes that sweep measures (one, two or four m-tiles; 8, 16 or 48
// CTAs a SM; 4 or 8 n-tiles); two, four or eight warps a CTA within a few
// percent of each other at four m-tiles.
//
// Fragment layout (PTX ISA, mma.m16n8k16 .bf16, g = lane/4, c = lane%4):
// A regs {A[g][2c..], A[g+8][2c..], A[g][2c+8..], A[g+8][2c+8..]}, two bf16
// each (the lower k in the low half); B regs {B[2c..][g], B[2c+8..][g]};
// C {C[g][2c], C[g][2c+1], C[g+8][2c], C[g+8][2c+1]}.
//
// Bound (ops/bounds.py): the larger of the bf16 tensor products (the
// function's 19 multiply-adds per pair and pass at 989 TFLOP/s) and the FP32
// operations: the prefilter's 3 per pair and the epilogue's 5 on the pairs
// of the slots it leaves (the f32 accumulators need no conversion). As issued, a pass is 4 x 16 x 2 = 128 flops a pair, of
// which t·det's 32 only where some pair of the tile may hit.
#include <cuda_bf16.h>
#include <stdint.h>

#include "mt_mxu.cuh"

#define BM_WARPS 4                  // warps per CTA
#define BM_THREADS (32 * BM_WARPS)
#define BM_MT 4                     // 16-ray m-tiles per warp
#define BM_RAYS (16 * BM_MT * BM_WARPS)
#define BM_Q 4                      // quantities: det, u·det, v·det, t·det
#define BM_FRAG (2 * BM_Q * 32)     // 8-byte words an n-tile: [part][q][lane]
#define BM_CHUNK 8                  // n-tiles per staged chunk
#define BM_CHUNK_TRIS (8 * BM_CHUNK)
#define BM_CTAS_PER_SM 48           // CTAs per SM a launch reaches, at least

__device__ __forceinline__ uint32_t bm_pack(float lo_k, float hi_k) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo_k, hi_k);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The bf16 parts of a pair of features: part 0 hi, part 1 lo = bf16(x - hi).
__device__ __forceinline__ uint32_t bm_part(float a, float b, int part) {
  if (part == 0) return bm_pack(a, b);
  const float ra = a - __bfloat162float(__float2bfloat16_rn(a));
  const float rb = b - __bfloat162float(__float2bfloat16_rn(b));
  return bm_pack(ra, rb);
}

__device__ __forceinline__ void bm_mma(float c[4], const uint32_t a[4],
                                       uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// Every triangle's four feature columns, thread q the triangle q of [9,
// ttot], in trace_mxu.tri_features' row order, f32 op by op, split into
// both bf16 parts and written where the lanes of its n-tile read them.
__global__ void __launch_bounds__(BM_THREADS)
bm_features(const float* __restrict__ tris, int ttot,
            uint2* __restrict__ feat) {
  const int q = blockIdx.x * BM_THREADS + threadIdx.x;
  if (q >= ttot) return;
  float v[9];
#pragma unroll
  for (int r = 0; r < 9; ++r) v[r] = tris[(long long)r * ttot + q];
  const float v0x = v[0], v0y = v[1], v0z = v[2];
  const float e1x = v[3], e1y = v[4], e1z = v[5];
  const float e2x = v[6], e2y = v[7], e2z = v[8];
  const float a0 = e2y * e1z - e2z * e1y, a1 = e2z * e1x - e2x * e1z,
              a2 = e2x * e1y - e2y * e1x;              // e2 x e1
  const float b0 = e2y * v0z - e2z * v0y, b1 = e2z * v0x - e2x * v0z,
              b2 = e2x * v0y - e2y * v0x;              // e2 x v0
  const float c0 = v0y * e1z - v0z * e1y, c1 = v0z * e1x - v0x * e1z,
              c2 = v0x * e1y - v0y * e1x;              // v0 x e1
  const float d0 = e1y * e2z - e1z * e2y, d1 = e1z * e2x - e1x * e2z,
              d2 = e1x * e2y - e1y * e2x;              // e1 x e2
  const float s = (e2x * c0 + e2y * c1) + e2z * c2;
  // Rows 0-2 pair with d, 3-5 with o, 6-8 with o x d, 9 with 1.
  const float f[BM_Q][16] = {
      {a0, a1, a2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
      {-b0, -b1, -b2, 0, 0, 0, e2x, e2y, e2z, 0, 0, 0, 0, 0, 0, 0},
      {-c0, -c1, -c2, 0, 0, 0, -e1x, -e1y, -e1z, 0, 0, 0, 0, 0, 0, 0},
      {0, 0, 0, d0, d1, d2, 0, 0, 0, -s, 0, 0, 0, 0, 0, 0}};
  uint2* dst = feat + (long long)(q >> 3) * BM_FRAG + (q & 7) * 4;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
#pragma unroll
    for (int qq = 0; qq < BM_Q; ++qq) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        uint2 w;
        w.x = bm_part(f[qq][2 * c], f[qq][2 * c + 1], p);
        w.y = bm_part(f[qq][2 * c + 8], f[qq][2 * c + 9], p);
        dst[(p * BM_Q + qq) * 32 + c] = w;
      }
    }
  }
}

// Ray feature k of trace_mxu.ray_features: [d | o | o x d | 1 | 0 ...].
__device__ __forceinline__ float bm_ray_feat(const float f[10], int k) {
  float v = 0.0f;
#pragma unroll
  for (int i = 0; i < 10; ++i)
    if (k == i) v = f[i];
  return v;
}

#define BM_RULE_H 1.0000019073486328125f  // 1 + 2^-19

// The prefilter: false only for a pair that the epilogue certainly
// rejects (the centred rule above). Bitwise operators: no branch.
__device__ __forceinline__ bool bm_maybe(float det, float u_num,
                                         float v_num) {
  const float h = fabsf(det) * BM_RULE_H;
  const float xu = __fmaf_rn(2.0f, u_num, -det);
  const float xv = __fmaf_rn(2.0f, v_num, -det);
  return (fabsf(xu) < h) & (fabsf(xv) < h);
}

// Start the copies of chunk c's n-tiles (their first PARTS parts) into dst.
template <int PARTS>
__device__ __forceinline__ void bm_stage(uint2* dst,
                                         const uint2* __restrict__ feat,
                                         int c) {
  constexpr int kUnits = PARTS * BM_Q * 16;  // 16-byte units an n-tile
  const uint2* src = feat + (long long)c * BM_CHUNK * BM_FRAG;
  for (int e = threadIdx.x; e < BM_CHUNK * kUnits; e += BM_THREADS) {
    const int j = e / kUnits, k = e - j * kUnits;
    nr_cp_async16(dst + j * 2 * kUnits + 2 * k, src + j * BM_FRAG + 2 * k);
  }
}

template <int PASSES>
__global__ void __launch_bounds__(BM_THREADS)
ablate_mxu_bf16_kernel(const float* __restrict__ o,
                       const float* __restrict__ d, int npad,
                       const uint2* __restrict__ feat, int nchunks,
                       int slices, float* __restrict__ out) {
  constexpr int PARTS = PASSES == 1 ? 1 : 2;
  constexpr int kTile = PARTS * BM_Q * 32;   // words of a staged n-tile
  constexpr int kBuf = BM_CHUNK * kTile;
  __shared__ __align__(16) uint2 buf[2 * kBuf];
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const long long ray0 = (long long)blockIdx.x * BM_RAYS +
                         (threadIdx.x >> 5) * 16 * BM_MT;
  const int s = blockIdx.y;
  // A fragments per m-tile and part: rows g and g + 8 of the m-tile.
  uint32_t a[BM_MT][PARTS][4];
#pragma unroll
  for (int m = 0; m < BM_MT; ++m) {
    float f[2][10];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = ray0 + m * 16 + g + 8 * h;
      const float ox = o[r], oy = o[npad + r], oz = o[2LL * npad + r];
      const float dx = d[r], dy = d[npad + r], dz = d[2LL * npad + r];
      const float row[10] = {dx, dy, dz, ox, oy, oz,
                             oy * dz - oz * dy, oz * dx - ox * dz,
                             ox * dy - oy * dx, 1.0f};
#pragma unroll
      for (int i = 0; i < 10; ++i) f[h][i] = row[i];
    }
#pragma unroll
    for (int p = 0; p < PARTS; ++p) {
      a[m][p][0] = bm_part(bm_ray_feat(f[0], 2 * c),
                           bm_ray_feat(f[0], 2 * c + 1), p);
      a[m][p][1] = bm_part(bm_ray_feat(f[1], 2 * c),
                           bm_ray_feat(f[1], 2 * c + 1), p);
      a[m][p][2] = bm_part(bm_ray_feat(f[0], 2 * c + 8),
                           bm_ray_feat(f[0], 2 * c + 9), p);
      a[m][p][3] = bm_part(bm_ray_feat(f[1], 2 * c + 8),
                           bm_ray_feat(f[1], 2 * c + 9), p);
    }
  }
  float best_t[BM_MT][2];
  int best_tri[BM_MT][2];
#pragma unroll
  for (int m = 0; m < BM_MT; ++m) {
    best_t[m][0] = best_t[m][1] = NR_MISS;
    best_tri[m][0] = best_tri[m][1] = 0;
  }
  const int c0 = nr_slice_chunk(s, nchunks, slices);
  const int c1 = nr_slice_chunk(s + 1, nchunks, slices);
  if (c0 < c1) {
    bm_stage<PARTS>(buf, feat, c0);
    nr_cp_async_commit();
  }
  for (int ch = c0; ch < c1; ++ch) {
    if (ch + 1 < c1) {
      // The other half was last read before the previous chunk's barrier.
      bm_stage<PARTS>(buf + ((ch + 1 - c0) & 1) * kBuf, feat, ch + 1);
      nr_cp_async_commit();
      nr_cp_async_wait<1>();
    } else {
      nr_cp_async_wait<0>();
    }
    __syncthreads();  // chunk ch has landed for every thread
    const uint2* tile = buf + ((ch - c0) & 1) * kBuf;
    for (int j = 0; j < BM_CHUNK; ++j) {
      uint2 b[BM_Q][PARTS];
#pragma unroll
      for (int p = 0; p < PARTS; ++p) {
#pragma unroll
        for (int qq = 0; qq < BM_Q; ++qq)
          b[qq][p] = tile[j * kTile + (p * BM_Q + qq) * 32 + lane];
      }
      const int col = (ch * BM_CHUNK + j) * 8 + 2 * c;
#pragma unroll
      for (int m = 0; m < BM_MT; ++m) {
        float acc[BM_Q][4];
        bool maybe[4];
        bool any = false;
#pragma unroll
        for (int qq = 0; qq < BM_Q - 1; ++qq) {
          acc[qq][0] = acc[qq][1] = acc[qq][2] = acc[qq][3] = 0.0f;
          if constexpr (PASSES == 3) {  // the small terms first
            bm_mma(acc[qq], a[m][PARTS - 1], b[qq][0]);
            bm_mma(acc[qq], a[m][0], b[qq][PARTS - 1]);
          }
          bm_mma(acc[qq], a[m][0], b[qq][0]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          maybe[e] = bm_maybe(acc[0][e], acc[1][e], acc[2][e]);
          any |= maybe[e];
        }
        if (!__any_sync(0xffffffffu, any)) continue;
        constexpr int kT = BM_Q - 1;  // t·det
        acc[kT][0] = acc[kT][1] = acc[kT][2] = acc[kT][3] = 0.0f;
        if constexpr (PASSES == 3) {
          bm_mma(acc[kT], a[m][PARTS - 1], b[kT][0]);
          bm_mma(acc[kT], a[m][0], b[kT][PARTS - 1]);
        }
        bm_mma(acc[kT], a[m][0], b[kT][0]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!__any_sync(0xffffffffu, maybe[e])) continue;
          const float t =
              nr_mxu_epilogue(acc[0][e], acc[1][e], acc[2][e], acc[kT][e]);
          if (t < best_t[m][e >> 1]) {
            best_t[m][e >> 1] = t;
            best_tri[m][e >> 1] = col + (e & 1);
          }
        }
      }
    }
    __syncthreads();  // chunk ch consumed before chunk ch + 2 lands on it
  }
  float* dst = out + (long long)s * 2 * npad;  // a slice's partial rows
#pragma unroll
  for (int m = 0; m < BM_MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      nr_quad_hit(best_t[m][h], best_tri[m][h]);
      if (c == 0) {
        const long long r = ray0 + m * 16 + g + 8 * h;
        dst[r] = best_t[m][h];
        dst[npad + r] = __int_as_float(best_tri[m][h]);
      }
    }
  }
}

// The launch shape the wrapper allocates for: the triangle slices and the
// 8-byte words of the feature scratch (ops/trace_pallas.py::dense_scratch
// allocates them as doubles).
extern "C" int ablate_mxu_bf16_shape(int npad, int ttot, int* slices,
                                     long long* feat_words) {
  *feat_words = (long long)(ttot > 8 ? ttot : 8) / 8 * BM_FRAG;
  return nr_dense_slices(npad, ttot, BM_RAYS, BM_CHUNK_TRIS, BM_CTAS_PER_SM,
                         slices);
}

// feat: [T / 8][BM_FRAG] 8-byte scratch; part: [slices][2][npad] f32
// scratch (unused with one slice). npad must be a multiple of BM_RAYS and
// T of BM_CHUNK_TRIS.
extern "C" int ablate_mxu_bf16(int passes, const float* o, const float* d,
                               int npad, const float* tris, int ttot,
                               int slices, void* feat, float* part,
                               float* out, cudaStream_t stream) {
  if (npad % BM_RAYS != 0 || ttot % BM_CHUNK_TRIS != 0 || slices < 1 ||
      (passes != 1 && passes != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ctas = npad / BM_RAYS;
  if (ctas == 0) return static_cast<int>(cudaGetLastError());
  uint2* words = static_cast<uint2*>(feat);
  if (ttot > 0) {
    bm_features<<<(ttot + BM_THREADS - 1) / BM_THREADS, BM_THREADS, 0,
                  stream>>>(tris, ttot, words);
  }
  const dim3 grid(ctas, slices);
  const int nchunks = ttot / BM_CHUNK_TRIS;
  float* dst = slices == 1 ? out : part;
  if (passes == 3) {
    ablate_mxu_bf16_kernel<3><<<grid, BM_THREADS, 0, stream>>>(
        o, d, npad, words, nchunks, slices, dst);
  } else {
    ablate_mxu_bf16_kernel<1><<<grid, BM_THREADS, 0, stream>>>(
        o, d, npad, words, nchunks, slices, dst);
  }
  nr_dense_fold_launch<2>(part, npad, slices, nullptr, out, stream);
  return static_cast<int>(cudaGetLastError());
}

NR_ERROR_STRING_ENTRY
