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
// K8's skeleton (csrc/trace_dense_mxu.cu): 512 rays per block, 16 warps of
// 32 rays, here two 16-ray m-tiles per warp with their A fragments (hi and
// lo) in registers. The block stages the features of 128 triangles at a
// time in B-fragment order (32 KB for three passes). Per 8-triangle n-tile
// a warp loads the B fragments once and runs 4 (one pass) or 12 (three)
// products per m-tile, then pair_eval_raw's FP32 epilogue per pair
// (csrc/mt_mxu.cuh::nr_mxu_epilogue). Each lane keeps the best (t, id) of
// its two rays per m-tile; the quad reduces them at the end (min t, smallest
// id).
// ANY mode, no skip mask: the reference ablation calls K8 with neither.
//
// Fragment layout (PTX ISA, mma.m16n8k16 .bf16, g = lane/4, c = lane%4):
// A regs {A[g][2c..], A[g+8][2c..], A[g][2c+8..], A[g+8][2c+8..]}, two bf16
// each (the lower k in the low half); B regs {B[2c..][g], B[2c+8..][g]};
// C {C[g][2c], C[g][2c+1], C[g+8][2c], C[g+8][2c+1]}.
//
// Bound (ops/bounds.py): the larger of the bf16 tensor products (the
// function's 19 multiply-adds per pair and pass at 989 TFLOP/s) and the FP32
// epilogue (5 operations per pair at the FP32 instruction rate; the f32
// accumulators need no conversion).
#include <cuda_bf16.h>
#include <stdint.h>

#include "mt_mxu.cuh"

#define BM_BLOCK_RAYS 512
#define BM_MT 2          // 16-ray m-tiles per warp
#define BM_TILE 128      // triangles staged per step (16 n-tiles)
#define BM_Q 4           // quantities: det, u·det, v·det, t·det

template <int PARTS>     // 1: hi; 2: hi and lo
struct BmTile {
  uint2 feat[BM_TILE / 8][BM_Q][PARTS][32];
};

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

// Triangle q of the step (threads 0..BM_TILE-1 take one each): its four
// feature columns in trace_mxu.tri_features' row order, f32 op by op, split
// and written where the lanes of its n-tile read them.
template <int PARTS>
__device__ __forceinline__ void bm_stage(BmTile<PARTS>* tile,
                                         const float* __restrict__ tris,
                                         long long total, long long col0) {
  const int q = threadIdx.x;
  if (q >= BM_TILE) return;
  float v[9];
#pragma unroll
  for (int r = 0; r < 9; ++r) v[r] = tris[r * total + col0 + q];
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
  const int j = q >> 3, n = q & 7;
#pragma unroll
  for (int qq = 0; qq < BM_Q; ++qq) {
#pragma unroll
    for (int p = 0; p < PARTS; ++p) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        uint2 w;
        w.x = bm_part(f[qq][2 * c], f[qq][2 * c + 1], p);
        w.y = bm_part(f[qq][2 * c + 8], f[qq][2 * c + 9], p);
        tile->feat[j][qq][p][n * 4 + c] = w;
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

template <int PASSES>
__global__ void __launch_bounds__(BM_BLOCK_RAYS)
ablate_mxu_bf16_kernel(const float* __restrict__ o,
                       const float* __restrict__ d, int n,
                       const float* __restrict__ tris, int ttot,
                       float* __restrict__ out) {
  constexpr int PARTS = PASSES == 1 ? 1 : 2;
  __shared__ BmTile<PARTS> tile;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const long long ray0 = (long long)blockIdx.x * BM_BLOCK_RAYS +
                         (threadIdx.x >> 5) * 32;
  // A fragments per m-tile and part: rows g and g + 8 of the m-tile.
  uint32_t a[BM_MT][PARTS][4];
#pragma unroll
  for (int m = 0; m < BM_MT; ++m) {
    float f[2][10];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = ray0 + m * 16 + g + 8 * h;
      const float ox = o[r], oy = o[n + r], oz = o[2LL * n + r];
      const float dx = d[r], dy = d[n + r], dz = d[2LL * n + r];
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
  for (int base = 0; base < ttot; base += BM_TILE) {
    __syncthreads();  // previous tile fully consumed
    bm_stage<PARTS>(&tile, tris, ttot, base);
    __syncthreads();
    for (int j = 0; j < BM_TILE / 8; ++j) {
      uint2 b[BM_Q][PARTS];
#pragma unroll
      for (int qq = 0; qq < BM_Q; ++qq) {
#pragma unroll
        for (int p = 0; p < PARTS; ++p) b[qq][p] = tile.feat[j][qq][p][lane];
      }
      const int col = base + 8 * j + 2 * c;
#pragma unroll
      for (int m = 0; m < BM_MT; ++m) {
        float acc[BM_Q][4];
#pragma unroll
        for (int qq = 0; qq < BM_Q; ++qq) {
          acc[qq][0] = acc[qq][1] = acc[qq][2] = acc[qq][3] = 0.0f;
          if constexpr (PASSES == 3) {  // the small terms first
            bm_mma(acc[qq], a[m][PARTS - 1], b[qq][0]);
            bm_mma(acc[qq], a[m][0], b[qq][PARTS - 1]);
          }
          bm_mma(acc[qq], a[m][0], b[qq][0]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float t =
              nr_mxu_epilogue(acc[0][e], acc[1][e], acc[2][e], acc[3][e]);
          nr_hit_update(best_t[m][e >> 1], best_tri[m][e >> 1], t,
                        col + (e & 1));
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < BM_MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      nr_quad_hit(best_t[m][h], best_tri[m][h]);
      if (c == 0) {
        const long long r = ray0 + m * 16 + g + 8 * h;
        out[r] = best_t[m][h];
        out[n + r] = __int_as_float(best_tri[m][h]);
      }
    }
  }
}

extern "C" int ablate_mxu_bf16(int passes, const float* o, const float* d,
                               int n, const float* tris, int ttot, float* out,
                               cudaStream_t stream) {
  if (n % BM_BLOCK_RAYS != 0 || ttot % BM_TILE != 0 ||
      (passes != 1 && passes != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = n / BM_BLOCK_RAYS;
  if (nb > 0) {
    if (passes == 3) {
      ablate_mxu_bf16_kernel<3><<<nb, BM_BLOCK_RAYS, 0, stream>>>(
          o, d, n, tris, ttot, out);
    } else {
      ablate_mxu_bf16_kernel<1><<<nb, BM_BLOCK_RAYS, 0, stream>>>(
          o, d, n, tris, ttot, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

NR_ERROR_STRING_ENTRY
