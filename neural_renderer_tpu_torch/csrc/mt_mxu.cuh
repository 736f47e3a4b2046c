// Shared device code of the matrix-formulation trace kernels (NR_TRACE_MXU=1;
// ops/trace_mxu.py). Möller–Trumbore's four triple products are bilinear
// forms of ray features F = [d | o | o×d | 1 | 0...] and four triangle
// feature columns (f_det, f_u, f_v, f_t); see ops/trace_mxu.py for the
// identities. A warp evaluates them for 8 rays x 8 triangles at a time on
// the tensor cores and finishes each pair in FP32 on the CUDA cores.
//
// Products: FP64 mma.sync.m8n8k4. Features are built in f32 op by op in the
// twin's order (-fmad=false) and widened exactly; their FP64 products are
// exact and the sums round once to f32, so each of det, u·det, v·det and
// t·det is the f32 rounding of the bilinear form of the f32 features. (A
// 3xTF32 split of f32 operands keeps 22 of their 24 bits:
// scripts/emulate_mxu_split.py holds it against float64 Möller–Trumbore and
// finds t outside 1e-6 on rays where FP64 products stay inside.) Only live
// rows are multiplied. The kernel orders the ten live feature rows as three
// k4 groups, g0 = [d, 0], g1 = [o×d, 0], g2 = [o, 1] (a permutation of the
// twin's rows; the sums are the same): det takes g0, u and v take g0 and
// g1, t takes g2. Six k4 products per 8x8 tile, 48 FP64 flops per (ray,
// triangle) pair, of which the function needs 38 (19 multiply-adds: det 3,
// u 6, v 6, t 4).
//
// Fragment layout (PTX ISA, mma.m8n8k4 .f64): lane l holds A[l/4][l%4],
// B[l%4][l/4] and C[l/4][2(l%4) + {0, 1}]: one ray (row l/4) and two
// triangle columns per thread; the 4 lanes of a quad share the ray.
//
// Epilogue, per pair, in JAX's order (trace_mxu.py::pair_eval_raw):
//   ok = |det| >= 1e-8; inv = 1/(ok ? det : 1); u = u_num*inv, 0 <= u <= 1;
//   v = v_num*inv, v >= 0, u + v <= 1; t = t_num*inv, t > 1e-8; then
//   t > MIN_T. Facing is -det: FORWARD == det > 0.
#pragma once

#include "mt.cuh"

#define MXU_BLOCK_RAYS 512      // rays per block: the TPU kernels' block
#define MXU_WARPS 16            // 32 rays (4 m-tiles of 8) per warp
#define MXU_MT 4                // m-tiles per warp
#define MXU_TILE 128            // triangles staged per step (16 n-tiles)
#define MXU_COMBOS 6            // (quantity, k4 group) products per tile

// Staged triangle features in B-fragment order: feat[j][c][lane] is the
// lane's B element of n-tile j (triangles 8j..8j+7 of the step) for
// product c: 0 det·g0, 1 u·g0, 2 u·g1, 3 v·g0, 4 v·g1, 5 t·g2.
struct MxuTile {
  double feat[MXU_TILE / 8][MXU_COMBOS][32];
};

__device__ __forceinline__ void nr_dmma(double& c0, double& c1, double a,
                                        double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(c0), "+d"(c1)
      : "d"(a), "d"(b));
}

// The six feature columns of one triangle (v = v0, e1, e2) in B-fragment
// order: dst[c][4 * slot + k] for n-tile slot `slot` (0-7) of the
// triangle, product c and k4 element k.
__device__ __forceinline__ void nr_mxu_features(const float v[9],
                                                double (*dst)[32],
                                                int slot) {
  const float v0x = v[0], v0y = v[1], v0z = v[2];
  const float e1x = v[3], e1y = v[4], e1z = v[5];
  const float e2x = v[6], e2y = v[7], e2z = v[8];
  // cross(e2, e1), cross(e2, v0), cross(v0, e1), cross(e1, e2): the
  // twin's `_cross_rows` order.
  const float a0 = e2y * e1z - e2z * e1y, a1 = e2z * e1x - e2x * e1z,
              a2 = e2x * e1y - e2y * e1x;
  const float b0 = e2y * v0z - e2z * v0y, b1 = e2z * v0x - e2x * v0z,
              b2 = e2x * v0y - e2y * v0x;
  const float c0 = v0y * e1z - v0z * e1y, c1 = v0z * e1x - v0x * e1z,
              c2 = v0x * e1y - v0y * e1x;
  const float d0 = e1y * e2z - e1z * e2y, d1 = e1z * e2x - e1x * e2z,
              d2 = e1x * e2y - e1y * e2x;
  const float s = (e2x * c0 + e2y * c1) + e2z * c2;
  // Each feature column's k4 groups (g0 d rows, g1 o×d rows, g2 o rows and
  // the constant row), element k of each group: the twin's f_det, f_u, f_v,
  // f_t rows 0-2 | 6-8 | 3-5, 9.
  const float col[MXU_COMBOS][4] = {
      {a0, a1, a2, 0.0f},                   // det, g0
      {-b0, -b1, -b2, 0.0f},                // u, g0
      {e2x, e2y, e2z, 0.0f},                // u, g1
      {-c0, -c1, -c2, 0.0f},                // v, g0
      {-e1x, -e1y, -e1z, 0.0f},             // v, g1
      {d0, d1, d2, -s}};                    // t, g2
  const int g4 = slot * 4;
#pragma unroll
  for (int c = 0; c < MXU_COMBOS; ++c) {
#pragma unroll
    for (int k = 0; k < 4; ++k) dst[c][g4 + k] = (double)col[c][k];
  }
}

// Build the features of columns [col0, col0 + MXU_TILE) of the [9, total]
// triangle array into `tile`; threads 0..MXU_TILE-1 take one triangle each.
// Zero (padding) triangles give zero features: det 0, culled.
__device__ __forceinline__ void nr_mxu_stage(MxuTile* tile,
                                             const float* __restrict__ tris,
                                             long long total,
                                             long long col0) {
  const int q = threadIdx.x;
  if (q >= MXU_TILE) return;
  float v[9];
#pragma unroll
  for (int r = 0; r < 9; ++r) v[r] = tris[r * total + col0 + q];
  nr_mxu_features(v, tile->feat[q >> 3], q & 7);
}

// The lane's A elements of ray (o, d): element k = lane % 4 of the groups
// g0 = [d, 0], g1 = [o×d, 0], g2 = [o, 1].
__device__ __forceinline__ void nr_mxu_ray(float ox, float oy, float oz,
                                           float dx, float dy, float dz,
                                           double a[3]) {
  const int k = threadIdx.x & 3;
  const float odx = oy * dz - oz * dy;
  const float ody = oz * dx - ox * dz;
  const float odz = ox * dy - oy * dx;
  const float r0 = k == 0 ? dx : k == 1 ? dy : k == 2 ? dz : 0.0f;
  const float r1 = k == 0 ? odx : k == 1 ? ody : k == 2 ? odz : 0.0f;
  const float r2 = k == 0 ? ox : k == 1 ? oy : k == 2 ? oz : 1.0f;
  a[0] = (double)r0;
  a[1] = (double)r1;
  a[2] = (double)r2;
}

// The lane's MXU_COMBOS B elements of n-tile j.
__device__ __forceinline__ void nr_mxu_load_b(const MxuTile* tile, int j,
                                              double b[MXU_COMBOS]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < MXU_COMBOS; ++c) b[c] = tile->feat[j][c][lane];
}

// One 8x8 tile's four products for the lane's ray and two columns.
struct MxuAcc {
  double det[2], u[2], v[2], t[2];
};

__device__ __forceinline__ MxuAcc nr_mxu_products(
    const double a[3], const double b[MXU_COMBOS]) {
  MxuAcc r;
  r.det[0] = r.det[1] = 0.0;
  r.u[0] = r.u[1] = 0.0;
  r.v[0] = r.v[1] = 0.0;
  r.t[0] = r.t[1] = 0.0;
  nr_dmma(r.det[0], r.det[1], a[0], b[0]);
  nr_dmma(r.u[0], r.u[1], a[0], b[1]);
  nr_dmma(r.u[0], r.u[1], a[1], b[2]);
  nr_dmma(r.v[0], r.v[1], a[0], b[3]);
  nr_dmma(r.v[0], r.v[1], a[1], b[4]);
  nr_dmma(r.t[0], r.t[1], a[2], b[5]);
  return r;
}

// pair_eval_raw's FP32 epilogue on a pair's four products, then t > MIN_T:
// t, or NR_MISS where the pair is rejected (every cull but facing).
__device__ __forceinline__ float nr_mxu_epilogue(float det, float u_num,
                                                 float v_num, float t_num) {
  bool ok = fabsf(det) >= NR_TRI_EPS;
  const float inv_det = 1.0f / (ok ? det : 1.0f);
  const float u = u_num * inv_det;
  ok = ok && (u >= 0.0f) && (u <= 1.0f);
  const float v = v_num * inv_det;
  ok = ok && (v >= 0.0f) && (u + v <= 1.0f);
  const float t = t_num * inv_det;
  ok = ok && (t > NR_TRI_EPS) && (t > NR_MIN_T);
  return ok ? t : NR_MISS;
}

// Column i of a tile: its FP64 products rounded to f32, then the epilogue;
// writes det.
__device__ __forceinline__ float nr_mxu_pair(const MxuAcc& acc, int i,
                                             float* det_out) {
  const float det = __double2float_rn(acc.det[i]);
  *det_out = det;
  return nr_mxu_epilogue(det, __double2float_rn(acc.u[i]),
                         __double2float_rn(acc.v[i]),
                         __double2float_rn(acc.t[i]));
}

// Fold the strict two-min pair (b1, b2) into (m1, m2): m2 stays the min of
// the values strictly above m1 (`_strict_pair_update` over a multiset).
__device__ __forceinline__ void nr_pair_merge(float& m1, float& m2, float b1,
                                              float b2) {
  const float n1 = fminf(m1, b1);
  m2 = fminf(m1 > n1 ? m1 : m2, b1 > n1 ? b1 : b2);
  m1 = n1;
}

// Closest hit: keep (t, id) unless the candidate is nearer, or as near
// with a smaller id (the brute-force oracle's rule).
__device__ __forceinline__ void nr_hit_update(float& bt, int& bi, float t,
                                              int id) {
  if (t < bt || (t == bt && id < bi)) {
    bt = t;
    bi = id;
  }
}

// Reduce a per-lane closest hit over the lane's quad (the ray's 4 lanes).
__device__ __forceinline__ void nr_quad_hit(float& bt, int& bi) {
#pragma unroll
  for (int s = 1; s <= 2; s <<= 1) {
    const float ot = __shfl_xor_sync(0xffffffffu, bt, s);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, s);
    nr_hit_update(bt, bi, ot, oi);
  }
}

__device__ __forceinline__ float nr_quad_min(float x) {
  x = fminf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fminf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ void nr_quad_pair(float& m1, float& m2) {
#pragma unroll
  for (int s = 1; s <= 2; s <<= 1) {
    const float b1 = __shfl_xor_sync(0xffffffffu, m1, s);
    const float b2 = __shfl_xor_sync(0xffffffffu, m2, s);
    nr_pair_merge(m1, m2, b1, b2);
  }
}

// Ray index (within the whole batch) of the lane's row in m-tile m.
__device__ __forceinline__ long long nr_mxu_ray_index(int m) {
  return (long long)blockIdx.x * MXU_BLOCK_RAYS + (threadIdx.x >> 5) * 32 +
         m * 8 + ((threadIdx.x & 31) >> 2);
}

// Load the lane's four rays and their A fragments.
__device__ __forceinline__ void nr_mxu_rays(const float* __restrict__ o,
                                            const float* __restrict__ d,
                                            int npad, double a[MXU_MT][3]) {
#pragma unroll
  for (int m = 0; m < MXU_MT; ++m) {
    const long long r = nr_mxu_ray_index(m);
    nr_mxu_ray(o[r], o[npad + r], o[2LL * npad + r], d[r], d[npad + r],
               d[2LL * npad + r], a[m]);
  }
}

// The sweeps' per-ray accumulators for the lane's four rays: outer forward
// strict pair (m1f, m2f), outer backward, inner forward, inner backward.
struct MxuSweep {
  float m1f[MXU_MT], m2f[MXU_MT], m1b[MXU_MT], i1f[MXU_MT], i1b[MXU_MT];
};

__device__ __forceinline__ void nr_sweep_init(MxuSweep& s) {
#pragma unroll
  for (int m = 0; m < MXU_MT; ++m)
    s.m1f[m] = s.m2f[m] = s.m1b[m] = s.i1f[m] = s.i1b[m] = NR_MISS;
}

// Fold every pair of the staged tile into the lane's accumulators: outer
// tiles the forward pair (or min) and the backward min, inner tiles the two
// mins. Forward is det > 0, backward det < 0 (facing = -det).
__device__ __forceinline__ void nr_sweep_tile(MxuSweep& s,
                                              const MxuTile* tile,
                                              const double a[MXU_MT][3],
                                              bool outer, int with_fwd2) {
  for (int j = 0; j < MXU_TILE / 8; ++j) {
    double b[MXU_COMBOS];
    nr_mxu_load_b(tile, j, b);
#pragma unroll
    for (int m = 0; m < MXU_MT; ++m) {
      const MxuAcc acc = nr_mxu_products(a[m], b);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float det;
        const float t = nr_mxu_pair(acc, i, &det);
        if (outer) {
          nr_sweep_outer(with_fwd2, t, det, s.m1f[m], s.m2f[m], s.m1b[m]);
        } else {
          nr_sweep_inner(t, det, s.i1f[m], s.i1b[m]);
        }
      }
    }
  }
}

// Merge each ray's accumulators over its quad (the strict pair and the mins
// are selections: grouping-independent).
__device__ __forceinline__ void nr_sweep_quad(MxuSweep& s, int with_fwd2) {
#pragma unroll
  for (int m = 0; m < MXU_MT; ++m) {
    if (with_fwd2) {
      nr_quad_pair(s.m1f[m], s.m2f[m]);
    } else {
      s.m1f[m] = nr_quad_min(s.m1f[m]);
    }
    s.m1b[m] = nr_quad_min(s.m1b[m]);
    s.i1f[m] = nr_quad_min(s.i1f[m]);
    s.i1b[m] = nr_quad_min(s.i1b[m]);
  }
}

// Merge each ray's accumulators over its quad and write the rows outer_fwd,
// outer_bwd, inner_fwd, inner_bwd[, outer_fwd2] of out [5 or 4, npad].
__device__ __forceinline__ void nr_sweep_write(MxuSweep& s, int with_fwd2,
                                               int npad,
                                               float* __restrict__ out) {
  nr_sweep_quad(s, with_fwd2);
#pragma unroll
  for (int m = 0; m < MXU_MT; ++m) {
    if ((threadIdx.x & 3) == 0) {
      const long long r = nr_mxu_ray_index(m);
      out[r] = s.m1f[m];
      out[npad + r] = s.m1b[m];
      out[2LL * npad + r] = s.i1f[m];
      out[3LL * npad + r] = s.i1b[m];
      if (with_fwd2) out[4LL * npad + r] = s.m2f[m];
    }
  }
}
