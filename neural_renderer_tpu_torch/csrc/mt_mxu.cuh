// Shared device code of the matrix-formulation trace kernels (NR_TRACE_MXU=1;
// ops/trace_mxu.py). Möller–Trumbore's four triple products are bilinear
// forms of ray features F = [d | o | o×d | 1 | 0...] and four triangle
// feature columns (f_det, f_u, f_v, f_t); see ops/trace_mxu.py for the
// identities. A warp evaluates them for 8 (clustered kernels) or 16 (dense
// kernels) rays x 8 triangles at a time on the tensor cores and finishes
// each pair in FP32 on the CUDA cores.
//
// Products: FP64 mma.sync. Features are built in f32 op by op in the twin's
// order (-fmad=false) and widened exactly; their FP64 products are exact and
// the sums round once to f32, so each of det, u·det, v·det and t·det is the
// f32 rounding of the bilinear form of the f32 features. (A 3xTF32 split of
// f32 operands keeps 22 of their 24 bits: scripts/emulate_mxu_split.py
// holds it against float64 Möller–Trumbore and finds t outside 1e-6 on rays
// where FP64 products stay inside.) Only live rows are multiplied. The
// kernels order the ten live feature rows as three k4 groups, g0 = [d, 0],
// g1 = [o×d, 0], g2 = [o, 1] (a permutation of the twin's rows; the sums
// are the same): det takes g0, u and v take g0 and g1, t takes g2. 48 FP64
// flops per (ray, triangle) pair as issued, of which the function needs 38
// (19 multiply-adds: det 3, u 6, v 6, t 4).
//
// Fragment layout (PTX ISA, mma .f64, g = lane / 4, k = lane % 4): B (k x 8
// triangles) holds B[k][g], one triangle column per quad, so a triangle's
// six k4 feature columns in B-fragment order serve every shape. m8n8k4: A
// holds A[g][k], C C[g][2k + {0, 1}]: one ray and two triangle columns per
// lane (the clustered kernels). m16n8k4 / m16n8k8: A holds rows g and g + 8
// (and k + 4 for k8), C C[g][2k + {0, 1}], C[g + 8][2k + {0, 1}] (the dense
// kernels). On the H100 m8n8k4 runs at half the FP64 tensor rate of the
// m16n8 shapes (33.4 against 66.6 TFLOP/s; PERF.md).
//
// Epilogue, per pair, in JAX's order (trace_mxu.py::pair_eval_raw):
//   ok = |det| >= 1e-8; inv = 1/(ok ? det : 1); u = u_num*inv, 0 <= u <= 1;
//   v = v_num*inv, v >= 0, u + v <= 1; t = t_num*inv, t > 1e-8; then
//   t > MIN_T. Facing is -det: FORWARD == det > 0.
#pragma once

#include "dense_slices.cuh"

#define MXU_MT 4                // 8-ray m-tiles per warp (clustered kernels)
#define MXU_COMBOS 6            // (quantity, k4 group) products per tile

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
// triangle, product c (0 det·g0, 1 u·g0, 2 u·g1, 3 v·g0, 4 v·g1, 5 t·g2)
// and k4 element k.
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

// A pair's FP64 products rounded to f32, then the epilogue; writes det.
__device__ __forceinline__ float nr_mxu_pair(double det64, double u64,
                                             double v64, double t64,
                                             float* det_out) {
  const float det = __double2float_rn(det64);
  *det_out = det;
  return nr_mxu_epilogue(det, __double2float_rn(u64),
                         __double2float_rn(v64), __double2float_rn(t64));
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

// The sweeps' per-ray accumulators for N rows of the lane: outer forward
// strict pair (m1f, m2f), outer backward, inner forward, inner backward.
template <int N>
struct MxuSweepN {
  float m1f[N], m2f[N], m1b[N], i1f[N], i1b[N];
};
using MxuSweep = MxuSweepN<MXU_MT>;

template <int N>
__device__ __forceinline__ void nr_sweep_init(MxuSweepN<N>& s) {
#pragma unroll
  for (int m = 0; m < N; ++m)
    s.m1f[m] = s.m2f[m] = s.m1b[m] = s.i1f[m] = s.i1b[m] = NR_MISS;
}

// Merge each ray's accumulators over its quad (the strict pair and the mins
// are selections: grouping-independent).
template <int N>
__device__ __forceinline__ void nr_sweep_quad(MxuSweepN<N>& s,
                                              int with_fwd2) {
#pragma unroll
  for (int m = 0; m < N; ++m) {
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

// ---- The dense kernels: K8 (trace_dense_mxu.cu), K4-MXU (sweep_dense_mxu.cu)
//
// Features once per launch. nr_dx_features writes every triangle's six
// feature columns in B-fragment order to a global scratch (DX_FRAG doubles
// per 8-triangle n-tile, 192 bytes a triangle: 1.8 MB for 9,216 triangles,
// L2-resident), so no CTA builds them; the walk streams DX_CHUNK n-tiles at
// a time into a shared double buffer with 16-byte cp.async.
//
// CTA. DX_WARPS warps of one 16-ray m-tile each: DX_RAYS rays, a slice of
// the 512-ray skip block (the flag is read at ray0 / 512, so it keeps its
// meaning). Per n-tile a warp loads its six B fragments from shared memory
// and runs m16n8k4 for det and t and m16n8k8 for u and v: 4 instructions
// per 128 pairs, where m8n8k4's 6 per 64 ran at half the FP64 tensor rate.
//
// Prefilter. Each of the lane's four pairs is tested, without a branch,
// from the high words of its FP64 products (nr_dx_maybe). A warp runs the
// conversions and the FP32 epilogue of pair slot e (rows g or g + 8,
// even or odd columns: 8 rays x 4 triangles) only where some lane's pair e
// may pass: a pair's four FP64-to-FP32 conversions (14 per clock per SM on
// the H100) cost more than its products, and a ray meets the parallelogram
// of only a few of the mesh's triangles.
//
// Slices: csrc/dense_slices.cuh's, DX_CTAS_PER_SM CTAs per SM at least, at
// most one slice per chunk (nr_dx_shape, exported by each library as
// `<name>_shape`; ops/trace_pallas.py::dense_scratch sizes the scratch
// from it).
//
// One 16-ray m-tile a warp, four warps, the branch-free prefilter without
// t's sign and the per-slot vote were the fastest of the variants measured
// (one or two m-tiles, four or eight warps, chunks of 4, 8 or 16 n-tiles,
// the prefilter with branches or with t's sign, one vote per tile;
// PERF.md).
#define DX_WARPS 4               // warps per CTA, one 16-ray m-tile each
#define DX_THREADS (32 * DX_WARPS)
#define DX_RAYS (16 * DX_WARPS)
#define DX_CHUNK 8               // n-tiles per staged chunk
#define DX_CHUNK_TRIS (8 * DX_CHUNK)
#define DX_FRAG (MXU_COMBOS * 32)  // doubles of one n-tile's B fragments
#define DX_SMEM (2 * DX_CHUNK * DX_FRAG * 8)
#define DX_CTAS_PER_SM 8         // a one-slice launch's CTAs per SM, at least
static_assert(NR_SKIP_RAYS % DX_RAYS == 0, "a CTA lies in one skip block");
static_assert(DX_SMEM <= 48 * 1024,
              "the chunk buffers need an opt-in attribute");

// The launch shape of npad rays against ttot triangles on the current
// device: the triangle slices and the doubles of the feature scratch.
static inline int nr_dx_shape(int npad, int ttot, int* slices,
                              long long* feat_doubles) {
  *feat_doubles = (long long)(ttot > 8 ? ttot : 8) / 8 * DX_FRAG;
  return nr_dense_slices(npad, ttot, DX_RAYS, DX_CHUNK_TRIS, DX_CTAS_PER_SM,
                         slices);
}

// Every triangle's features, thread q the triangle q of [9, ttot].
__global__ void __launch_bounds__(DX_THREADS)
nr_dx_features(const float* __restrict__ tris, int ttot,
               double* __restrict__ feat) {
  const int q = blockIdx.x * DX_THREADS + threadIdx.x;
  if (q >= ttot) return;
  float v[9];
#pragma unroll
  for (int r = 0; r < 9; ++r) v[r] = tris[(long long)r * ttot + q];
  nr_mxu_features(
      v, reinterpret_cast<double(*)[32]>(feat + (long long)(q >> 3) * DX_FRAG),
      q & 7);
}

__device__ __forceinline__ void nr_dmma16k4(double (&c)[4], double a0,
                                            double a1, double b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b0));
}

__device__ __forceinline__ void nr_dmma16k8(double (&c)[4], double a0,
                                            double a1, double a2, double a3,
                                            double b0, double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

// A fragments of a 16-ray m-tile: the groups g0, g1, g2 of rows g and g + 8.
struct DxRays {
  double g0[2], g1[2], g2[2];
};

// The lane's rays: r (its row g of the warp's m-tile) and r + 8.
__device__ __forceinline__ void nr_dx_rays(const float* __restrict__ o,
                                           const float* __restrict__ d,
                                           int npad, long long r,
                                           DxRays& a) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long q = r + 8 * h;
    double x[3];
    nr_mxu_ray(o[q], o[npad + q], o[2LL * npad + q], d[q], d[npad + q],
               d[2LL * npad + q], x);
    a.g0[h] = x[0];
    a.g1[h] = x[1];
    a.g2[h] = x[2];
  }
}

// One 16x8 tile's four products: element (slot) e of each is the pair (row
// g + 8 (e >> 1), column 2 (lane % 4) + (e & 1)).
struct DxAcc {
  double det[4], u[4], v[4], t[4];
};

__device__ __forceinline__ DxAcc nr_dx_products(const DxRays& a,
                                                const double b[MXU_COMBOS]) {
  DxAcc r;
#pragma unroll
  for (int e = 0; e < 4; ++e) r.det[e] = r.u[e] = r.v[e] = r.t[e] = 0.0;
  nr_dmma16k4(r.det, a.g0[0], a.g0[1], b[0]);
  nr_dmma16k8(r.u, a.g0[0], a.g0[1], a.g1[0], a.g1[1], b[1], b[2]);
  nr_dmma16k8(r.v, a.g0[0], a.g0[1], a.g1[0], a.g1[1], b[3], b[4]);
  nr_dmma16k4(r.t, a.g2[0], a.g2[1], b[5]);
  return r;
}

// The prefilter: false only for a pair whose FP32 epilogue (and, with
// kMode 1 FORWARD_ONLY or 2 BACKWARD_ONLY, the facing cull) certainly
// rejects it. It reads the high 32-bit word of each FP64 product (sign, 11
// exponent bits, 20 mantissa bits) as an f32 bit pattern: that "view" is
// monotone in |x| (it orders like the high words), so f32 compares and
// products of views decide, with margins, what rn(det), rn(u·det), ... will
// do. With D, U, V the products and a = view(|D|):
//   a < view(2^-27) (0.1875): |D| < 2^-27, so |rn(D)| < 1e-8: culled;
//   a >= view(2^40) (60): no claim (1/rn(D) could lose precision);
//   else view(U) view(D) < -1/16: U and D differ in sign and |U| >= 2^-100
//     (|view(D)| < 60), so u = rn(rn(U) rn(1/rn(D))) <= -2^-140 < 0 (f32
//     subnormals are kept): culled; the same for V (v < 0);
//   |view(U)| >= rn(a (1 + 2^-18)): U's high word is at least 8 above D's,
//     |U| > |D| (1 + 7·2^-21), so |u| > 1 after the four roundings (each
//     within 2^-24): u < 0 or u > 1, culled; the same for V (v > 1 with
//     u >= 0 gives u + v > 1).
// (t's sign would catch pairs behind the ray; its test cost more than the
// epilogues it saved.) ops/trace_mxu.py::certain_miss is the same rule on
// the CPU, held against pair_epilogue by tests/test_torch_dense_mxu.py.
#define DX_VIEW_DET_MIN 0.1875f        // view of 2^-27
#define DX_VIEW_DET_MAX 60.0f          // view of 2^40
#define DX_VIEW_SIGN_TAU 0.0625f       // > 60 x view of 2^-100 x 2
#define DX_VIEW_STEP8 1.000003814697265625f  // 1 + 2^-18

template <int kMode>
__device__ __forceinline__ bool nr_dx_maybe(double det, double u,
                                            double v) {
  const float fd = __int_as_float(__double2hiint(det));
  const float fu = __int_as_float(__double2hiint(u));
  const float fv = __int_as_float(__double2hiint(v));
  const float a = fabsf(fd);
  const float step = a * DX_VIEW_STEP8;
  // Bitwise operators: no branch.
  const bool out = (fu * fd < -DX_VIEW_SIGN_TAU) |
                   (fv * fd < -DX_VIEW_SIGN_TAU) | (fabsf(fu) >= step) |
                   (fabsf(fv) >= step);
  bool miss = (a < DX_VIEW_DET_MIN) | ((a < DX_VIEW_DET_MAX) & out);
  if (kMode == 1) miss |= !(fd > 0.0f);
  if (kMode == 2) miss |= !(fd < 0.0f);
  return !miss;
}

// Start the copies of chunk c of the feature scratch into `dst`.
__device__ __forceinline__ void nr_dx_stage(double* dst,
                                            const double* __restrict__ feat,
                                            int c) {
  const double* src = feat + (long long)c * (DX_CHUNK * DX_FRAG);
  for (int e = threadIdx.x; e < DX_CHUNK * DX_FRAG / 2; e += DX_THREADS)
    nr_cp_async16(dst + 2 * e, src + 2 * e);
}

// Walk chunks [c0, c1) of the feature scratch: stage chunk c + 1 into the
// other half of `buf` while chunk c is swept; per n-tile the four products,
// the prefilter, and, for each pair slot where some lane's pair may pass,
// the lane's pair through the epilogue into fold(e, triangle id, t, det).
// A lane visits its triangles in increasing id.
template <int kMode, class Fold>
__device__ __forceinline__ void nr_dx_walk(const double* __restrict__ feat,
                                           int c0, int c1, const DxRays& a,
                                           double* buf, Fold&& fold) {
  constexpr int kBuf = DX_CHUNK * DX_FRAG;
  const int lane = threadIdx.x & 31;
  if (c0 < c1) {
    nr_dx_stage(buf, feat, c0);
    nr_cp_async_commit();
  }
  for (int c = c0; c < c1; ++c) {
    if (c + 1 < c1) {
      // The other half was last read before the previous chunk's barrier.
      nr_dx_stage(buf + ((c + 1 - c0) & 1) * kBuf, feat, c + 1);
      nr_cp_async_commit();
      nr_cp_async_wait<1>();
    } else {
      nr_cp_async_wait<0>();
    }
    __syncthreads();  // chunk c has landed for every thread
    const double* f = buf + ((c - c0) & 1) * kBuf;
    for (int j = 0; j < DX_CHUNK; ++j) {
      double b[MXU_COMBOS];
#pragma unroll
      for (int q = 0; q < MXU_COMBOS; ++q) b[q] = f[j * DX_FRAG + q * 32 + lane];
      const int col = (c * DX_CHUNK + j) * 8 + 2 * (lane & 3);
      const DxAcc acc = nr_dx_products(a, b);
      bool maybe[4];
      bool any = false;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        maybe[e] = nr_dx_maybe<kMode>(acc.det[e], acc.u[e], acc.v[e]);
        any |= maybe[e];
      }
      if (!__any_sync(0xffffffffu, any)) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!__any_sync(0xffffffffu, maybe[e])) continue;
        float det;
        const float t = nr_mxu_pair(acc.det[e], acc.u[e], acc.v[e], acc.t[e],
                                    &det);
        fold(e, col + (e & 1), t, det);
      }
    }
    __syncthreads();  // chunk c consumed before chunk c + 2 lands on it
  }
}

// The lane's row-g ray in the CTA starting at ray0.
__device__ __forceinline__ long long nr_dx_ray(long long ray0) {
  return ray0 + (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
}
