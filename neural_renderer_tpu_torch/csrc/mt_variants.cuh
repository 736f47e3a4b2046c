// The tile maths of the trace-kernel ablation (ops/trace_ablation.py;
// scripts/ablate_trace_kernel.py::_mt_tile :47-97 and _probe_tile :100 of
// the reference), shared by its two FP32 dense kernels: the closest hit
// (csrc/ablate_trace.cu) and the dual-shell sweep (csrc/ablate_sweep.cu).
// Both run K3's and K4's walk (csrc/mt_dense.cuh), so each variant but the
// probe is a tile math of that walk (the contract above df_walk): its pair
// math and a prefilter rule in its own operations and precision on the
// det, u·det and v·det that math computes, which rejects only pairs the
// math certainly rejects. So every output equals the unfiltered loop's bit
// for bit (ops/trace_ablation.py::variant_rule is each rule on the CPU,
// held against the variants' twins by tests/test_torch_ablate_prefilter.py).
// The rules are about one pair's values, so they hold for any fold that a
// rejected pair's t (the variant's miss value) leaves unchanged: the
// sweep's mins and strict pair, and the trace's closest hit, whose
// accumulator starts at that miss value and takes only a strictly smaller
// t. With a = |det| and w = num sgn(det) for num = u·det or v·det:
//
//   local, recip (DfMt, DfRecip): 1/det by an IEEE divide and by
//     __frcp_rn, the same value: mt_dense.cuh's rule and its proof
//     (margins 2^-20).
//   recipx (DfRecipx): 1/det by rcp.approx.ftz.f32: within 1 ulp (2^-23
//     relative) of 1/det where that is a normal f32 (PTX ISA), and 0 where
//     it is subnormal (|det| > 2^126), where t = t·det x 0 fails t > 1e-8
//     and the pair is rejected whatever the rule says. The rule rejects w <
//     a (-2^-18) or w >= rn(a (1 + 2^-18)), which covers a reciprocal
//     within 2^-19 of 1/det (16 ulps of 2^-23): for the first, |u| >=
//     2^-18 (1 - 2^-19)(1 - 2^-24), so u < 0; for the second, u·det / det
//     >= (1 + 2^-18)(1 - 2^-24), times (1 - 2^-19) above 1 + 2^-24, so u
//     rounds above 1 (and v > 1 with u >= 0 gives u + v > 1). The proof
//     is about u and v of one pair, so it holds in the trace as in the
//     sweep: both fold the t that nr_mt_t<NR_RCP_APPROX> gives.
//   nodiv (DfNodiv): its culls compare w with 0 and a themselves (us =
//     u·det s with s = sgn(det), exact), so the rule is those compares and
//     needs no margin: w < 0 or w > a rejects (v > a with us >= 0 gives
//     rn(us + vs) >= vs > a). No bound multiply.
//   bf16 (DfBf16): det, u·det and v·det are the packed bf16 values of its
//     operations (widened exactly to f32); 1/det is rn_bf16(rn_f32(1 /
//     det)), within 2^-5 of 1/det (2^-8 + 2^-24 where it is normal;
//     2^-134 + 2^-150 absolute, at least 2^-128 being subnormal). The rule
//     rejects w < a (-2^-20): u rounds from a product of magnitude above
//     2^-20 (1 - 2^-5) (1 - 2^-24) > 2^-134, so u < 0; or w >= rn(a (1 +
//     2^-4)): the product is at least 1.0625 (1 - 2^-24)(1 - 2^-5) > 1.029,
//     which rounds to at least 1.0234 in bf16, so u > 1. Its miss value is
//     bf16(1e30) widened, NR_BF16_MISS, not 1e30.
//
// Padding (a = 0, u·det = v·det = 0) is rejected by every rule; |det| below
// 1e-8 may be rejected freely (every variant culls it); NaN fails every
// compare and is left to the pair math.
//
// The probe (MtProbe) has no hit for a rule to cut: it keeps its own loop
// in csrc/ablate_trace.cu.
//
// Built with -fmad=false (ops/cuda_build.py): no product is fused into an
// add, so every variant rounds op by op like its PyTorch twin.
#pragma once

#include <cuda_bf16.h>

#include "mt_dense.cuh"

// bf16(1e30), bf16(1e-8) and bf16(1e-6) widened to f32: the reference's
// constants under JAX's weak typing in the bf16 variant.
#define NR_BF16_MISS 1.00025555e30f
#define NR_BF16_EPS 1.00117177e-8f
#define NR_BF16_MIN_T 9.983778e-7f

#define DF_RCPX_LO (-3.814697265625e-06f)     // -2^-18
#define DF_RCPX_HI 1.000003814697265625f      // 1 + 2^-18
#define DF_BF16_HI 1.0625f                    // 1 + 2^-4

// recip: local's values, local's rule.
using DfRecip = DfMtRcp<NR_RCP_RN>;

struct DfRecipx : DfScalar<DfRecipx> {
  __device__ __forceinline__ static void bounds(DfPair& p) {
    p.lo = fabsf(p.det) * DF_RCPX_LO;
    p.hi = fabsf(p.det) * DF_RCPX_HI;
  }
  __device__ __forceinline__ static bool out(float w, const DfPair& p) {
    return (w < p.lo) | (w >= p.hi);
  }
  __device__ __forceinline__ static float pair(const DfRays& r, int i,
                                               const float4& a,
                                               const float4& b,
                                               const float4& c, float* det) {
    return nr_mt_t<NR_RCP_APPROX>(r.ox[i], r.oy[i], r.oz[i], r.dx[i],
                                  r.dy[i], r.dz[i], a.x, a.y, a.z, a.w, b.x,
                                  b.y, b.z, b.w, c.x, det);
  }
};

// nodiv's pair math: the barycentric culls compare u_num and v_num, times
// det's sign, with |det| (_mt_tile :73-85); one IEEE divide gives t.
__device__ __forceinline__ float nr_nodiv_t(
    float ox, float oy, float oz, float dx, float dy, float dz, float v0x,
    float v0y, float v0z, float e1x, float e1y, float e1z, float e2x,
    float e2y, float e2z, float* det_out) {
  float px = dy * e2z - dz * e2y;
  float py = dz * e2x - dx * e2z;
  float pz = dx * e2y - dy * e2x;
  float det = e1x * px + e1y * py + e1z * pz;
  *det_out = det;
  float tx = ox - v0x;
  float ty = oy - v0y;
  float tz = oz - v0z;
  float u_num = tx * px + ty * py + tz * pz;
  float qx = ty * e1z - tz * e1y;
  float qy = tz * e1x - tx * e1z;
  float qz = tx * e1y - ty * e1x;
  float v_num = dx * qx + dy * qy + dz * qz;
  float t_num = e2x * qx + e2y * qy + e2z * qz;
  bool ok = fabsf(det) >= NR_TRI_EPS;
  const float s = det < 0.0f ? -1.0f : 1.0f;
  const float ad = fabsf(det);
  const float us = u_num * s;
  const float vs = v_num * s;
  ok = ok && (us >= 0.0f) && (us <= ad);
  ok = ok && (vs >= 0.0f) && (us + vs <= ad);
  const float ts = t_num * s;
  ok = ok && (ts > NR_TRI_EPS * ad);
  const float t = ts / ad;
  ok = ok && (t > NR_TRI_EPS) && (t > NR_MIN_T);
  return ok ? t : NR_MISS;
}

struct DfNodiv : DfScalar<DfNodiv> {
  __device__ __forceinline__ static void bounds(DfPair& p) {
    p.hi = fabsf(p.det);
  }
  __device__ __forceinline__ static bool out(float w, const DfPair& p) {
    return (w < 0.0f) | (w > p.hi);
  }
  __device__ __forceinline__ static float pair(const DfRays& r, int i,
                                               const float4& a,
                                               const float4& b,
                                               const float4& c, float* det) {
    return nr_nodiv_t(r.ox[i], r.oy[i], r.oz[i], r.dx[i], r.dy[i], r.dz[i],
                      a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, det);
  }
};

// Packed bf16 arithmetic with an explicit rounding mode: PTX lets the code
// generator fuse a mul and an add that carry none, -fmad=false or not.
__device__ __forceinline__ unsigned nr_b2u(__nv_bfloat162 x) {
  return *reinterpret_cast<unsigned*>(&x);
}
__device__ __forceinline__ __nv_bfloat162 nr_u2b(unsigned x) {
  return *reinterpret_cast<__nv_bfloat162*>(&x);
}
#define NR_BF16X2_OP(name, op)                                             \
  __device__ __forceinline__ __nv_bfloat162 name(__nv_bfloat162 a,        \
                                                 __nv_bfloat162 b) {      \
    unsigned d;                                                            \
    asm(op ".rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(nr_b2u(a)),          \
        "r"(nr_b2u(b)));                                                   \
    return nr_u2b(d);                                                      \
  }
NR_BF16X2_OP(nr_bmul, "mul")
NR_BF16X2_OP(nr_badd, "add")
NR_BF16X2_OP(nr_bsub, "sub")
#undef NR_BF16X2_OP

// bf16: every operand, constant and intermediate in bf16, on packed
// __nv_bfloat162: the thread's two rays in the halves (low ray 0, high ray
// 1) against one triangle, whose nine values the chunk's prepare()
// converts once, in place, to bf16x2 (rn of each f32 value). Products of
// bf16 values are exact in f32 and a sum of two rounds once, so each packed
// operation (round to nearest even) equals PyTorch's and XLA's bf16
// arithmetic (computed in f32, rounded to bf16). 1/det is an IEEE f32
// divide rounded once to bf16, as theirs; comparisons run on the exact f32
// widenings.
struct DfBf16 {
  static_assert(DF_R == 2, "the thread's two rays fill a bf16x2");
  static constexpr float kMiss = NR_BF16_MISS;
  struct Rays {
    __nv_bfloat162 ox, oy, oz, dx, dy, dz;
  };
  __device__ __forceinline__ static Rays rays(const DfRays& r) {
    return {__floats2bfloat162_rn(r.ox[0], r.ox[1]),
            __floats2bfloat162_rn(r.oy[0], r.oy[1]),
            __floats2bfloat162_rn(r.oz[0], r.oz[1]),
            __floats2bfloat162_rn(r.dx[0], r.dx[1]),
            __floats2bfloat162_rn(r.dy[0], r.dy[1]),
            __floats2bfloat162_rn(r.dz[0], r.dz[1])};
  }
  // df_stage<S>'s elements of this thread, each f32 value replaced by its
  // bf16 in both halves.
  template <class S>
  __device__ __forceinline__ static void prepare(float* tile) {
    for (int e = threadIdx.x; e < 9 * S::kChunk; e += S::kThreads) {
      const int row = e / S::kChunk;
      float* x = tile + (e - row * S::kChunk) * DF_TRI_STRIDE + row;
      *x = __uint_as_float(nr_b2u(__float2bfloat162_rn(*x)));
    }
  }
  // d x e2 and det, o - v0 and u·det of the triangle v = (v0, e1, e2), in
  // _mt_tile's order.
  __device__ __forceinline__ static void det_u(const Rays& r,
                                               const __nv_bfloat162 v[9],
                                               __nv_bfloat162 p[3],
                                               __nv_bfloat162 tv[3],
                                               __nv_bfloat162& det,
                                               __nv_bfloat162& u_num) {
    p[0] = nr_bsub(nr_bmul(r.dy, v[8]), nr_bmul(r.dz, v[7]));
    p[1] = nr_bsub(nr_bmul(r.dz, v[6]), nr_bmul(r.dx, v[8]));
    p[2] = nr_bsub(nr_bmul(r.dx, v[7]), nr_bmul(r.dy, v[6]));
    det = nr_badd(nr_badd(nr_bmul(v[3], p[0]), nr_bmul(v[4], p[1])),
                  nr_bmul(v[5], p[2]));
    tv[0] = nr_bsub(r.ox, v[0]);
    tv[1] = nr_bsub(r.oy, v[1]);
    tv[2] = nr_bsub(r.oz, v[2]);
    u_num = nr_badd(nr_badd(nr_bmul(tv[0], p[0]), nr_bmul(tv[1], p[1])),
                    nr_bmul(tv[2], p[2]));
  }
  // q = (o - v0) x e1 and v·det.
  __device__ __forceinline__ static void v_num(const Rays& r,
                                               const __nv_bfloat162 v[9],
                                               const __nv_bfloat162 tv[3],
                                               __nv_bfloat162 q[3],
                                               __nv_bfloat162& vn) {
    q[0] = nr_bsub(nr_bmul(tv[1], v[5]), nr_bmul(tv[2], v[4]));
    q[1] = nr_bsub(nr_bmul(tv[2], v[3]), nr_bmul(tv[0], v[5]));
    q[2] = nr_bsub(nr_bmul(tv[0], v[4]), nr_bmul(tv[1], v[3]));
    vn = nr_badd(nr_badd(nr_bmul(r.dx, q[0]), nr_bmul(r.dy, q[1])),
                 nr_bmul(r.dz, q[2]));
  }
  // The rest of both halves: t·det, 1/det, u, v, u + v, t and the culls;
  // t (kMiss where the pair is rejected) and det widened to f32.
  __device__ __forceinline__ static void finish(
      const __nv_bfloat162 v[9], const __nv_bfloat162 q[3],
      __nv_bfloat162 det, __nv_bfloat162 u_num, __nv_bfloat162 vn,
      float t[2], float det_out[2]) {
    const __nv_bfloat162 t_num =
        nr_badd(nr_badd(nr_bmul(v[6], q[0]), nr_bmul(v[7], q[1])),
                nr_bmul(v[8], q[2]));
    const float det0 = __low2float(det), det1 = __high2float(det);
    const bool ok0 = fabsf(det0) >= NR_BF16_EPS;
    const bool ok1 = fabsf(det1) >= NR_BF16_EPS;
    const __nv_bfloat162 inv = __floats2bfloat162_rn(
        1.0f / (ok0 ? det0 : 1.0f), 1.0f / (ok1 ? det1 : 1.0f));
    const __nv_bfloat162 u = nr_bmul(u_num, inv);
    const __nv_bfloat162 vv = nr_bmul(vn, inv);
    const __nv_bfloat162 upv = nr_badd(u, vv);
    const __nv_bfloat162 tt = nr_bmul(t_num, inv);
    const float uf[2] = {__low2float(u), __high2float(u)};
    const float vf[2] = {__low2float(vv), __high2float(vv)};
    const float sf[2] = {__low2float(upv), __high2float(upv)};
    const float tf[2] = {__low2float(tt), __high2float(tt)};
    const bool okd[2] = {ok0, ok1};
    det_out[0] = det0;
    det_out[1] = det1;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool ok = okd[i] && (uf[i] >= 0.0f) && (uf[i] <= 1.0f) &&
                      (vf[i] >= 0.0f) && (sf[i] <= 1.0f) &&
                      (tf[i] > NR_BF16_EPS) && (tf[i] > NR_BF16_MIN_T);
      t[i] = ok ? tf[i] : NR_BF16_MISS;
    }
  }
  // The rule on a widened packed numerator: true where it keeps the pair
  // (p: det and the bounds a (-2^-20), rn(a (1 + 2^-4))).
  __device__ __forceinline__ static bool keep(float num, const DfPair& p) {
    const float w = df_signed(num, p.det);
    return !((w < p.lo) | (w >= p.hi));
  }
  template <int kMode, class Fold>
  __device__ __forceinline__ static void triangle(const Rays& r,
                                                  const float4& a,
                                                  const float4& b,
                                                  const float4& c, int id,
                                                  Fold&& fold) {
    static_assert(kMode == 0, "the ablation runs ANY");
    const float x[9] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x};
    __nv_bfloat162 v[9], p[3], tv[3], q[3], det, un, vn;
#pragma unroll
    for (int k = 0; k < 9; ++k) v[k] = nr_u2b(__float_as_uint(x[k]));
    det_u(r, v, p, tv, det, un);
    DfPair s[2];
    s[0].det = __low2float(det);
    s[1].det = __high2float(det);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      s[i].lo = fabsf(s[i].det) * DF_LO;
      s[i].hi = fabsf(s[i].det) * DF_BF16_HI;
    }
    bool kept[2] = {keep(__low2float(un), s[0]),
                    keep(__high2float(un), s[1])};
    if (!__any_sync(0xffffffffu, kept[0] | kept[1])) return;
    v_num(r, v, tv, q, vn);
    kept[0] = kept[0] & keep(__low2float(vn), s[0]);
    kept[1] = kept[1] & keep(__high2float(vn), s[1]);
    if (!__any_sync(0xffffffffu, kept[0] | kept[1])) return;
    float t[2], det_out[2];
    finish(v, q, det, un, vn, t, det_out);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (kept[i]) fold(i, id, t[i], det_out[i]);
    }
  }
};

// probe: `_probe_tile`'s chain, x = a then x = x * a + b 24 times, with
// a = ox * v0x and b = dx + v0y: 48 dependent FP32 operations per pair,
// unfused. csrc/ablate_trace.cu's probe loop runs NR_PROBE_CHAINS
// triangles side by side so that independent chains hide the FP32
// latency, and keeps their minimum with fminf (NaN dropped; the twin uses
// torch.fmin's rule).
#define NR_PROBE_STEPS 24
#define NR_PROBE_CHAINS 8

struct NrRay {
  float ox, oy, oz, dx, dy, dz;
};

struct MtProbe {
  static constexpr float kMiss = NR_MISS;
  template <int W>
  __device__ __forceinline__ static float chains(const NrRay& r,
                                                 const float (*tile)[W],
                                                 int q, float best) {
    float a[NR_PROBE_CHAINS], b[NR_PROBE_CHAINS], x[NR_PROBE_CHAINS];
#pragma unroll
    for (int c = 0; c < NR_PROBE_CHAINS; ++c) {
      a[c] = r.ox * tile[0][q + c];
      b[c] = r.dx + tile[1][q + c];
      x[c] = a[c];
    }
#pragma unroll
    for (int s = 0; s < NR_PROBE_STEPS; ++s) {
#pragma unroll
      for (int c = 0; c < NR_PROBE_CHAINS; ++c) x[c] = x[c] * a[c] + b[c];
    }
#pragma unroll
    for (int c = 0; c < NR_PROBE_CHAINS; ++c) best = fminf(best, x[c]);
    return best;
  }
};
