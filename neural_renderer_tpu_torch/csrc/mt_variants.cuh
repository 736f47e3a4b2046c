// Tile-math variants of Möller–Trumbore for the trace-kernel ablation
// (ops/trace_ablation.py; scripts/ablate_trace_kernel.py::_mt_tile :47-97
// and _probe_tile :100 of the reference). Each variant is a struct the
// templated trace loop takes (csrc/ablate_trace.cu; the sweep variants,
// csrc/ablate_sweep.cu, take their pair math from here too):
//
//   RayState         what a thread keeps of its ray;
//   ray(NrRay)       builds it once per ray;
//   pair2(...)       t and det of the ray against tile columns q and q+1,
//                    t = kMiss where the pair is rejected (every cull but
//                    facing); det's sign carries the facing;
//   kMiss            the miss value (bf16's 1e30 in MtBf16);
//   kProbe           true for the op-rate probe, which has no hit.
//
// Built with -fmad=false (ops/cuda_build.py): no product is fused into an
// add, so every variant rounds op by op like its PyTorch twin.
#pragma once

#include <cuda_bf16.h>

#include "mt.cuh"

struct NrRay {
  float ox, oy, oz, dx, dy, dz;
};

// bf16(1e30), bf16(1e-8) and bf16(1e-6) widened to f32: the reference's
// constants under JAX's weak typing in the bf16 variant.
#define NR_BF16_MISS 1.00025555e30f
#define NR_BF16_EPS 1.00117177e-8f
#define NR_BF16_MIN_T 9.983778e-7f

// Scalar variants evaluate one pair at a time; pair2 runs columns q, q+1.
template <class Derived>
struct NrScalarMath {
  using RayState = NrRay;
  static constexpr bool kProbe = false;
  static constexpr float kMiss = NR_MISS;
  __device__ __forceinline__ static NrRay ray(const NrRay& r) { return r; }
  template <int W>
  __device__ __forceinline__ static void pair2(const NrRay& r,
                                               const float (*tile)[W], int q,
                                               float t[2], float det[2]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      t[i] = Derived::pair(r, tile[0][q + i], tile[1][q + i], tile[2][q + i],
                           tile[3][q + i], tile[4][q + i], tile[5][q + i],
                           tile[6][q + i], tile[7][q + i], tile[8][q + i],
                           &det[i]);
    }
  }
};

// local: the production math, nr_mt_t itself; recip and recipx take 1/det
// by __frcp_rn (the value of 1.0f/det) and by rcp.approx.ftz.f32.
template <int kRcp>
struct MtRcp : NrScalarMath<MtRcp<kRcp>> {
  __device__ __forceinline__ static float pair(
      const NrRay& r, float v0x, float v0y, float v0z, float e1x, float e1y,
      float e1z, float e2x, float e2y, float e2z, float* det) {
    return nr_mt_t<kRcp>(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, v0x, v0y, v0z,
                         e1x, e1y, e1z, e2x, e2y, e2z, det);
  }
};
using MtLocal = MtRcp<NR_RCP_DIV>;
using MtRecip = MtRcp<NR_RCP_RN>;
using MtRecipx = MtRcp<NR_RCP_APPROX>;

// nodiv: the barycentric culls compare u_num and v_num, times det's sign,
// with |det| (_mt_tile :73-85); one IEEE divide gives t.
struct MtNodiv : NrScalarMath<MtNodiv> {
  __device__ __forceinline__ static float pair(
      const NrRay& r, float v0x, float v0y, float v0z, float e1x, float e1y,
      float e1z, float e2x, float e2y, float e2z, float* det_out) {
    float px = r.dy * e2z - r.dz * e2y;
    float py = r.dz * e2x - r.dx * e2z;
    float pz = r.dx * e2y - r.dy * e2x;
    float det = e1x * px + e1y * py + e1z * pz;
    *det_out = det;
    float tx = r.ox - v0x;
    float ty = r.oy - v0y;
    float tz = r.oz - v0z;
    float u_num = tx * px + ty * py + tz * pz;
    float qx = ty * e1z - tz * e1y;
    float qy = tz * e1x - tx * e1z;
    float qz = tx * e1y - ty * e1x;
    float v_num = r.dx * qx + r.dy * qy + r.dz * qz;
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
// __nv_bfloat162: here two triangles per step (low half column q, high half
// q+1); the sweep variant (csrc/ablate_sweep.cu) packs two rays against one
// triangle, in the same operations. Products of bf16 values are exact in f32
// and a sum of two rounds once, so each packed operation (round to nearest
// even) equals PyTorch's and XLA's bf16 arithmetic (computed in f32,
// rounded to bf16). 1/det is an IEEE f32 divide rounded once to bf16, as
// theirs; comparisons run on the exact f32 widenings.
struct MtBf16 {
  struct RayState {
    __nv_bfloat162 ox, oy, oz, dx, dy, dz;
  };
  static constexpr bool kProbe = false;
  static constexpr float kMiss = NR_BF16_MISS;
  __device__ __forceinline__ static RayState ray(const NrRay& r) {
    return {__float2bfloat162_rn(r.ox), __float2bfloat162_rn(r.oy),
            __float2bfloat162_rn(r.oz), __float2bfloat162_rn(r.dx),
            __float2bfloat162_rn(r.dy), __float2bfloat162_rn(r.dz)};
  }
  // d x e2 and det, o - v0 and u·det of the triangle v = (v0, e1, e2), in
  // _mt_tile's order.
  __device__ __forceinline__ static void det_u(const RayState& r,
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
  __device__ __forceinline__ static void v_num(const RayState& r,
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
  template <int W>
  __device__ __forceinline__ static void pair2(const RayState& r,
                                               const float (*tile)[W], int q,
                                               float t[2], float det_out[2]) {
    __nv_bfloat162 v[9], p[3], tv[3], qv[3], det, u_num, vn;
#pragma unroll
    for (int k = 0; k < 9; ++k)
      v[k] = __floats2bfloat162_rn(tile[k][q], tile[k][q + 1]);
    det_u(r, v, p, tv, det, u_num);
    v_num(r, v, tv, qv, vn);
    finish(v, qv, det, u_num, vn, t, det_out);
  }
};

// probe: `_probe_tile`'s chain, x = a then x = x * a + b 24 times, with
// a = ox * v0x and b = dx + v0y: 48 dependent FP32 operations per pair,
// unfused. The trace loop runs NR_PROBE_CHAINS triangles side by side so
// that independent chains hide the FP32 latency, and keeps their minimum
// with fminf (NaN dropped; the twin uses torch.fmin's rule).
#define NR_PROBE_STEPS 24
#define NR_PROBE_CHAINS 8
struct MtProbe {
  using RayState = NrRay;
  static constexpr bool kProbe = true;
  static constexpr float kMiss = NR_MISS;
  __device__ __forceinline__ static NrRay ray(const NrRay& r) { return r; }
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
