// The sweep family of the trace-kernel ablation (replaces the TPU kernel
// neural_renderer_tpu/ops/trace_pallas.py::_sweep_kernel re-traced with the
// tile math of scripts/ablate_trace_kernel.py::_mt_tile patched in,
// run_sweep_family :182-263): K4's dense dual-shell sweep with the variants
// nodiv, recip, recipx and bf16 of csrc/mt_variants.cuh. K4 itself is
// sweep_dense.cu.
//
// The walk is K4's (csrc/mt_dense.cuh: 512-ray CTAs of 256 threads, two
// rays a thread, 64-triangle chunks in a cp.async double buffer, three
// 16-byte broadcast loads a triangle, triangle slices folded per ray),
// templated over the tile math. Each variant brings its prefilter: a rule
// in its own operations and precision on the det, u·det and v·det its pair
// math computes, which rejects only pairs that math certainly rejects, so
// every output equals the unfiltered loop's bit for bit
// (ops/trace_ablation.py::variant_rule is each rule on the CPU, held
// against the variants' twins by tests/test_torch_ablate_prefilter.py).
// With a = |det| and w = num sgn(det) for num = u·det or v·det:
//
//   recip: 1/det by __frcp_rn, the value of 1.0f / det: the pairs of
//     `local`, so mt_dense.cuh's rule and its proof (margins 2^-20).
//   recipx: 1/det by rcp.approx.ftz.f32: within 1 ulp (2^-23 relative)
//     of 1/det where that is a normal f32 (PTX ISA), and 0 where it is
//     subnormal (|det| > 2^126), where t = t·det x 0 fails t > 1e-8 and
//     the pair is rejected whatever the rule says. The rule rejects w <
//     a (-2^-18) or w >= rn(a (1 + 2^-18)), which covers a reciprocal
//     within 2^-19 of 1/det (16 ulps of 2^-23): for the first, |u| >=
//     2^-18 (1 - 2^-19)(1 - 2^-24), so u < 0; for the second, u·det / det
//     >= (1 + 2^-18)(1 - 2^-24), times (1 - 2^-19) above 1 + 2^-24, so u
//     rounds above 1 (and v > 1 with u >= 0 gives u + v > 1).
//   nodiv: its culls compare w with 0 and a themselves (us = u·det s with
//     s = sgn(det), exact), so the rule is those compares and needs no
//     margin: w < 0 or w > a rejects (v > a with us >= 0 gives
//     rn(us + vs) >= vs > a). No bound multiply.
//   bf16: det, u·det and v·det are the packed bf16 values of MtBf16's
//     operations (widened exactly to f32); 1/det is rn_bf16(rn_f32(1 /
//     det)), within 2^-5 of 1/det (2^-8 + 2^-24 where it is normal;
//     2^-134 + 2^-150 absolute, at least 2^-128 being subnormal). The rule
//     rejects w < a (-2^-20): u rounds from a product of magnitude above
//     2^-20 (1 - 2^-5) (1 - 2^-24) > 2^-134, so u < 0; or w >= rn(a (1 +
//     2^-4)): the product is at least 1.0625 (1 - 2^-24)(1 - 2^-5) > 1.029,
//     which rounds to at least 1.0234 in bf16, so u > 1.
//
// Padding (a = 0, u·det = v·det = 0) is rejected by every rule; |det| below
// 1e-8 may be rejected freely (every variant culls it); NaN fails every
// compare and is left to the pair math.
//
// bf16 runs the thread's two rays in the halves of each __nv_bfloat162
// (low ray 0, high ray 1) against one triangle, whose nine values the
// chunk's prepare() converts once, in place, to bf16x2 (the same rn of each
// f32 value as the per-pair conversion took). The packed operations are
// elementwise, so each pair's values equal MtBf16::pair2's.
//
// Bound (ops/bounds.py): the variant's operations per (ray, triangle) pair
// of the live blocks (46 for Möller–Trumbore, nodiv 47, bf16 45 packed and
// 3 at the FP32 rate) at the FP32 instruction rate (bf16 two per lane per
// clock); filtered, its rule's operations on every pair and the rest of its
// math on the pairs the rule leaves (bounds.dense_seconds with the
// variant's counts).
#include "mt_dense.cuh"
#include "mt_variants.cuh"

// recip: local's values, local's rule.
using SwRecip = DfMtRcp<NR_RCP_RN>;

#define SW_RCPX_LO (-3.814697265625e-06f)     // -2^-18
#define SW_RCPX_HI 1.000003814697265625f      // 1 + 2^-18
#define SW_BF16_HI 1.0625f                    // 1 + 2^-4

struct SwRecipx : DfScalar<SwRecipx> {
  __device__ __forceinline__ static void bounds(DfPair& p) {
    p.lo = fabsf(p.det) * SW_RCPX_LO;
    p.hi = fabsf(p.det) * SW_RCPX_HI;
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

struct SwNodiv : DfScalar<SwNodiv> {
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
    return MtNodiv::pair(NrRay{r.ox[i], r.oy[i], r.oz[i], r.dx[i], r.dy[i],
                               r.dz[i]},
                         a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, det);
  }
};

struct SwBf16 {
  static_assert(DF_R == 2, "the thread's two rays fill a bf16x2");
  using Rays = MtBf16::RayState;
  __device__ __forceinline__ static Rays rays(const DfRays& r) {
    return {__floats2bfloat162_rn(r.ox[0], r.ox[1]),
            __floats2bfloat162_rn(r.oy[0], r.oy[1]),
            __floats2bfloat162_rn(r.oz[0], r.oz[1]),
            __floats2bfloat162_rn(r.dx[0], r.dx[1]),
            __floats2bfloat162_rn(r.dy[0], r.dy[1]),
            __floats2bfloat162_rn(r.dz[0], r.dz[1])};
  }
  // df_stage's elements of this thread, each f32 value replaced by its
  // bf16 in both halves.
  __device__ __forceinline__ static void prepare(float* tile) {
    for (int e = threadIdx.x; e < 9 * DF_CHUNK; e += DF_THREADS) {
      const int row = e / DF_CHUNK;
      float* x = tile + (e - row * DF_CHUNK) * DF_TRI_STRIDE + row;
      *x = __uint_as_float(nr_b2u(__float2bfloat162_rn(*x)));
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
    static_assert(kMode == 0, "the sweeps run ANY");
    const float x[9] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x};
    __nv_bfloat162 v[9], p[3], tv[3], q[3], det, un, vn;
#pragma unroll
    for (int k = 0; k < 9; ++k) v[k] = nr_u2b(__float_as_uint(x[k]));
    MtBf16::det_u(r, v, p, tv, det, un);
    DfPair s[2];
    s[0].det = __low2float(det);
    s[1].det = __high2float(det);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      s[i].lo = fabsf(s[i].det) * DF_LO;
      s[i].hi = fabsf(s[i].det) * SW_BF16_HI;
    }
    bool kept[2] = {keep(__low2float(un), s[0]),
                    keep(__high2float(un), s[1])};
    if (!__any_sync(0xffffffffu, kept[0] | kept[1])) return;
    MtBf16::v_num(r, v, tv, q, vn);
    kept[0] = kept[0] & keep(__low2float(vn), s[0]);
    kept[1] = kept[1] & keep(__high2float(vn), s[1]);
    if (!__any_sync(0xffffffffu, kept[0] | kept[1])) return;
    float t[2], det_out[2];
    MtBf16::finish(v, q, det, un, vn, t, det_out);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (kept[i]) fold(i, id, t[i], det_out[i]);
    }
  }
};

// The launch shape the wrapper allocates for (df_sweep_shape).
extern "C" int ablate_sweep_shape(int npad, int ttot, int* slices,
                                  long long* scratch_doubles) {
  return df_sweep_shape(npad, ttot, slices, scratch_doubles);
}

// Variant codes of ops/trace_ablation.py::VARIANT_CODES. part: [slices][5
// or 4][npad] f32 scratch (unused with one slice).
extern "C" int ablate_sweep(int variant, const float* o, const float* d,
                            int npad, const float* tris, int ttot,
                            int outer_cols, const int* block_mask,
                            int with_fwd2, int slices, float* part,
                            float* out, cudaStream_t stream) {
  switch (variant) {
    case 2:
      return df_sweep_launch<SwRecip>(o, d, npad, tris, ttot, outer_cols,
                                      block_mask, with_fwd2, slices, part,
                                      out, stream);
    case 3:
      return df_sweep_launch<SwRecipx>(o, d, npad, tris, ttot, outer_cols,
                                       block_mask, with_fwd2, slices, part,
                                       out, stream);
    case 4:
      return df_sweep_launch<SwNodiv>(o, d, npad, tris, ttot, outer_cols,
                                      block_mask, with_fwd2, slices, part,
                                      out, stream);
    case 5:
      return df_sweep_launch<SwBf16>(o, d, npad, tris, ttot, outer_cols,
                                     block_mask, with_fwd2, slices, part,
                                     out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

NR_ERROR_STRING_ENTRY
