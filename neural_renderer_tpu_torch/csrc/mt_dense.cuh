// The FP32 walk of the dense kernels K3 (trace_dense.cu) and K4
// (sweep_dense.cu): every ray against every triangle, in FP32
// Möller–Trumbore behind a prefilter. Their launch shape and the fold of
// triangle slices are dense_slices.cuh's. The walk and K4's sweep are
// templates over the tile math (DfMt below), and the walk over its shape
// (DfShape), so that the trace-kernel ablation (ablate_trace.cu,
// ablate_sweep.cu; its tile maths in mt_variants.cuh) runs the same walk
// with its own pair math, prefilter rules, CTAs and chunks.
//
// A CTA of S::kThreads threads takes S::kRays rays, DF_R rays a thread:
// rays ray0 + i S::kThreads + tid, so a warp holds 32 neighbouring rays.
// Where a kernel reads skip flags, a CTA lies in one 512-ray skip block
// (the flag is read at ray0 / 512, so it keeps its meaning). Triangles are
// staged S::kChunk at a time from their [9, T] rows by 4-byte cp.async
// into a triangle-major tile (12 floats a triangle: v0, e1, e2, three
// unused) in a double buffer; a pair reads its triangle as three 16-byte
// broadcast loads, and the thread runs them against its DF_R rays. A
// chunk whose triangles all have e1 = 0 (the padding: det = 0 or NaN for
// every ray, so nr_mt_t misses) is skipped whole.
//
// K3's and K4's shape (DfDense): 256 threads of two rays, 64-triangle
// chunks, 16 CTAs per SM for a one-slice launch. A design sweep of other
// values (PERF.md) found none more than 5% faster on every dense case;
// without the prefilter the walk took 1.6-2.3x as long, with u and v
// tested together on every pair 1.2-1.4x, with one ray a thread
// 1.04-1.12x.
//
// Prefilter (df_face, df_keep_u, df_keep_v). Möller–Trumbore's divide and
// its second half only serve the pairs that can hit, and a ray meets the
// parallelogram of a few of the mesh's triangles. Each pair first computes
// det in nr_mt_t's operation order, so with the same value. In
// FORWARD_ONLY and BACKWARD_ONLY det's sign decides the facing, and a
// triangle that faces none of the warp's rays ends there; else (in ANY,
// always) u·det the same way, tested without a branch; for each of the
// thread's rays where some lane still keeps its pair, v·det; where some
// lane still keeps one, the lanes that do run nr_mt_t itself (so t and
// det are the twin's) and fold it. One facing vote for all the thread's
// rays measured faster than none on long launches and than one a ray on
// every launch (PERF.md). A rejected pair would fold t = 1e30,
// which changes no accumulator. The rule, all in f32, with a = |det|,
// num = u·det or v·det, w = num with its sign flipped where det's sign bit
// is set (so w = num sgn(det)); nr_mt_t takes u = rn(num rn(1/det)) and
// rejects a pair unless a >= 1e-8 (and t > 1e-8, so a pair with det = inf,
// where t is 0 or NaN, too). The rule rejects a pair where
//   FORWARD_ONLY !(det > 0), BACKWARD_ONLY !(det < 0): the facing cull,
//     exact with no margin;
//   w < a (-2^-20) (exact for a >= 1e-8): num and det differ in sign and
//     |num| / a > 2^-20; rn(1/det) is within 2^-22 of 1/det (2^-24 where
//     it is normal, 2^-150 absolute where it is subnormal, a > 2^126), so
//     the quotient rounds to below -2^-21, not to -0.0: u < 0, or v < 0;
//   w >= rn(a (1 + 2^-20)): num has det's sign and |num| / a >=
//     (1 + 2^-20)(1 - 2^-24), so the quotient rounds to at least
//     (1 + 2^-20)(1 - 2^-24)(1 - 2^-22)(1 - 2^-24) > 1 + 2^-23: u > 1, or
//     v > 1 where u >= 0 makes rn(u + v) > 1 (a(1 + 2^-20) overflowing to
//     inf leaves only num = inf, whose quotient is inf).
// a < 1e-8 (padding: a = 0, where w >= 0 = a (1 + 2^-20) or w < -0) may
// be rejected freely; NaN fails every compare and is left to nr_mt_t.
// ops/trace_pallas.py::dense_rule is the same rule on the CPU, held
// against the twin by tests/test_torch_dense_prefilter.py.
#pragma once

#include "dense_slices.cuh"

#define DF_R 2             // rays per thread
#define DF_CTAS_PER_SM 16  // a one-slice K3 / K4 launch's CTAs an SM, at least
#define DF_TRI_STRIDE 12   // floats per triangle in the tile

// A walk's shape: CTAs of kThreads threads (kRays rays), triangles staged
// kChunk at a time (each half of the double buffer kBuf floats).
template <int kThreads_, int kChunk_>
struct DfShape {
  static constexpr int kThreads = kThreads_;
  static constexpr int kChunk = kChunk_;
  static constexpr int kRays = kThreads_ * DF_R;
  static constexpr int kBuf = kChunk_ * DF_TRI_STRIDE;
};
using DfDense = DfShape<256, 64>;  // K3's and K4's

#define DF_LO (-9.5367431640625e-07f)      // -2^-20
#define DF_HI 1.00000095367431640625f       // 1 + 2^-20

// The rays of a thread.
struct DfRays {
  float ox[DF_R], oy[DF_R], oz[DF_R], dx[DF_R], dy[DF_R], dz[DF_R];
};

// The thread's ray i of the CTA of shape S starting at ray0.
template <class S>
__device__ __forceinline__ long long df_ray(long long ray0, int i) {
  return ray0 + (long long)i * S::kThreads + threadIdx.x;
}

template <class S>
__device__ __forceinline__ void df_load(const float* __restrict__ o,
                                        const float* __restrict__ d,
                                        int npad, long long ray0,
                                        DfRays& r) {
#pragma unroll
  for (int i = 0; i < DF_R; ++i) {
    const long long q = df_ray<S>(ray0, i);
    r.ox[i] = o[q];
    r.oy[i] = o[npad + q];
    r.oz[i] = o[2LL * npad + q];
    r.dx[i] = d[q];
    r.dy[i] = d[npad + q];
    r.dz[i] = d[2LL * npad + q];
  }
}

// A pair's prefilter state: det, the rule's bounds a (-2^-20) and
// rn(a (1 + 2^-20)), o - v0.
struct DfPair {
  float det, lo, hi, tx, ty, tz;
};

// num sgn(det): num with its sign flipped where det's sign bit is set.
__device__ __forceinline__ float df_signed(float num, float det) {
  return __int_as_float(__float_as_int(num) ^
                        (__float_as_int(det) & 0x80000000));
}

// The rule's test of one numerator (u·det or v·det): true where rule R
// rejects the pair. FORWARD_ONLY keeps only det > 0 and BACKWARD_ONLY
// det < 0, so there w is num and -num.
template <int kMode, class R>
__device__ __forceinline__ bool df_out(float num, const DfPair& p) {
  float w;
  if constexpr (kMode == 1) {
    w = num;
  } else if constexpr (kMode == 2) {
    w = -num;
  } else {
    w = df_signed(num, p.det);
  }
  return R::out(w, p);
}

// The rule's second test: v·det in nr_mt_t's order.
template <int kMode, class R>
__device__ __forceinline__ bool df_keep_v(const DfRays& r, int i,
                                          const float4& a, const float4& b,
                                          const DfPair& p) {
  const float qx = p.ty * b.y - p.tz * b.x;
  const float qy = p.tz * a.w - p.tx * b.y;
  const float qz = p.tx * b.x - p.ty * a.w;
  const float vn = r.dx[i] * qx + r.dy[i] * qy + r.dz[i] * qz;
  return !df_out<kMode, R>(vn, p);
}

// det of ray i and the triangle (a, b, c) = (v0x v0y v0z e1x | e1y e1z e2x
// e2y | e2z ...) in nr_mt_t's order, into p.det; returns d x e2.
__device__ __forceinline__ float3 df_det(const DfRays& r, int i,
                                         const float4& a, const float4& b,
                                         const float4& c, DfPair& p) {
  const float3 pv = make_float3(r.dy[i] * c.x - r.dz[i] * b.w,
                                r.dz[i] * b.z - r.dx[i] * c.x,
                                r.dx[i] * b.w - r.dy[i] * b.z);
  p.det = a.w * pv.x + b.x * pv.y + b.y * pv.z;
  return pv;
}

// The rule's facing test: det's sign in FORWARD_ONLY and BACKWARD_ONLY.
template <int kMode>
__device__ __forceinline__ bool df_face(const DfPair& p) {
  if constexpr (kMode == 1) return p.det > 0.0f;
  if constexpr (kMode == 2) return p.det < 0.0f;
  return true;
}

// The rule's u test: u·det in nr_mt_t's order from d x e2 and rule R's
// bounds. Writes the pair's state for the v test.
template <int kMode, class R>
__device__ __forceinline__ bool df_keep_u(const DfRays& r, int i,
                                          const float4& a, const float3& pv,
                                          DfPair& p) {
  p.tx = r.ox[i] - a.x;
  p.ty = r.oy[i] - a.y;
  p.tz = r.oz[i] - a.z;
  const float un = p.tx * pv.x + p.ty * pv.y + p.tz * pv.z;
  R::bounds(p);
  return !df_out<kMode, R>(un, p);
}

// Start the copies of chunk c (S::kChunk triangles) of the [9, total]
// triangle rows into `dst`.
template <class S>
__device__ __forceinline__ void df_stage(float* dst,
                                         const float* __restrict__ tris,
                                         long long total, int c) {
  const long long col0 = (long long)c * S::kChunk;
  for (int e = threadIdx.x; e < 9 * S::kChunk; e += S::kThreads) {
    const int row = e / S::kChunk;
    const int col = e - row * S::kChunk;
    nr_cp_async4(dst + col * DF_TRI_STRIDE + row,
                 tris + row * total + col0 + col);
  }
}

// Whether any e1 component this thread staged into `tile` (df_stage's
// elements, visible to it once its copies are waited for) is nonzero.
template <class S>
__device__ __forceinline__ bool df_staged_e1(const float* tile) {
  bool live = false;
  for (int e = threadIdx.x; e < 9 * S::kChunk; e += S::kThreads) {
    const int row = e / S::kChunk;
    const int col = e - row * S::kChunk;
    if (row >= 3 && row < 6) live |= tile[col * DF_TRI_STRIDE + row] != 0.0f;
  }
  return live;
}

// One triangle (a, b, c) against the thread's rays: rule R's prefilter
// and, where some lane's pair may pass, R::pair on the lane's kept pairs
// into fold(i, id, t, det). The v test runs ray by ray, only where some
// lane of the warp keeps that ray's pair: on incoherent rays a warp's u
// test passes for one of its rays far more often than for a given one.
template <int kMode, class R, class Fold>
__device__ __forceinline__ void df_triangle(const DfRays& r, const float4& a,
                                            const float4& b, const float4& c,
                                            int id, Fold&& fold) {
  bool keep[DF_R];
  DfPair p[DF_R];
  float3 pv[DF_R];
  bool any = false;
#pragma unroll
  for (int i = 0; i < DF_R; ++i) {
    pv[i] = df_det(r, i, a, b, c, p[i]);
    keep[i] = df_face<kMode>(p[i]);
    any |= keep[i];
  }
  // In FORWARD_ONLY and BACKWARD_ONLY, no facing pair in the warp: done.
  if (kMode != 0 && !__any_sync(0xffffffffu, any)) return;
  any = false;
#pragma unroll
  for (int i = 0; i < DF_R; ++i) {
    keep[i] = keep[i] & df_keep_u<kMode, R>(r, i, a, pv[i], p[i]);
    any |= keep[i];
  }
  if (!__any_sync(0xffffffffu, any)) return;
  any = false;
#pragma unroll
  for (int i = 0; i < DF_R; ++i) {
    if (__any_sync(0xffffffffu, keep[i]))
      keep[i] = keep[i] & df_keep_v<kMode, R>(r, i, a, b, p[i]);
    any |= keep[i];
  }
  if (!__any_sync(0xffffffffu, any)) return;
#pragma unroll
  for (int i = 0; i < DF_R; ++i) {
    if (keep[i]) {
      float det;
      const float t = R::pair(r, i, a, b, c, &det);
      fold(i, id, t, det);
    }
  }
}

// The walk's tile math M (df_walk's template argument): K3's and K4's is
// DfMt, nr_mt_t behind the rule above; the trace-kernel ablation's
// variants bring their own (csrc/mt_variants.cuh). M gives the walk
//   kMiss               its miss value (a rejected pair's t);
//   Rays, rays(DfRays)  what a thread keeps of its DF_R rays;
//   prepare<S>(tile)    run by each thread on the chunk elements it staged
//                       (df_stage<S>'s), once they have landed and before
//                       the chunk's barrier;
//   triangle<kMode>(rays, a, b, c, id, fold)  one triangle against them.
// A scalar math R (DfScalar<R>) runs df_triangle with its rule and pair:
//   bounds(p)           the rule's bounds on a numerator, from p.det;
//   out(w, p)           true where w = num sgn(det) rejects the pair;
//   pair(r, i, a, b, c, &det)  t (kMiss, 1e30, where the pair is
//                       rejected) and det.
template <class R>
struct DfScalar {
  static constexpr float kMiss = NR_MISS;
  using Rays = DfRays;
  __device__ __forceinline__ static DfRays rays(const DfRays& r) {
    return r;
  }
  template <class S>
  __device__ __forceinline__ static void prepare(float*) {}
  template <int kMode, class Fold>
  __device__ __forceinline__ static void triangle(const DfRays& r,
                                                  const float4& a,
                                                  const float4& b,
                                                  const float4& c, int id,
                                                  Fold&& fold) {
    df_triangle<kMode, R>(r, a, b, c, id, fold);
  }
};

// Möller–Trumbore with 1/det by nr_rcp<kRcp> behind the rule above: K3's
// and K4's (NR_RCP_DIV) and the ablation's `recip` (NR_RCP_RN, the same
// values).
template <int kRcp>
struct DfMtRcp : DfScalar<DfMtRcp<kRcp>> {
  __device__ __forceinline__ static void bounds(DfPair& p) {
    p.lo = fabsf(p.det) * DF_LO;
    p.hi = fabsf(p.det) * DF_HI;
  }
  __device__ __forceinline__ static bool out(float w, const DfPair& p) {
    return (w < p.lo) | (w >= p.hi);
  }
  __device__ __forceinline__ static float pair(const DfRays& r, int i,
                                               const float4& a,
                                               const float4& b,
                                               const float4& c, float* det) {
    return nr_mt_t<kRcp>(r.ox[i], r.oy[i], r.oz[i], r.dx[i], r.dy[i],
                         r.dz[i], a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                         c.x, det);
  }
};
using DfMt = DfMtRcp<NR_RCP_DIV>;

// Walk chunks [c0, c1) of the triangles in a CTA of shape S (`buf`: 2
// S::kBuf floats): stage chunk c + 1 into the other half of `buf` while
// chunk c is swept; for each triangle M's prefilter on each of the
// thread's rays and, where some lane's pair may pass, M's pair math on the
// lane's kept pairs into fold(i, triangle id, t, det). A thread visits its
// triangles in increasing id.
template <int kMode, class M = DfMt, class S = DfDense, class Fold>
__device__ __forceinline__ void df_walk(const float* __restrict__ tris,
                                        int ttot, int c0, int c1,
                                        const typename M::Rays& r,
                                        float* buf, Fold&& fold) {
  if (c0 < c1) {
    df_stage<S>(buf, tris, ttot, c0);
    nr_cp_async_commit();
  }
  for (int c = c0; c < c1; ++c) {
    if (c + 1 < c1) {
      // The other half was last read before the previous chunk's barrier.
      df_stage<S>(buf + ((c + 1 - c0) & 1) * S::kBuf, tris, ttot, c + 1);
      nr_cp_async_commit();
      nr_cp_async_wait<1>();
    } else {
      nr_cp_async_wait<0>();
    }
    float* cur = buf + ((c - c0) & 1) * S::kBuf;
    const bool live = df_staged_e1<S>(cur);
    M::template prepare<S>(cur);
    // Chunk c has landed for every thread; skip it if it is padding.
    if (!__syncthreads_or(live)) continue;
    const float4* tile = reinterpret_cast<const float4*>(cur);
    const int base = c * S::kChunk;
#pragma unroll 2
    for (int j = 0; j < S::kChunk; ++j)
      M::template triangle<kMode>(r, tile[3 * j], tile[3 * j + 1],
                                  tile[3 * j + 2], base + j, fold);
    __syncthreads();  // chunk c consumed before chunk c + 2 lands on it
  }
}

// ---- The dense dual-shell sweep over tile math M: K4 (sweep_dense.cu, M =
// DfMt) and the ablation's sweep variants (ablate_sweep.cu).
//
// tris = [outer | inner], each shell padded to whole 256-triangle tiles with
// zero triangles that the det cull rejects, so a 64-triangle chunk never
// straddles the two shells. Per ray the rows outer_fwd, outer_bwd,
// inner_fwd, inner_bwd[, outer_fwd2]: outer pairs fold into the strict
// forward pair (m1f, m2f) and the backward min, inner pairs into the two
// mins; forward is det > 0, backward det < 0 (facing = -det). Rays of a
// 512-ray block whose skip flag is 0 get 1e30 in every row. Each thread
// folds its DF_R rays' pairs that the prefilter leaves, and with more than
// one triangle slice nr_dense_fold merges the slices' partial rows per ray.
// The strict pair and the mins are selections over the multiset of t's, so
// no grouping changes them, and a rejected pair's t (1e30, or a variant's
// miss value above it) changes no accumulator. The kernel keeps K4's name,
// which the profiler filters of scripts/compare_trace_cluster_kernels.py
// match.
template <bool kFwd2, class M>
__global__ void __launch_bounds__(DfDense::kThreads)
sweep_dense_kernel(const float* __restrict__ o,
                   const float* __restrict__ d, int npad,
                   const float* __restrict__ tris, int ttot, int outer_cols,
                   const int* __restrict__ block_mask, int slices,
                   float* __restrict__ out) {
  using S = DfDense;
  static_assert(NR_SKIP_RAYS % S::kRays == 0, "a CTA in one skip block");
  constexpr int kRows = kFwd2 ? 5 : 4;
  __shared__ __align__(16) float buf[2 * S::kBuf];
  const long long ray0 = (long long)blockIdx.x * S::kRays;
  const int s = blockIdx.y;
  if (block_mask[ray0 / NR_SKIP_RAYS] == 0) {  // uniform across the CTA
    if (slices == 1) {
#pragma unroll
      for (int i = 0; i < DF_R; ++i) {
        for (int row = 0; row < kRows; ++row)
          out[(long long)row * npad + df_ray<S>(ray0, i)] = NR_MISS;
      }
    }
    return;  // with slices the fold writes the miss
  }
  DfRays r;
  df_load<S>(o, d, npad, ray0, r);
  float m1f[DF_R], m2f[DF_R], m1b[DF_R], i1f[DF_R], i1b[DF_R];
#pragma unroll
  for (int i = 0; i < DF_R; ++i)
    m1f[i] = m2f[i] = m1b[i] = i1f[i] = i1b[i] = NR_MISS;
  const int nchunks = ttot / S::kChunk;
  df_walk<0, M, S>(tris, ttot, nr_slice_chunk(s, nchunks, slices),
                nr_slice_chunk(s + 1, nchunks, slices), M::rays(r), buf,
                [&](int i, int id, float t, float det) {
                  if (id < outer_cols) {  // uniform across the chunk
                    nr_sweep_outer(kFwd2, t, det, m1f[i], m2f[i], m1b[i]);
                  } else {
                    nr_sweep_inner(t, det, i1f[i], i1b[i]);
                  }
                });
  float* dst = out + (long long)s * kRows * npad;  // a slice's partial rows
#pragma unroll
  for (int i = 0; i < DF_R; ++i) {
    const long long q = df_ray<S>(ray0, i);
    dst[q] = m1f[i];
    dst[npad + q] = m1b[i];
    dst[2LL * npad + q] = i1f[i];
    dst[3LL * npad + q] = i1b[i];
    if (kFwd2) dst[4LL * npad + q] = m2f[i];
  }
}

// The sweep's launch shape (nr_dense_slices); the walk needs no scratch
// beyond the partial rows.
static inline int df_sweep_shape(int npad, int ttot, int* slices,
                                 long long* scratch_doubles) {
  *scratch_doubles = 0;
  return nr_dense_slices(npad, ttot, DfDense::kRays, DfDense::kChunk,
                         DF_CTAS_PER_SM, slices);
}

// Launch the sweep over tile math M and, with slices, its fold. part:
// [slices][5 or 4][npad] f32 scratch (unused with one slice). T and
// outer_cols must be multiples of the 64-triangle chunk.
template <class M>
int df_sweep_launch(const float* o, const float* d, int npad,
                    const float* tris, int ttot, int outer_cols,
                    const int* block_mask, int with_fwd2, int slices,
                    float* part, float* out, cudaStream_t stream) {
  using S = DfDense;
  if (ttot % S::kChunk != 0 || outer_cols % S::kChunk != 0 || slices < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (npad / S::kRays == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(npad / S::kRays, slices);
  float* dst = slices == 1 ? out : part;
  if (with_fwd2) {
    sweep_dense_kernel<true, M><<<grid, S::kThreads, 0, stream>>>(
        o, d, npad, tris, ttot, outer_cols, block_mask, slices, dst);
    nr_dense_fold_launch<5>(part, npad, slices, block_mask, out, stream);
  } else {
    sweep_dense_kernel<false, M><<<grid, S::kThreads, 0, stream>>>(
        o, d, npad, tris, ttot, outer_cols, block_mask, slices, dst);
    nr_dense_fold_launch<4>(part, npad, slices, block_mask, out, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
