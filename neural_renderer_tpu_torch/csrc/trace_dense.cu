// Dense closest-hit trace (replaces the TPU kernel
// neural_renderer_tpu/ops/trace_pallas.py::_kernel).
//
// Per ray the closest hit (t, the smallest id among equal t) of [3, Npad]
// rays against [9, T] triangles, TraceMode 0 ANY, 1 FORWARD_ONLY (det > 0),
// 2 BACKWARD_ONLY (det < 0); rays of a 512-ray block whose skip flag is 0
// report a miss with id 0 without touching a triangle.
//
// The FP32 walk of csrc/mt_dense.cuh: 512-ray CTAs (DfDense) x triangle
// slices, each thread keeping the best (t, id) of its DF_R rays (a strict < over
// increasing ids keeps the smallest id among equal t, as the TPU kernel's
// min-over-lanes does), the prefilter skipping Möller–Trumbore's divide
// and second half on pairs that certainly miss; with more than one slice,
// nr_dense_fold merges the slices' partial rows per ray by (t, id).
//
// Bound (ops/bounds.py): FP32 operations, 46 per (ray, triangle) pair of
// the live blocks without a prefilter; with it, det on every pair, the
// prefilter's u test on the pairs its facing test leaves, its v test on
// the pairs the u test leaves, and the rest of Möller–Trumbore on the
// pairs the v test leaves (ops/trace_pallas.py::prefilter_pairs).
#include "mt_dense.cuh"

template <int kMode>
__global__ void __launch_bounds__(DfDense::kThreads)
trace_dense_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   int npad, const float* __restrict__ tris, int ttot,
                   const int* __restrict__ block_mask, int slices,
                   float* __restrict__ out) {
  using S = DfDense;
  static_assert(NR_SKIP_RAYS % S::kRays == 0, "a CTA in one skip block");
  __shared__ __align__(16) float buf[2 * S::kBuf];
  const long long ray0 = (long long)blockIdx.x * S::kRays;
  const int s = blockIdx.y;
  if (block_mask[ray0 / NR_SKIP_RAYS] == 0) {  // uniform across the CTA
    if (slices == 1) {
#pragma unroll
      for (int i = 0; i < DF_R; ++i) {
        out[df_ray<S>(ray0, i)] = NR_MISS;
        out[npad + df_ray<S>(ray0, i)] = __int_as_float(0);
      }
    }
    return;  // with slices the fold writes the miss
  }
  DfRays r;
  df_load<S>(o, d, npad, ray0, r);
  float bt[DF_R];
  int bi[DF_R];
#pragma unroll
  for (int i = 0; i < DF_R; ++i) {
    bt[i] = NR_MISS;
    bi[i] = 0;
  }
  const int nchunks = ttot / S::kChunk;
  df_walk<kMode, DfMt, S>(tris, ttot, nr_slice_chunk(s, nchunks, slices),
                 nr_slice_chunk(s + 1, nchunks, slices), r, buf,
                 [&](int i, int id, float t, float det) {
                   if (kMode == 1 && !(det > 0.0f)) t = NR_MISS;
                   if (kMode == 2 && !(det < 0.0f)) t = NR_MISS;
                   if (t < bt[i]) {
                     bt[i] = t;
                     bi[i] = id;
                   }
                 });
  float* dst = out + (long long)s * 2 * npad;  // a slice's partial rows
#pragma unroll
  for (int i = 0; i < DF_R; ++i) {
    dst[df_ray<S>(ray0, i)] = bt[i];
    dst[npad + df_ray<S>(ray0, i)] = __int_as_float(bi[i]);
  }
}

// The launch shape the wrapper allocates for (nr_dense_slices); the walk
// needs no scratch beyond the partial rows.
extern "C" int trace_dense_shape(int npad, int ttot, int* slices,
                                 long long* scratch_doubles) {
  *scratch_doubles = 0;
  return nr_dense_slices(npad, ttot, DfDense::kRays, DfDense::kChunk,
                         DF_CTAS_PER_SM, slices);
}

// part: [slices][2][npad] f32 scratch (unused with one slice). T must be a
// multiple of the 64-triangle chunk.
extern "C" int trace_dense(const float* o, const float* d, int npad,
                           const float* tris, int ttot, const int* block_mask,
                           int mode, int slices, float* part, float* out,
                           cudaStream_t stream) {
  using S = DfDense;
  if (ttot % S::kChunk != 0 || slices < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ctas = npad / S::kRays;
  if (ctas == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(ctas, slices);
  float* dst = slices == 1 ? out : part;
  if (mode == 1) {
    trace_dense_kernel<1><<<grid, S::kThreads, 0, stream>>>(
        o, d, npad, tris, ttot, block_mask, slices, dst);
  } else if (mode == 2) {
    trace_dense_kernel<2><<<grid, S::kThreads, 0, stream>>>(
        o, d, npad, tris, ttot, block_mask, slices, dst);
  } else {
    trace_dense_kernel<0><<<grid, S::kThreads, 0, stream>>>(
        o, d, npad, tris, ttot, block_mask, slices, dst);
  }
  nr_dense_fold_launch<2>(part, npad, slices, block_mask, out, stream);
  return static_cast<int>(cudaGetLastError());
}

NR_ERROR_STRING_ENTRY
