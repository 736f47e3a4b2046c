// Dense dual-shell sweep (replaces the TPU kernel
// neural_renderer_tpu/ops/trace_pallas.py::_sweep_kernel).
//
// tris = [outer | inner], each shell padded to whole 256-triangle tiles with
// zero triangles that the det cull rejects, so a DF_CHUNK chunk never
// straddles the two shells. Per ray the rows outer_fwd, outer_bwd,
// inner_fwd, inner_bwd[, outer_fwd2]: outer pairs fold into the strict
// forward pair (m1f, m2f) and the backward min, inner pairs into the two
// mins; forward is det > 0, backward det < 0 (facing = -det). Rays of a
// 512-ray block whose skip flag is 0 get 1e30 in every row.
//
// The FP32 walk of csrc/mt_dense.cuh, as csrc/trace_dense.cu: each thread
// folds its DF_R rays' pairs that the prefilter leaves, and with more
// than one triangle slice nr_dense_fold merges the slices' partial rows
// per ray. The strict pair and the mins are selections over the multiset
// of t's, so no grouping changes them, and a rejected pair's t = 1e30
// changes no accumulator.
//
// Bound (ops/bounds.py): FP32 operations, 46 per (ray, triangle) pair of
// the live blocks x the shells' real triangles without a prefilter; with
// it, counted as csrc/trace_dense.cu's.
#include "mt_dense.cuh"

template <bool kFwd2>
__global__ void __launch_bounds__(DF_THREADS)
sweep_dense_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   int npad, const float* __restrict__ tris, int ttot,
                   int outer_cols, const int* __restrict__ block_mask,
                   int slices, float* __restrict__ out) {
  constexpr int kRows = kFwd2 ? 5 : 4;
  __shared__ __align__(16) float buf[2 * DF_CHUNK * DF_TRI_STRIDE];
  const long long ray0 = (long long)blockIdx.x * DF_RAYS;
  const int s = blockIdx.y;
  if (block_mask[ray0 / NR_SKIP_RAYS] == 0) {  // uniform across the CTA
    if (slices == 1) {
#pragma unroll
      for (int i = 0; i < DF_R; ++i) {
        for (int row = 0; row < kRows; ++row)
          out[(long long)row * npad + df_ray(ray0, i)] = NR_MISS;
      }
    }
    return;  // with slices the fold writes the miss
  }
  DfRays r;
  df_load(o, d, npad, ray0, r);
  float m1f[DF_R], m2f[DF_R], m1b[DF_R], i1f[DF_R], i1b[DF_R];
#pragma unroll
  for (int i = 0; i < DF_R; ++i)
    m1f[i] = m2f[i] = m1b[i] = i1f[i] = i1b[i] = NR_MISS;
  const int nchunks = ttot / DF_CHUNK;
  df_walk<0>(tris, ttot, nr_slice_chunk(s, nchunks, slices),
             nr_slice_chunk(s + 1, nchunks, slices), r, buf,
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
    const long long q = df_ray(ray0, i);
    dst[q] = m1f[i];
    dst[npad + q] = m1b[i];
    dst[2LL * npad + q] = i1f[i];
    dst[3LL * npad + q] = i1b[i];
    if (kFwd2) dst[4LL * npad + q] = m2f[i];
  }
}

template <bool kFwd2>
void sweep_dense_launch(const float* o, const float* d, int npad,
                        const float* tris, int ttot, int outer_cols,
                        const int* block_mask, int slices, float* part,
                        float* out, cudaStream_t stream) {
  const dim3 grid(npad / DF_RAYS, slices);
  sweep_dense_kernel<kFwd2><<<grid, DF_THREADS, 0, stream>>>(
      o, d, npad, tris, ttot, outer_cols, block_mask, slices,
      slices == 1 ? out : part);
  nr_dense_fold_launch<kFwd2 ? 5 : 4>(part, npad, slices, block_mask, out,
                                      stream);
}

// The launch shape the wrapper allocates for (nr_dense_slices); the walk
// needs no scratch beyond the partial rows.
extern "C" int sweep_dense_shape(int npad, int ttot, int* slices,
                                 long long* scratch_doubles) {
  *scratch_doubles = 0;
  return nr_dense_slices(npad, ttot, DF_RAYS, DF_CHUNK, DF_CTAS_PER_SM,
                         slices);
}

// part: [slices][5 or 4][npad] f32 scratch (unused with one slice). T and
// outer_cols must be multiples of DF_CHUNK.
extern "C" int sweep_dense(const float* o, const float* d, int npad,
                           const float* tris, int ttot, int outer_cols,
                           const int* block_mask, int with_fwd2, int slices,
                           float* part, float* out, cudaStream_t stream) {
  if (ttot % DF_CHUNK != 0 || outer_cols % DF_CHUNK != 0 || slices < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (npad / DF_RAYS == 0) return static_cast<int>(cudaGetLastError());
  if (with_fwd2) {
    sweep_dense_launch<true>(o, d, npad, tris, ttot, outer_cols, block_mask,
                             slices, part, out, stream);
  } else {
    sweep_dense_launch<false>(o, d, npad, tris, ttot, outer_cols, block_mask,
                              slices, part, out, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

NR_ERROR_STRING_ENTRY
