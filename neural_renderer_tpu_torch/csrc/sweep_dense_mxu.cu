// Dense dual-shell sweep, matrix formulation (replaces the mxu=True body of
// the TPU kernel neural_renderer_tpu/ops/trace_pallas.py::_sweep_kernel,
// `_sweep_block_body` :200-230, NR_TRACE_MXU=1).
//
// tris = [outer | inner], each shell padded to whole 256-triangle tiles with
// zero triangles that the det cull rejects, so a DX_CHUNK_TRIS chunk never
// straddles the two shells. Per ray the rows outer_fwd, outer_bwd,
// inner_fwd, inner_bwd[, outer_fwd2]: outer pairs fold into the strict
// forward pair (m1f, m2f) and the backward min, inner pairs into the two
// mins; forward is det > 0, backward det < 0 (facing = -det). Rays of a
// 512-ray block whose skip flag is 0 get 1e30 in every row.
//
// Launches, CTA, walk and prefilter as csrc/trace_dense_mxu.cu
// (csrc/mt_mxu.cuh, "the dense kernels"); each lane folds its two rows,
// the ray's quad merges them at the end, and with more than one
// triangle slice a fold kernel merges the slices' partial rows per ray. The
// strict pair and the mins are selections over the multiset of t's, so no
// grouping changes them.
//
// Bound: the FP64 tensor products, the function's 38 flops per (ray,
// triangle) pair of the live blocks x the shells' real triangles (48 as
// issued) at 67 TFLOP/s (H100 SXM).
#include "mt_mxu.cuh"

template <bool kFwd2>
__global__ void __launch_bounds__(DX_THREADS)
sweep_dense_mxu_kernel(const float* __restrict__ o,
                       const float* __restrict__ d, int npad,
                       const double* __restrict__ feat, int nchunks,
                       int outer_cols, const int* __restrict__ block_mask,
                       int slices, float* __restrict__ out) {
  constexpr int kRows = kFwd2 ? 5 : 4;
  __shared__ __align__(16) double buf[2 * DX_CHUNK * DX_FRAG];
  const long long ray0 = (long long)blockIdx.x * DX_RAYS;
  const int s = blockIdx.y;
  if (block_mask[ray0 / NR_SKIP_RAYS] == 0) {  // uniform across the CTA
    if (slices == 1) {
      for (int i = threadIdx.x; i < kRows * DX_RAYS; i += DX_THREADS)
        out[(long long)(i / DX_RAYS) * npad + ray0 + i % DX_RAYS] = NR_MISS;
    }
    return;  // with slices the fold writes the miss
  }
  DxRays a;
  nr_dx_rays(o, d, npad, nr_dx_ray(ray0), a);
  MxuSweepN<2> acc;  // rows g and g + 8
  nr_sweep_init(acc);
  nr_dx_walk<0>(
      feat, nr_slice_chunk(s, nchunks, slices),
      nr_slice_chunk(s + 1, nchunks, slices), a, buf,
      [&](int e, int id, float t, float det) {
        const int h = e >> 1;
        if (id < outer_cols) {  // uniform across the chunk
          nr_sweep_outer(kFwd2, t, det, acc.m1f[h], acc.m2f[h], acc.m1b[h]);
        } else {
          nr_sweep_inner(t, det, acc.i1f[h], acc.i1b[h]);
        }
      });
  nr_sweep_quad(acc, kFwd2);
  float* dst = out + (long long)s * kRows * npad;  // a slice's partial rows
  if ((threadIdx.x & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = nr_dx_ray(ray0) + 8 * h;
      dst[r] = acc.m1f[h];
      dst[npad + r] = acc.m1b[h];
      dst[2LL * npad + r] = acc.i1f[h];
      dst[3LL * npad + r] = acc.i1b[h];
      if (kFwd2) dst[4LL * npad + r] = acc.m2f[h];
    }
  }
}

template <bool kFwd2>
void sweep_dense_mxu_launch(const float* o, const float* d, int npad,
                            const double* feat, int ttot, int outer_cols,
                            const int* block_mask, int slices, float* part,
                            float* out, cudaStream_t stream) {
  const dim3 grid(npad / DX_RAYS, slices);
  sweep_dense_mxu_kernel<kFwd2><<<grid, DX_THREADS, 0, stream>>>(
      o, d, npad, feat, ttot / DX_CHUNK_TRIS, outer_cols, block_mask, slices,
      slices == 1 ? out : part);
  nr_dense_fold_launch<kFwd2 ? 5 : 4>(part, npad, slices, block_mask, out,
                                      stream);
}

// The launch shape the wrapper allocates for (nr_dx_shape).
extern "C" int sweep_dense_mxu_shape(int npad, int ttot, int* slices,
                                     long long* feat_doubles) {
  return nr_dx_shape(npad, ttot, slices, feat_doubles);
}

// feat: [T / 8][DX_FRAG] f64 scratch; part: [slices][5 or 4][npad] f32
// scratch (unused with one slice). T and outer_cols must be multiples of
// DX_CHUNK_TRIS.
extern "C" int sweep_dense_mxu(const float* o, const float* d, int npad,
                               const float* tris, int ttot, int outer_cols,
                               const int* block_mask, int with_fwd2,
                               int slices, double* feat, float* part,
                               float* out, cudaStream_t stream) {
  if (ttot % DX_CHUNK_TRIS != 0 || outer_cols % DX_CHUNK_TRIS != 0 ||
      slices < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (npad / DX_RAYS == 0) return static_cast<int>(cudaGetLastError());
  if (ttot > 0) {
    nr_dx_features<<<(ttot + DX_THREADS - 1) / DX_THREADS, DX_THREADS, 0,
                     stream>>>(tris, ttot, feat);
  }
  if (with_fwd2) {
    sweep_dense_mxu_launch<true>(o, d, npad, feat, ttot, outer_cols,
                                 block_mask, slices, part, out, stream);
  } else {
    sweep_dense_mxu_launch<false>(o, d, npad, feat, ttot, outer_cols,
                                  block_mask, slices, part, out, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

NR_ERROR_STRING_ENTRY
