// The dense dual-shell sweep's first block loop for K4 (TPU
// kernel neural_renderer_tpu/ops/trace_pallas.py::_sweep_kernel), templated
// over the tile math (csrc/mt_variants.cuh). It serves the trace-kernel
// ablation only: ablate_sweep.cu instantiates the ablation's variants
// (scripts/ablate_trace_kernel.py::run_sweep_family), which keep this
// block shape so that their times stay comparable with each other and
// with PERF.md's K9 rows. K4 itself (sweep_dense.cu) walks
// csrc/mt_dense.cuh.
//
// tris = [outer | inner], each shell padded to whole 256-triangle tiles with
// degenerate triangles that the det cull rejects. One block per 512 rays, one
// thread per ray; a block whose skip flag is 0 (no ray meets the shells'
// padded root AABB) writes 1e30 to every row without touching a triangle.
// Live blocks stage every tile in shared memory; outer tiles fold the strict
// forward pair (m1f, m2f) and the backward min, inner tiles the forward and
// backward mins, all in registers. The strict pair is a selection over the
// multiset of t's, so folding triangle by triangle equals the twin's
// per-tile merge bit for bit. Rows: outer_fwd, outer_bwd, inner_fwd,
// inner_bwd[, outer_fwd2]. A variant's miss value (bf16's 1e30 is above
// 1e30) never lowers an accumulator that starts at 1e30, as in the
// reference, where jnp.minimum promotes the bf16 t to the f32 accumulators.
#pragma once

#include "mt_variants.cuh"

#define SD_BLOCK_RAYS 512
#define SD_TILE 256

template <class M>
__global__ void __launch_bounds__(SD_BLOCK_RAYS)
nr_sweep_dense_kernel(const float* __restrict__ o, const float* __restrict__ d,
                      int npad, const float* __restrict__ tris, int ttot,
                      int outer_cols, const int* __restrict__ block_mask,
                      int with_fwd2, float* __restrict__ out) {
  __shared__ float tile[9][SD_TILE];
  const int b = blockIdx.x;
  const long long r = (long long)b * SD_BLOCK_RAYS + threadIdx.x;
  float m1f = NR_MISS, m2f = NR_MISS, m1b = NR_MISS;
  float i1f = NR_MISS, i1b = NR_MISS;
  if (block_mask[b] != 0) {  // uniform across the block
    const NrRay ray{o[r], o[npad + r], o[2LL * npad + r],
                    d[r], d[npad + r], d[2LL * npad + r]};
    const typename M::RayState rs = M::ray(ray);
    for (int base = 0; base < ttot; base += SD_TILE) {
      __syncthreads();  // previous tile fully consumed
      nr_stage_tile<SD_TILE>(tile, tris, ttot, base);
      __syncthreads();
      if (base < outer_cols) {
#pragma unroll 2
        for (int q = 0; q < SD_TILE; q += 2) {
          float t[2], det[2];
          M::template pair2<SD_TILE>(rs, tile, q, t, det);
          nr_sweep_outer(with_fwd2, t[0], det[0], m1f, m2f, m1b);
          nr_sweep_outer(with_fwd2, t[1], det[1], m1f, m2f, m1b);
        }
      } else {
#pragma unroll 2
        for (int q = 0; q < SD_TILE; q += 2) {
          float t[2], det[2];
          M::template pair2<SD_TILE>(rs, tile, q, t, det);
          nr_sweep_inner(t[0], det[0], i1f, i1b);
          nr_sweep_inner(t[1], det[1], i1f, i1b);
        }
      }
    }
  }
  out[r] = m1f;
  out[npad + r] = m1b;
  out[2LL * npad + r] = i1f;
  out[3LL * npad + r] = i1b;
  if (with_fwd2) out[4LL * npad + r] = m2f;
}

template <class M>
int nr_sweep_dense_launch(const float* o, const float* d, int npad,
                          const float* tris, int ttot, int outer_cols,
                          const int* block_mask, int with_fwd2, float* out,
                          cudaStream_t stream) {
  const int nb = npad / SD_BLOCK_RAYS;
  if (nb > 0) {
    nr_sweep_dense_kernel<M><<<nb, SD_BLOCK_RAYS, 0, stream>>>(
        o, d, npad, tris, ttot, outer_cols, block_mask, with_fwd2, out);
  }
  return static_cast<int>(cudaGetLastError());
}
