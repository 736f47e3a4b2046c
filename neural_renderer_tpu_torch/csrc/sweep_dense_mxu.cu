// Dense dual-shell sweep, matrix formulation (replaces the mxu=True body of
// the TPU kernel neural_renderer_tpu/ops/trace_pallas.py::_sweep_kernel,
// `_sweep_block_body` :200-230, NR_TRACE_MXU=1).
//
// tris = [outer | inner], each shell padded to whole 256-triangle tiles with
// zero triangles that the det cull rejects. Block, warps, feature staging
// and products as csrc/trace_dense_mxu.cu (128 triangles a step, so a step
// never straddles the two shells); a block whose skip flag is 0 writes 1e30
// to every row. Each lane folds its two columns per n-tile into per-ray
// accumulators: outer steps the strict forward pair (m1f, m2f) and the
// backward min, inner steps the forward and backward mins; forward is
// det > 0, backward det < 0 (facing = -det). The ray's quad merges them
// once at the end; the strict pair is a selection over the multiset of t's,
// so the grouping does not change it. Rows: outer_fwd, outer_bwd,
// inner_fwd, inner_bwd[, outer_fwd2].
//
// Bound: the FP64 tensor products, the function's 38 flops per (ray,
// triangle) pair of the live blocks x the shells' real triangles (48 as
// issued) at 67 TFLOP/s (H100 SXM).
#include "mt_mxu.cuh"

__global__ void __launch_bounds__(MXU_BLOCK_RAYS)
sweep_dense_mxu_kernel(const float* __restrict__ o,
                       const float* __restrict__ d, int npad,
                       const float* __restrict__ tris, int ttot,
                       int outer_cols, const int* __restrict__ block_mask,
                       int with_fwd2, float* __restrict__ out) {
  __shared__ MxuTile tile;
  MxuSweep acc;
  nr_sweep_init(acc);
  if (block_mask[blockIdx.x] != 0) {  // uniform across the block
    double a[MXU_MT][3];
    nr_mxu_rays(o, d, npad, a);
    for (int base = 0; base < ttot; base += MXU_TILE) {
      __syncthreads();  // previous tile fully consumed
      nr_mxu_stage(&tile, tris, ttot, base);
      __syncthreads();
      nr_sweep_tile(acc, &tile, a, base < outer_cols, with_fwd2);
    }
  }
  nr_sweep_write(acc, with_fwd2, npad, out);
}

extern "C" int sweep_dense_mxu(const float* o, const float* d, int npad,
                               const float* tris, int ttot, int outer_cols,
                               const int* block_mask, int with_fwd2,
                               float* out, cudaStream_t stream) {
  const int nb = npad / MXU_BLOCK_RAYS;
  if (nb > 0) {
    sweep_dense_mxu_kernel<<<nb, MXU_BLOCK_RAYS, 0, stream>>>(
        o, d, npad, tris, ttot, outer_cols, block_mask, with_fwd2, out);
  }
  return static_cast<int>(cudaGetLastError());
}

NR_ERROR_STRING_ENTRY
