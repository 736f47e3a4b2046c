// Clustered dual-shell sweep, matrix formulation (replaces the mxu=True body
// of the TPU kernel neural_renderer_tpu/ops/trace_cluster.py::
// _sweep_stream_kernel, `_sweep4_cluster` :392-440, NR_TRACE_MXU=1).
//
// One block of 16 warps per 512-ray worklist block. The block reads its own
// cluster count and worklist row and, for each listed cluster, builds the
// features of its 256 triangles in two 128-triangle steps into shared
// memory (B-fragment order, csrc/mt_mxu.cuh); each warp runs six FP64
// mma.sync products per 8x8 tile for its four 8-ray m-tiles and the FP32
// epilogue per pair. Each lane folds its columns into per-ray accumulators:
// outer clusters (id < outer_clusters, uniform across the block) the strict
// forward pair and the backward min, inner clusters the two mins; forward
// is det > 0, backward det < 0. The ray's quad merges them once at the end
// (strict pair and mins are selections: grouping-independent). No early
// out: all four minima must be exact.
//
// Bound: the FP64 tensor products, the function's 38 flops per swept (ray,
// triangle) pair (48 as issued) at 67 TFLOP/s (H100 SXM); the block-sized
// worklist keeps the swept pairs at the block frustum's footprint.
#include "mt_mxu.cuh"

#define SSM_CLUSTER 256

__global__ void __launch_bounds__(MXU_BLOCK_RAYS)
sweep_stream_mxu_kernel(const float* __restrict__ o,
                        const float* __restrict__ d, int npad,
                        const float* __restrict__ tris, int ttot,
                        const int* __restrict__ ids,
                        const int* __restrict__ counts, int k,
                        int outer_clusters, int with_fwd2,
                        float* __restrict__ out) {
  __shared__ MxuTile tile;
  double a[MXU_MT][3];
  nr_mxu_rays(o, d, npad, a);
  MxuSweep acc;
  nr_sweep_init(acc);
  const int cnt = counts[blockIdx.x];
  const int* row = ids + (long long)blockIdx.x * k;
  for (int jc = 0; jc < cnt; ++jc) {
    const int c = row[jc];
    for (int half = 0; half < SSM_CLUSTER; half += MXU_TILE) {
      __syncthreads();  // previous tile fully consumed
      nr_mxu_stage(&tile, tris, ttot, (long long)c * SSM_CLUSTER + half);
      __syncthreads();
      nr_sweep_tile(acc, &tile, a, c < outer_clusters, with_fwd2);
    }
  }
  nr_sweep_write(acc, with_fwd2, npad, out);
}

extern "C" int sweep_stream_mxu(const float* o, const float* d, int npad,
                                const float* tris, int ttot, const int* ids,
                                const int* counts, int k, int outer_clusters,
                                int with_fwd2, float* out,
                                cudaStream_t stream) {
  const int nb = npad / MXU_BLOCK_RAYS;
  if (nb > 0) {
    sweep_stream_mxu_kernel<<<nb, MXU_BLOCK_RAYS, 0, stream>>>(
        o, d, npad, tris, ttot, ids, counts, k, outer_clusters, with_fwd2,
        out);
  }
  return static_cast<int>(cudaGetLastError());
}

NR_ERROR_STRING_ENTRY
