// Clustered dual-shell sweep, matrix formulation (replaces the mxu=True body
// of the TPU kernel neural_renderer_tpu/ops/trace_cluster.py::
// _sweep_stream_kernel, `_sweep4_cluster` :392-440, NR_TRACE_MXU=1).
//
// Work items on the clustered walk of csrc/trace_cluster_stream.cuh (the
// closest-hit kernels' walk, with no break): items of 64 rays, one
// 128-thread CUDA block each, launched longest worklist first, each
// listed cluster staged row-major into a cp.async double buffer while the
// previous one is swept. Per cluster the item builds its 256 triangles'
// features in two 128-triangle chunks (B-fragment order, csrc/mt_mxu.cuh);
// warp (s, g) runs six FP64 mma.sync products per 8x8 tile for the four
// 8-ray m-tiles of ray group g (32 rays) over half s of each chunk's
// n-tiles, the FP32 epilogue per pair, and folds the lane's columns into
// per-ray accumulators: outer clusters (id < outer_clusters, uniform
// across the item) the strict forward pair and the backward min, inner
// clusters the two mins; forward is det > 0. The ray's quad merges them,
// then the two halves through shared memory (strict pair and mins are
// selections: grouping-independent, so the result is the twin's bit for
// bit). No early out: all four minima must be exact.
//
// Bound: the FP64 tensor products, the function's 38 flops per swept (ray,
// triangle) pair (48 as issued) at 67 TFLOP/s (H100 SXM), on sum(counts) x
// 512 x 256 pairs.
#include "trace_cluster_stream.cuh"

extern "C" int sweep_stream_mxu(const float* o, const float* d, int npad,
                                const float* tris, int ttot, const int* ids,
                                const int* counts, int k, int outer_clusters,
                                int with_fwd2, int* order, float* out,
                                cudaStream_t stream) {
  return nr_sweep_cluster_items_launch<SweepMxu>(
      o, d, npad, tris, ttot, ids, counts, k, outer_clusters, with_fwd2,
      order, out, stream);
}

NR_ERROR_STRING_ENTRY
