// Clustered closest-hit trace, matrix formulation (replaces the mxu=True
// body of the TPU kernel neural_renderer_tpu/ops/trace_cluster.py::
// _stream_kernel, `_sweep_cluster` :156-191, NR_TRACE_MXU=1).
//
// The walk (work items of 32 rays that break on their own, scheduled
// longest worklist first, double-buffered cp.async tiles) is
// csrc/trace_cluster_stream.cuh's; this file instantiates it with the
// matrix form (csrc/mt_mxu.cuh): per cluster the item builds its 256
// triangles' features from the staged tile, 128 at a time, and each warp
// runs six FP64 mma.sync products per 8x8 tile for its 32 rays over its
// slice of the cluster, the FP32 epilogue per pair, and the lane's closest
// hit.
//
// Ties: smallest triangle id among equal t (the brute-force oracle's rule).
// TraceMode: 0 ANY, 1 FORWARD_ONLY (det > 0), 2 BACKWARD_ONLY (det < 0).
// Blocks with count 0 write a miss with id 0.
//
// Bound: the FP64 tensor products, the function's 38 flops per (ray,
// triangle) pair the items sweep (48 as executed) at 67 TFLOP/s (H100
// SXM), against the FP32 epilogue (ops/bounds.py); `item_swept` receives
// the clusters each item swept before its break.
#include "trace_cluster_stream.cuh"

extern "C" int trace_cluster_stream_mxu(const float* o, const float* d,
                                        int npad, const float* tris,
                                        int ttot, const int* ids,
                                        const float* tmins, const int* counts,
                                        int k, const float* exit_t, int mode,
                                        int use_break, int* order,
                                        float* best_t, int* best_tri,
                                        int* item_swept,
                                        cudaStream_t stream) {
  return nr_trace_cluster_items_launch<TcsMxu>(
      o, d, npad, tris, ttot, ids, tmins, counts, k, exit_t, mode, use_break,
      order, best_t, best_tri, item_swept, stream);
}

NR_ERROR_STRING_ENTRY
