// Clustered closest-hit trace (replaces the TPU kernel
// neural_renderer_tpu/ops/trace_cluster.py::_stream_kernel).
//
// The walk (work items of 32 rays that break on their own, scheduled
// longest worklist first, double-buffered cp.async tiles) is
// csrc/trace_cluster_stream.cuh's; this file instantiates it with FP32
// Möller–Trumbore (mt.cuh::nr_mt_t, -fmad=false, IEEE divide), reading each
// triangle from a triangle-major tile as three 16-byte broadcast loads.
//
// Ties: smallest triangle id among equal t (the brute-force oracle's rule).
// TraceMode: 0 ANY, 1 FORWARD_ONLY (det > 0), 2 BACKWARD_ONLY (det < 0).
// Blocks with count 0 write a miss with id 0.
//
// Bound: FP32 operations, 46 per (ray, triangle) pair the items sweep
// (ops/bounds.py); `item_swept` receives the clusters each item swept
// before its break, whose max over a block's items is the block's.
#include "trace_cluster_stream.cuh"

extern "C" int trace_cluster_stream(const float* o, const float* d, int npad,
                                    const float* tris, int ttot,
                                    const int* ids, const float* tmins,
                                    const int* counts, int k,
                                    const float* exit_t, int mode,
                                    int use_break, int* order,
                                    float* best_t, int* best_tri,
                                    int* item_swept, cudaStream_t stream) {
  return nr_trace_cluster_items_launch<TcsMt>(
      o, d, npad, tris, ttot, ids, tmins, counts, k, exit_t, mode, use_break,
      order, best_t, best_tri, item_swept, stream);
}

NR_ERROR_STRING_ENTRY
