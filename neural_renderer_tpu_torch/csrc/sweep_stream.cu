// Clustered dual-shell sweep (replaces the TPU kernel
// neural_renderer_tpu/ops/trace_cluster.py::_sweep_stream_kernel).
//
// Work items on the clustered walk of csrc/trace_cluster_stream.cuh (the
// closest-hit kernels' walk, with no break): each 512-ray worklist block
// is cut into items of 64 rays, one 128-thread CUDA block each, launched
// longest worklist first (the rank kernel nr_trace_cluster_order); an item
// stages each listed cluster's 256 triangles into a cp.async double
// buffer while the previous cluster is swept. Thread (s, l) takes rays l
// and l + 32 and a quarter of each cluster, reading each triangle from the
// triangle-major tile as three 16-byte broadcast loads for both rays, and
// folds each pair into its ray's five accumulators (outer forward strict pair, outer backward,
// inner forward, inner backward; outer/inner decided per cluster, id <
// outer_clusters, and the second forward crossing a template argument).
// The four slices fold per ray through shared memory by the strict-pair
// rule and mins: min and strict second-min are selections, so the result
// is the twin's bit for bit (-fmad=false). No early out: all four minima
// must be exact. Blocks with count 0 write 1e30 to every row.
//
// Bound: FP32 operations, 46 per swept (ray, triangle) pair
// (ops/bounds.py), on sum(counts) x 512 x 256 pairs: the items sweep
// exactly the block-sized worklists' pairs.
#include "trace_cluster_stream.cuh"

extern "C" int sweep_stream(const float* o, const float* d, int npad,
                            const float* tris, int ttot, const int* ids,
                            const int* counts, int k, int outer_clusters,
                            int with_fwd2, int* order, float* out,
                            cudaStream_t stream) {
  return nr_sweep_cluster_items_launch<SweepMt>(
      o, d, npad, tris, ttot, ids, counts, k, outer_clusters, with_fwd2,
      order, out, stream);
}

NR_ERROR_STRING_ENTRY
