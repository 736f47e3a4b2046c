// Dense dual-shell sweep (replaces the TPU kernel
// neural_renderer_tpu/ops/trace_pallas.py::_sweep_kernel).
//
// tris = [outer | inner], each shell padded to whole 256-triangle tiles;
// per ray the rows outer_fwd, outer_bwd, inner_fwd, inner_bwd[,
// outer_fwd2] of the live 512-ray blocks, 1e30 in a block whose skip flag
// is 0.
//
// The FP32 walk of csrc/mt_dense.cuh with its production tile math (DfMt),
// as csrc/trace_dense.cu: mt_dense.cuh's sweep_dense_kernel, each thread
// folding its DF_R rays' pairs that the prefilter leaves, and with more
// than one triangle slice nr_dense_fold merging the slices' partial rows
// per ray.
//
// Bound (ops/bounds.py): FP32 operations, 46 per (ray, triangle) pair of
// the live blocks x the shells' real triangles without a prefilter; with
// it, counted as csrc/trace_dense.cu's.
#include "mt_dense.cuh"

// The launch shape the wrapper allocates for (df_sweep_shape).
extern "C" int sweep_dense_shape(int npad, int ttot, int* slices,
                                 long long* scratch_doubles) {
  return df_sweep_shape(npad, ttot, slices, scratch_doubles);
}

// part: [slices][5 or 4][npad] f32 scratch (unused with one slice). T and
// outer_cols must be multiples of the 64-triangle chunk.
extern "C" int sweep_dense(const float* o, const float* d, int npad,
                           const float* tris, int ttot, int outer_cols,
                           const int* block_mask, int with_fwd2, int slices,
                           float* part, float* out, cudaStream_t stream) {
  return df_sweep_launch<DfMt>(o, d, npad, tris, ttot, outer_cols,
                               block_mask, with_fwd2, slices, part, out,
                               stream);
}

NR_ERROR_STRING_ENTRY
