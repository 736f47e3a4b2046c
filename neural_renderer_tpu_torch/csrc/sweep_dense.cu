// Dense dual-shell sweep (replaces the TPU kernel
// neural_renderer_tpu/ops/trace_pallas.py::_sweep_kernel): the block loop of
// csrc/sweep_dense.cuh with the production Möller–Trumbore math (MtLocal,
// nr_mt_t of csrc/mt.cuh).
//
// Bound: FP32 operations, ~45 per (ray, triangle) pair of the live blocks.
#include "sweep_dense.cuh"

extern "C" int sweep_dense(const float* o, const float* d, int npad,
                           const float* tris, int ttot, int outer_cols,
                           const int* block_mask, int with_fwd2, float* out,
                           cudaStream_t stream) {
  return nr_sweep_dense_launch<MtLocal>(o, d, npad, tris, ttot, outer_cols,
                                        block_mask, with_fwd2, out, stream);
}

NR_ERROR_STRING_ENTRY
