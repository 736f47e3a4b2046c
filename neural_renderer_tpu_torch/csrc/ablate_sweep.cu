// The sweep family of the trace-kernel ablation (replaces the TPU kernel
// neural_renderer_tpu/ops/trace_pallas.py::_sweep_kernel re-traced with the
// tile math of scripts/ablate_trace_kernel.py::_mt_tile patched in,
// run_sweep_family :182-263): the dense dual-shell sweep's block loop
// (csrc/sweep_dense.cuh) with the variants nodiv, recip, recipx and bf16 of
// csrc/mt_variants.cuh. K4 itself is sweep_dense.cu.
//
// Bound (ops/bounds.py): the variant's operations per (ray, triangle) pair
// of the live blocks (46 for Möller–Trumbore, nodiv 47) at the FP32
// instruction rate (bf16: two per lane per clock).
#include "sweep_dense.cuh"

// Variant codes of ops/trace_ablation.py::VARIANT_CODES.
extern "C" int ablate_sweep(int variant, const float* o, const float* d,
                            int npad, const float* tris, int ttot,
                            int outer_cols, const int* block_mask,
                            int with_fwd2, float* out, cudaStream_t stream) {
  switch (variant) {
    case 2:
      return nr_sweep_dense_launch<MtRecip>(o, d, npad, tris, ttot,
                                            outer_cols, block_mask, with_fwd2,
                                            out, stream);
    case 3:
      return nr_sweep_dense_launch<MtRecipx>(o, d, npad, tris, ttot,
                                             outer_cols, block_mask,
                                             with_fwd2, out, stream);
    case 4:
      return nr_sweep_dense_launch<MtNodiv>(o, d, npad, tris, ttot,
                                            outer_cols, block_mask, with_fwd2,
                                            out, stream);
    case 5:
      return nr_sweep_dense_launch<MtBf16>(o, d, npad, tris, ttot,
                                           outer_cols, block_mask, with_fwd2,
                                           out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

NR_ERROR_STRING_ENTRY
