// The sweep family of the trace-kernel ablation (replaces the TPU kernel
// neural_renderer_tpu/ops/trace_pallas.py::_sweep_kernel re-traced with the
// tile math of scripts/ablate_trace_kernel.py::_mt_tile patched in,
// run_sweep_family :182-263): K4's dense dual-shell sweep with the variants
// nodiv, recip, recipx and bf16 of csrc/mt_variants.cuh. K4 itself is
// sweep_dense.cu.
//
// The walk is K4's (csrc/mt_dense.cuh: 512-ray CTAs of 256 threads, two
// rays a thread, 64-triangle chunks in a cp.async double buffer, three
// 16-byte broadcast loads a triangle, triangle slices folded per ray),
// templated over the tile math. Each variant brings its prefilter rule
// (csrc/mt_variants.cuh, shared with the closest-hit ablation
// csrc/ablate_trace.cu, argues each), so every output equals the
// unfiltered loop's bit for bit. bf16 packs the thread's two rays in a
// bf16x2 and converts each staged chunk once.
//
// Bound (ops/bounds.py): the variant's operations per (ray, triangle) pair
// of the live blocks (46 for Möller–Trumbore, nodiv 47, bf16 45 packed and
// 3 at the FP32 rate) at the FP32 instruction rate (bf16 two per lane per
// clock); filtered, its rule's operations on every pair and the rest of its
// math on the pairs the rule leaves (bounds.dense_seconds with the
// variant's counts).
#include "mt_variants.cuh"

// The launch shape the wrapper allocates for (df_sweep_shape).
extern "C" int ablate_sweep_shape(int npad, int ttot, int* slices,
                                  long long* scratch_doubles) {
  return df_sweep_shape(npad, ttot, slices, scratch_doubles);
}

// Variant codes of ops/trace_ablation.py::VARIANT_CODES. part: [slices][5
// or 4][npad] f32 scratch (unused with one slice).
extern "C" int ablate_sweep(int variant, const float* o, const float* d,
                            int npad, const float* tris, int ttot,
                            int outer_cols, const int* block_mask,
                            int with_fwd2, int slices, float* part,
                            float* out, cudaStream_t stream) {
  switch (variant) {
    case 2:
      return df_sweep_launch<DfRecip>(o, d, npad, tris, ttot, outer_cols,
                                      block_mask, with_fwd2, slices, part,
                                      out, stream);
    case 3:
      return df_sweep_launch<DfRecipx>(o, d, npad, tris, ttot, outer_cols,
                                       block_mask, with_fwd2, slices, part,
                                       out, stream);
    case 4:
      return df_sweep_launch<DfNodiv>(o, d, npad, tris, ttot, outer_cols,
                                      block_mask, with_fwd2, slices, part,
                                      out, stream);
    case 5:
      return df_sweep_launch<DfBf16>(o, d, npad, tris, ttot, outer_cols,
                                     block_mask, with_fwd2, slices, part,
                                     out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

NR_ERROR_STRING_ENTRY
