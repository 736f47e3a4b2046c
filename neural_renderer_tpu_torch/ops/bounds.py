"""The least time an NVIDIA H100 could take for a kernel's work: its bound.

A kernel's bound is the larger of two times: the bytes it must move (each
input read once, each output written once) over the memory rate, and the
operations its function needs over the peak rate for their type. Every
bound in `chip_smoke.py` and `scripts/ablate_trace_kernel_torch.py` is
computed from the rates and counts here.

Rates: NVIDIA H100 SXM data sheet, dense, at the 700 W limit. The data
sheet's 67 TFLOP/s FP32 counts a fused multiply-add as two operations (132
SMs x 128 lanes x 2 x 1.98 GHz). The trace kernels build with -fmad=false
(ops/cuda_build.py), so each of their operations is one instruction: their
peak is the instruction rate, 132 x 128 x 1.98e9 per second. The trace
ablation's probe (50 unfused operations per pair) runs near it.

How operations are counted, one rule for every pair function: arithmetic
only (add, subtract, multiply; a divide or a reciprocal as one), plus each
conversion between precisions; compares, selects, min, max and abs count
zero, and so do loads. The counts per (ray, triangle) pair:

  Möller–Trumbore, `local` (mt.cuh::nr_mt_t; the production trace and
  sweep kernels K1, K3, K4, K5 and `recip`, `recipx`): d x e2 9, det 5,
  1/det 1, o - v0 3, u 6, q 9, v 6, u + v 1, t 6 = 46.
  `nodiv` (mt_variants.cuh::MtNodiv): the same 41 before the culls, then
  u_num s, v_num s, t_num s 3, u + v 1, eps |det| 1, t = ts / |det| 1 = 47.
  `probe` (mt_variants.cuh::MtProbe): a = o v0 1, b = d + v0 1, 24
  multiplies and 24 adds = 50.
  `bf16` (mt_variants.cuh::MtBf16): `local`'s 45 without the divide, in
  packed bf16 at two per lane per clock, plus the f32 divide and its two
  conversions (det to f32, 1/det to bf16) at the FP32 rate.
  The matrix form's epilogue (mt_mxu.cuh::nr_mxu_epilogue): 1/det 1, u, v,
  t 3, u + v 1 = 5; the FP64-product kernels (K8, K1/K4/K5-MXU) add the
  four FP64-to-FP32 conversions of det, u·det, v·det and t·det = 9. The
  bf16-product kernels accumulate in f32 and convert nothing.
  The matrix form's products: the function's 19 multiply-adds per pair
  (det 3, u 6, v 6, t 4), 38 flops as the tensor rates count them, on FP64
  tensor cores or, per bf16 pass, on bf16 ones.
"""

from __future__ import annotations

FP32_RATE = 132 * 128 * 1.98e9   # unfused FP32 instructions per second
BF16X2_RATE = 2 * FP32_RATE      # packed bf16x2: two per lane per clock
BF16_TENSOR = 989e12             # dense bf16 tensor-core flops per second
FP64_TENSOR = 67e12              # FP64 tensor-core flops per second
BYTES_RATE = 3.35e12             # HBM3 bytes per second

# FP32 operations per pair of each scalar tile math (the rule above).
FP32_OPS = {"local": 46, "recip": 46, "recipx": 46, "nodiv": 47,
            "probe": 50}
MT_OPS = FP32_OPS["local"]
BF16_PACKED_OPS = 45             # `bf16`: packed bf16 operations per pair
BF16_FP32_OPS = 3                # `bf16`: its f32 divide and conversions
MXU_FLOPS = 38                   # the matrix form's products, per pair
MXU_EPILOGUE = 5                 # its FP32 epilogue, per pair
MXU_CONVERSIONS = 4              # FP64-to-FP32 conversions, per pair


def trace_seconds(math: str, pairs: int) -> float:
    """The least time of `pairs` pairs of tile math `math`: one of
    FP32_OPS's keys or "bf16"."""
    if math == "bf16":
        return pairs * (BF16_PACKED_OPS / BF16X2_RATE
                        + BF16_FP32_OPS / FP32_RATE)
    return pairs * FP32_OPS[math] / FP32_RATE


def mxu_seconds(pairs: int, bf16_passes: int | None = None) -> float:
    """The least time of `pairs` pairs of the matrix form: the larger of its
    tensor products (FP64, or `bf16_passes` bf16 passes) and its FP32
    epilogue."""
    if bf16_passes is None:
        return max(pairs * MXU_FLOPS / FP64_TENSOR,
                   pairs * (MXU_EPILOGUE + MXU_CONVERSIONS) / FP32_RATE)
    return max(pairs * MXU_FLOPS * bf16_passes / BF16_TENSOR,
               pairs * MXU_EPILOGUE / FP32_RATE)
