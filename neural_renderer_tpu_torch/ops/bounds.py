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
  The FP32 dense kernels' prefilter (K3, K4; mt_dense.cuh::df_face,
  df_keep_u, df_keep_v) needs Möller–Trumbore only where its rule leaves a
  pair: the function is d x e2 and det on every pair = 14 (DENSE_DET);
  o - v0, u·det and the rule's two bounds (|det| (-2^-20),
  |det| (1 + 2^-20)) on the pairs the facing test leaves = 10 (DENSE_U;
  every pair in ANY, the pairs det's sign keeps in FORWARD_ONLY and
  BACKWARD_ONLY); q and v·det on the pairs the u test leaves = 14
  (DENSE_V); 1/det, u, v, u + v and t (10, DENSE_REST) on the pairs the v
  test leaves (trace_pallas.prefilter_pairs counts them on the call's
  operands).
  Their bound counts that (dense_seconds), beside the 46 per pair.
  `nodiv` (mt_variants.cuh::nr_nodiv_t): the same 41 before the culls, then
  u_num s, v_num s, t_num s 3, u + v 1, eps |det| 1, t = ts / |det| 1 = 47.
  `probe` (mt_variants.cuh::MtProbe): a = o v0 1, b = d + v0 1, 24
  multiplies and 24 adds = 50.
  `bf16` (mt_variants.cuh::DfBf16): `local`'s 45 without the divide, in
  packed bf16 at two per lane per clock, plus the f32 divide and its two
  conversions (det to f32, 1/det to bf16) at the FP32 rate.
  The ablation's trace and sweep variants run K3's and K4's walk, each
  behind its own rule (csrc/mt_variants.cuh; trace_ablation.variant_rule);
  their filtered bound counts each test as DENSE_* do (PREFILTER_OPS):
  `local` as K3, `recip` and `recipx` as `local`; `nodiv` 14, 8 (its rule compares w with 0 and
  |det|: no bound multiply), 14 and 47 - 36 = 11; `bf16` in packed bf16
  14, 8, 14 and 9, and at the FP32 rate the u test's 2 bound multiplies
  and the widenings of det and u·det, the v test's widening of v·det, and
  the rest's divide and 1/det's narrowing (BF16_PREFILTER_FP32).
  The matrix form's epilogue (mt_mxu.cuh::nr_mxu_epilogue): 1/det 1, u, v,
  t 3, u + v 1 = 5; with FP64 products (K8, K1/K4/K5-MXU) the four
  FP64-to-FP32 conversions of det, u·det, v·det and t·det come before it,
  counted at their own rate (CONVERSION_RATE). The function needs both
  only on the pairs a sound prefilter cannot rule out: every FP64 kernel's
  bound counts 3 FP32 multiplies per pair (mt_mxu.cuh::nr_dx_maybe,
  MXU_PREFILTER) and the conversions and the epilogue on the pairs that
  prefilter leaves (trace_mxu.epilogue_pairs for the dense kernels,
  trace_cluster.epilogue_pairs for the pairs a clustered walk sweeps),
  whether or not the kernel prefilters (K1-MXU and K5-MXU convert every
  pair). The bf16-product kernels accumulate in f32 and convert nothing;
  their prefilter (csrc/ablate_mxu_bf16.cu::bm_maybe) takes a multiply and
  two fused multiply-adds per pair (MXU_BF16_PREFILTER), and their bound
  counts the epilogue on the pairs of the slots it leaves
  (trace_ablation.mxu_bf16_epilogue_pairs).
  The matrix form's products: the function's 19 multiply-adds per pair
  (det 3, u 6, v 6, t 4), 38 flops as the tensor rates count them, on FP64
  tensor cores or, per bf16 pass, on bf16 ones.

The shell networks' MLP (K2, K6, K7): 2 operations per multiply-add of
the function on the bf16 tensor cores, layer 0 at its real inputs (the
kernels' zero padding to 128 is their layout, not the function's work):
`NbvhConfig.mlp_n_params`, 65,536 a row for the reference network.
mlp_seconds counts them against the bytes K7 moves a row: its f32 input
row (112 x 4 = 448 B) read once and its 16 f32 outputs (64 B) written
once.

The bounce sampler (K10, csrc/sample_bounce.cu), per ray: every ray
reads its hit and active flags and writes origin, direction, pdf and BRDF
weight ([3, N], [3, N], [N], [3, N] f32) and its new active flag
(SAMPLE_RAY_BYTES); a live ray (hit and active) reads besides its pixel
and sample ids (int64), position, normal, albedo and material parameters
([3, N] f32; SAMPLE_LIVE_BYTES) and, after the first bounce, its stored
incoming direction (SAMPLE_INCOMING_BYTES). A live ray's operations,
counted from the source by the rule above, with the wang hash's integer
instructions (xor, shift, multiply, add; 9 a hash) and each
transcendental call (cosf, sinf, tanf, logf, powf) as one: the seed and
its hash 14, three draws 36 (12 each: hash, mask, conversion, scale),
the lobe's pick 2, the normal's normalization and face flip 22, the
tangent frame 38, the chosen lobe's direction 55-82 (taken as the
cheapest, the clearcoat's 55), the half vector 13, the lobe's validity
13, the three-lobe pdf 64, the Disney evaluation 210, the BRDF weight 10
and the origin 7 = 484 (SAMPLE_OPS); the first bounce regenerates the
camera ray, two more draws and the ray's 40 (SAMPLE_CAMERA_OPS). At the
view's 4K first bounce the bytes decide the bound.

CONVERSION_RATE: FP64-to-FP32 conversions, 16 per clock per SM (NVIDIA's
arithmetic-instruction throughput table for compute capability 9.0, in
the CUDA C++ programming documentation) x 132 SMs x 1.98 GHz. A probe on
an NVIDIA H100 80GB HBM3 at 700 W measured 14.0-14.2 per clock per SM
(PERF.md): below the FP32 instruction rate's 128, so the four conversions
of a pair take longer than its FP64 products.
"""

from __future__ import annotations

FP32_RATE = 132 * 128 * 1.98e9   # unfused FP32 instructions per second
BF16X2_RATE = 2 * FP32_RATE      # packed bf16x2: two per lane per clock
BF16_TENSOR = 989e12             # dense bf16 tensor-core flops per second
FP64_TENSOR = 67e12              # FP64 tensor-core flops per second
CONVERSION_RATE = 16 * 132 * 1.98e9  # FP64-to-FP32 conversions per second
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
MXU_PREFILTER = 3                # the dense kernels' prefilter, per pair
MXU_BF16_PREFILTER = 3           # the bf16-product kernels' prefilter
DENSE_DET = 14                   # the FP32 dense prefilter's det, every pair
DENSE_U = 10                     # its u test, where the facing leaves a pair
DENSE_V = 14                     # its v test, where the u test leaves one
DENSE_REST = MT_OPS - 36         # the rest of Möller–Trumbore, where v does
# The prefiltered walk's FP32 operations per pair of each tile math: det,
# the u test, the v test, the rest (the module docstring).
PREFILTER_OPS = {
    "local": (DENSE_DET, DENSE_U, DENSE_V, DENSE_REST),
    "recip": (DENSE_DET, DENSE_U, DENSE_V, DENSE_REST),
    "recipx": (DENSE_DET, DENSE_U, DENSE_V, DENSE_REST),
    "nodiv": (DENSE_DET, 8, DENSE_V, FP32_OPS["nodiv"] - 36),
}
BF16_PREFILTER_PACKED = (14, 8, 14, 9)   # `bf16`'s, in packed bf16
BF16_PREFILTER_FP32 = (0, 4, 1, 2)       # and at the FP32 rate


# The bounce sampler (K10), the module docstring: bytes of every ray, of a
# live ray besides, of its stored incoming direction; a live ray's
# operations, and the first bounce's camera ray.
SAMPLE_RAY_BYTES = 2 + 12 + 12 + 4 + 12 + 1
SAMPLE_LIVE_BYTES = 8 + 8 + 4 * 12
SAMPLE_INCOMING_BYTES = 12
SAMPLE_OPS = 484
SAMPLE_CAMERA_OPS = 64


def sample_bounce_work(rays: int, live: int,
                      first_bounce: bool) -> tuple[int, int]:
    """(bytes, FP32 operations) of one sampler call on `rays` rays of which
    `live` are hit and active (the module docstring)."""
    live_bytes = SAMPLE_LIVE_BYTES + (0 if first_bounce
                                      else SAMPLE_INCOMING_BYTES)
    ops = SAMPLE_OPS + (SAMPLE_CAMERA_OPS if first_bounce else 0)
    return rays * SAMPLE_RAY_BYTES + live * live_bytes, live * ops


def sample_bounce_seconds(rays: int, live: int, first_bounce: bool) -> float:
    """The least time of that call: the larger of its bytes at BYTES_RATE
    and its operations at FP32_RATE."""
    nbytes, ops = sample_bounce_work(rays, live, first_bounce)
    return max(nbytes / BYTES_RATE, ops / FP32_RATE)


def trace_seconds(math: str, pairs: int) -> float:
    """The least time of `pairs` pairs of tile math `math`: one of
    FP32_OPS's keys or "bf16"."""
    if math == "bf16":
        return pairs * (BF16_PACKED_OPS / BF16X2_RATE
                        + BF16_FP32_OPS / FP32_RATE)
    return pairs * FP32_OPS[math] / FP32_RATE


def mxu_seconds(pairs: int, bf16_passes: int | None = None,
                converted: int | None = None) -> float:
    """The least time of `pairs` pairs of the matrix form: the larger of its
    tensor products (FP64, or `bf16_passes` bf16 passes), its FP32
    operations and, with FP64 products, the conversions of the products to
    f32, each at its own rate. `converted`: the pairs whose products the
    function must finish in the epilogue (and, with FP64 products, convert;
    the module docstring), required with FP64 products; with bf16 products
    None counts the epilogue on every pair, without a prefilter."""
    if bf16_passes is not None:
        fp32 = (pairs * MXU_EPILOGUE if converted is None else
                pairs * MXU_BF16_PREFILTER + converted * MXU_EPILOGUE)
        return max(pairs * MXU_FLOPS * bf16_passes / BF16_TENSOR,
                   fp32 / FP32_RATE)
    if converted is None:
        raise ValueError("mxu_seconds: FP64 products need `converted`")
    fp32 = pairs * MXU_PREFILTER + converted * MXU_EPILOGUE
    return max(pairs * MXU_FLOPS / FP64_TENSOR, fp32 / FP32_RATE,
               converted * MXU_CONVERSIONS / CONVERSION_RATE)


def dense_seconds(pairs: int, facing: int, left_u: int, left_v: int,
                  math: str = "local") -> float:
    """The least time of `pairs` pairs of the FP32 dense kernels' function
    (K3, K4): det on every pair, the u test on the `facing` pairs the
    facing test leaves, the v test on the `left_u` pairs the u test leaves,
    the rest of Möller–Trumbore on the `left_v` pairs the v test leaves
    (the module docstring; `trace_pallas.prefilter_pairs` counts them).
    `math` names the ablation's tile math whose walk it is (PREFILTER_OPS'
    keys or "bf16")."""
    counts = (pairs, facing, left_u, left_v)
    if math == "bf16":
        return (sum(n * k for n, k in zip(counts, BF16_PREFILTER_PACKED))
                / BF16X2_RATE
                + sum(n * k for n, k in zip(counts, BF16_PREFILTER_FP32))
                / FP32_RATE)
    return sum(n * k for n, k in zip(counts, PREFILTER_OPS[math])) \
        / FP32_RATE


def mlp_seconds(rows: int, macs: int, in_bytes: int,
                out_bytes: int) -> float:
    """The least time of a bf16 MLP with f32 accumulation on `rows` rows
    of `macs` multiply-adds each, reading `in_bytes` and writing
    `out_bytes` a row: the larger of its tensor-core operations and its
    device-memory bytes (the module docstring)."""
    return max(2 * macs * rows / BF16_TENSOR,
               rows * (in_bytes + out_bytes) / BYTES_RATE)
