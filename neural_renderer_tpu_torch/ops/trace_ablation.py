"""The trace-kernel ablation: variants of the dense Möller–Trumbore trace,
their CUDA kernels and their PyTorch twins.

Port of `scripts/ablate_trace_kernel.py` (TPU kernel K9: `trace_variant`
:149, body `make_kernel` :110, tile math `_mt_tile` :47 and `_probe_tile`
:100). The script times local variants of the dense closest-hit trace on one
workload to name what separates the trace kernels from their op-count
bound. The variants of the tile math:

  local   `_mt_tile_t` exactly (equals the production trace bit for bit)
  probe   a chain of 24 multiplies and 24 adds per pair: the attainable
          rate of unfused FP32 operations
  recip   1/det as a correctly rounded reciprocal (the value of 1.0f/det)
  recipx  1/det as the card's approximate reciprocal
  nodiv   sign-trick culls (u_num * sign vs |det|) and one divide for t
  bf16    every operand, constant and intermediate in bf16

and the block and tile widths of `TRACE_COMBOS`. Output [2, N] f32: min t
(1e30 on a miss; bf16's 1e30 = BF16_MISS in `bf16`) and the smallest
triangle id at that t, bitcast; ANY mode, no skip mask. `probe` writes its
chain's minimum and id 0. Minimum rule for the probe: NaN is dropped
(`fminf`, `torch.fmin`), where `jnp.minimum` keeps it; the probe's inputs
never make one.

Kernel `csrc/ablate_trace.cu` replaces `trace_variant`: K3's walk
(`csrc/mt_dense.cuh`, so `local` is the production trace K3), templated
over the tile math and its shape, each tile math behind its prefilter rule
(`variant_rule`; `local` and `recip` K3's), the thread's two rays folded
into the closest hit by a strict `<` over increasing ids, triangle slices
merged per ray. The reference's block and tile become the CTA's rays and
the staged chunk's triangles, tile / 2 (`walk_shape`): `local`'s (512,
128) is K3's launch. The probe keeps its own loop (one thread per ray,
tiles staged in shared memory). Every combination the script names is
instantiated in one library. Bound on the card (`ops/bounds.py`): FP32
operations, 46 per pair (47 for `nodiv`, 50 for the probe), at the rate of
unfused FP32 instructions; `bf16` at the packed rate, two per lane per
clock, but for its f32 divide; filtered, the rule's operations on every
pair and the rest of the math on the pairs it leaves.

The sweep family (`run_sweep_family` :182) re-traces the dense dual-shell
sweep K4 with its tile math replaced: `csrc/ablate_sweep.cu` runs K4's walk
with `nodiv`, `recip`, `recipx` and `bf16` and their rules (the tile maths
of both kernels: `csrc/mt_variants.cuh`); the twin is
`trace_pallas.sweep_shells_dense_twin` with the variant's pairs
(`variant_pairs`; with `prefilter=True` the pairs the rule leaves, the
kernel's walk on the CPU, as `trace_variant_twin(..., prefilter=True)`).

`mxu_hi3` and `mxu_lo` are K8's matrix formulation with the dots at
`Precision.HIGH` and `DEFAULT` (:361-395). On the TPU these are bf16_3x
(hi·hi + hi·lo + lo·hi of bf16 halves) and one bf16 pass; the kernel
`csrc/ablate_mxu_bf16.cu` takes those bf16 products on the tensor cores,
K8's way (features once, a sliced walk, a prefilter on its f32
accumulators, `mxu_bf16_rule`). Its twin rounds the operands to bf16 and
sums the exact products in float64, rounded once to f32.

CPU tensors run the twins; CUDA tensors launch the kernels or raise. Each
wrapper counts its launches per kernel in `launches`.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from . import cuda_build, trace_mxu, trace_pallas
from .trace_pallas import MIN_T, MISS, TRI_EPSILON

# bf16(1e30), the `bf16` variant's miss value once widened to f32
# (scripts/ablate_trace_kernel.py:114-116, :134).
BF16_MISS = 1.00025555e30

# Tile-math codes of the C entries (csrc/ablate_trace.cu, ablate_sweep.cu).
VARIANT_CODES = {"local": 0, "probe": 1, "recip": 2, "recipx": 3,
                 "nodiv": 4, "bf16": 5}
# The script's variants (scripts/ablate_trace_kernel.py:397-418) ->
# (tile math, block rays, tile triangles). Each is a kernel of
# csrc/ablate_trace.cu; it refuses any other combination.
TRACE_COMBOS = {
    "local": ("local", 512, 128), "probe": ("probe", 512, 128),
    "recip": ("recip", 512, 128), "recipx": ("recipx", 512, 128),
    "nodiv": ("nodiv", 512, 128), "bf16": ("bf16", 512, 128),
    "b256": ("local", 256, 128), "b1024": ("local", 1024, 128),
    "t256": ("local", 512, 256), "t512": ("local", 512, 512),
    "b256t256": ("local", 256, 256), "t256probe": ("probe", 512, 256),
    "t256nodiv": ("nodiv", 512, 256), "t1024": ("local", 512, 1024),
    "b1024t512": ("local", 1024, 512), "t512probe": ("probe", 512, 512),
}
SWEEP_VARIANTS = ("nodiv", "recip", "recipx", "bf16")
MXU_BF16_PASSES = {"mxu_hi3": 3, "mxu_lo": 1}
MXU_BF16_TILE = 64    # triangles the kernel stages per chunk
PROBE_CHAIN = 48      # the probe's chain of multiplies and adds, per pair
# The bf16 matrix kernels' rule: |rn(2 num - det)| at least rn(|det| (1 +
# 2^-19)) rejects the pair (csrc/ablate_mxu_bf16.cu argues it).
MXU_BF16_H = 1.0 + 2.0 ** -19
# The prefilter rules of the walk kernels (csrc/mt_variants.cuh; `local`
# and `recip` take K3's and K4's, csrc/mt_dense.cuh): a numerator w = num
# sgn(det) below |det| lo or at least |det| hi rejects the pair. `nodiv`'s
# rule is its own culls, w < 0 or w > |det| (no margin). Each margin is
# proven in the kernels' source for its division.
RULE_MARGINS = {
    "local": (trace_pallas.DENSE_LO, trace_pallas.DENSE_HI),
    "recip": (trace_pallas.DENSE_LO, trace_pallas.DENSE_HI),
    "recipx": (-2.0 ** -18, 1.0 + 2.0 ** -18),
    "bf16": (-2.0 ** -20, 1.0 + 2.0 ** -4),
}


def _mt_numerators(o, d, tb):
    """det, u·det, v·det and t·det of `_mt_tile` for rays o, d [3, ...]
    against triangles tb [9, ...] (broadcasting against each other), in its
    operation order and the operands' dtype."""
    det, u_num, tvec = trace_pallas._mt_det_u(o, d, tb)
    v_num, (qx, qy, qz) = trace_pallas._mt_v_num(d, tb, tvec)
    return det, u_num, v_num, tb[6] * qx + tb[7] * qy + tb[8] * qz


def _mt_culls(det, u_num, v_num, t_num, variant: str, inv=None):
    """`_mt_tile`'s culls of `variant` on the numerators (their dtype:
    bf16 for `bf16`, else f32): (t, ok), ok False where the pair is
    rejected. `inv` replaces 1/det (exact, or for `bf16` rounded from f32;
    an approximate reciprocal such as `recipx`'s on the card)."""
    dt = det.dtype

    def const(x):
        return torch.tensor(x, dtype=dt, device=det.device)

    one, eps, min_t = const(1.0), const(TRI_EPSILON), const(MIN_T)
    ok = torch.abs(det) >= eps
    if variant == "nodiv":
        s = torch.where(det < 0, -one, one)
        ad = torch.abs(det)
        us = u_num * s
        vs = v_num * s
        ok &= (us >= 0.0) & (us <= ad)
        ok &= (vs >= 0.0) & (us + vs <= ad)
        ts = t_num * s
        ok &= ts > eps * ad
        t = ts / ad
        ok &= (t > eps) & (t > min_t)
        return t, ok
    inv_det = 1.0 / torch.where(ok, det, one) if inv is None else inv
    u = u_num * inv_det
    ok &= (u >= 0.0) & (u <= 1.0)
    v = v_num * inv_det
    ok &= (v >= 0.0) & (u + v <= 1.0)
    t = t_num * inv_det
    ok &= (t > eps) & (t > min_t)
    return t, ok


def _mt_variant(o, d, tb, variant: str):
    """`_mt_tile` of scripts/ablate_trace_kernel.py: rays [3, N] x
    triangles [9, T] -> (t, det), each [N, T], t = 1e30 (bf16's in `bf16`)
    where the pair is rejected, in the script's operation order. `bf16`
    computes in bf16 (each operation rounds once, a divide in f32 first);
    `recipx`'s twin takes the exact reciprocal, as `recip`."""
    dt = torch.bfloat16 if variant == "bf16" else torch.float32
    det, u_num, v_num, t_num = _mt_numerators(
        o.to(dt)[:, :, None], d.to(dt)[:, :, None], tb.to(dt)[:, None, :])
    t, ok = _mt_culls(det, u_num, v_num, t_num, variant)
    return torch.where(ok, t, torch.full_like(t, MISS)), det


def _probe(o, d, tb):
    """`_probe_tile`: x = a, then x = x * a + b 24 times, a = ox * v0x,
    b = dx + v0y; [N, T]."""
    a = o[0][:, None] * tb[0][None, :]
    b = d[0][:, None] + tb[1][None, :]
    x = a
    for _ in range(PROBE_CHAIN // 2):
        x = x * a + b
    return x


def variant_rule(variant: str, det, u_num, v_num):
    """The prefilter rule of `variant`'s walk kernels on the CPU
    (csrc/mt_variants.cuh, where each is argued) on a pair's det, u·det and
    v·det as its pair math computes them (f32, or bf16 for `bf16`, widened
    exactly): (facing, keep_u, keep_v) as `trace_pallas.dense_rule`'s,
    False where the u test, then the v test leave a pair that the variant
    certainly rejects (facing: every pair, the ablation runs ANY)."""
    if variant not in RULE_MARGINS and variant != "nodiv":
        raise ValueError(f"no prefilter rule for {variant!r}")
    det, u_num, v_num = (x.float() for x in (det, u_num, v_num))
    face = torch.ones_like(det, dtype=torch.bool)
    a = det.abs()
    if variant == "nodiv":
        def out(num):
            w = torch.where(torch.signbit(det), -num, num)
            return (w < 0.0) | (w > a)
    else:
        lo_f, hi_f = RULE_MARGINS[variant]
        lo, hi = a * lo_f, a * hi_f

        def out(num):
            return trace_pallas._dense_out(num, det, lo, hi)
    keep_u = ~out(u_num)
    return face, keep_u, keep_u & ~out(v_num)


def variant_prefilter(o, d, tb, variant: str, mode: int = 0):
    """`variant_rule` on the variant's own det, u·det and v·det of rays o,
    d [3, ...] against triangles tb [9, ...], broadcasting as
    `trace_pallas.dense_prefilter` (whose contract it has; ANY only)."""
    if mode != 0:
        raise ValueError("the ablation's rules are for ANY")
    if variant == "bf16":
        o, d, tb = (x.to(torch.bfloat16) for x in (o, d, tb))
    det, u_num, tvec = trace_pallas._mt_det_u(o, d, tb)
    v_num, _ = trace_pallas._mt_v_num(d, tb, tvec)
    return variant_rule(variant, det, u_num, v_num)


def variant_prefilter_pairs(origins, dirs, tris_packed, block_mask,
                            variant: str) -> tuple[int, int, int]:
    """`trace_pallas.prefilter_pairs` with `variant`'s rule: the pairs its
    kernel's prefilter leaves, which its filtered bound counts
    (bounds.dense_seconds)."""
    return trace_pallas.prefilter_pairs(
        origins, dirs, tris_packed, block_mask,
        prefilter=lambda o, d, tb, mode: variant_prefilter(o, d, tb,
                                                           variant, mode))


def variant_pairs(variant: str, prefilter: bool = False):
    """The pair function of a tile-math variant, with `_mt_tile_t`'s
    contract: (o, d, tb) -> (t, det). With `prefilter`, the pairs its
    kernel's rule rejects get its miss value without the rest of the math
    deciding: the kernel's walk, which equals the unfiltered pairs where the
    rule is sound."""
    if variant not in VARIANT_CODES or variant == "probe":
        raise ValueError(f"no pair math {variant!r}")

    def pairs(o, d, tb):
        t, det = _mt_variant(o, d, tb, variant)
        if prefilter:
            keep = variant_prefilter(o[:, :, None], d[:, :, None],
                                     tb[:, None, :], variant)[2]
            miss = BF16_MISS if variant == "bf16" else MISS
            t = torch.where(keep, t, torch.full_like(t, miss))
        return t, det

    return pairs


def _closest_hit(origins, dirs, tris_packed, tile: int, pairs, miss: float):
    """Per ray the min t over tiles of `tile` triangles and the smallest id
    at that t: [2, N] f32 (row 1 the id bitcast)."""
    n = origins.shape[1]
    best_t = torch.full((n,), miss, dtype=torch.float32,
                        device=origins.device)
    best_tri = torch.zeros((n,), dtype=torch.int32, device=origins.device)
    for c in range(0, tris_packed.shape[1], tile):
        t, _ = pairs(origins, dirs, tris_packed[:, c:c + tile])
        tc, ci = t.float().min(dim=1)     # first index among equal minima
        better = tc < best_t
        best_t = torch.where(better, tc, best_t)
        best_tri = torch.where(better, (c + ci).to(torch.int32), best_tri)
    return torch.stack([best_t, best_tri.view(torch.float32)], dim=0)


def walk_shape(block: int, tile: int) -> tuple[int, int, int]:
    """(rays a CTA, triangles a staged chunk, CTAs an SM a one-slice launch
    reaches) of csrc/ablate_trace.cu's walk at the reference's (block,
    tile): block rays, tile / 2 triangles, slices until the launch holds
    the rays an SM of K3's (16 CTAs of 512; `local`'s (512, 128) is K3's
    launch). The library's `ablate_trace_shape` takes the slice count from
    these (csrc/dense_slices.cuh::nr_dense_slices)."""
    return block, tile // 2, 16 * 512 // block


def trace_variant_twin(origins, dirs, tris_packed, variant: str,
                       tile: int, prefilter: bool = False):
    """Plain-PyTorch twin of `trace_variant` (the kernel's block shapes
    only its grid). With `prefilter`, the pairs the variant's rule rejects
    miss without the rest of its math deciding: the kernel's walk on the
    CPU, which equals the unfiltered twin where the rule is sound (the
    probe has no rule)."""
    if variant != "probe":
        miss = BF16_MISS if variant == "bf16" else MISS
        return _closest_hit(origins, dirs, tris_packed, tile,
                            variant_pairs(variant, prefilter), miss)
    if prefilter:
        raise ValueError("the probe has no prefilter rule")
    n = origins.shape[1]
    best = torch.full((n,), MISS, dtype=torch.float32, device=origins.device)
    for c in range(0, tris_packed.shape[1], tile):
        x = _probe(origins, dirs, tris_packed[:, c:c + tile])
        best = torch.fmin(best, torch.where(torch.isnan(x), MISS, x)
                          .amin(dim=1))
    ids = torch.zeros((n,), dtype=torch.int32, device=origins.device)
    return torch.stack([best, ids.view(torch.float32)], dim=0)


def _check(what, origins, tris_packed, block: int, tile: int):
    n, t = origins.shape[1], tris_packed.shape[1]
    if n % block or t % tile:
        raise ValueError(f"{what} needs N % {block} == 0 and T % {tile} == "
                         f"0, got {n}, {t}")


def trace_variant(origins, dirs, tris_packed, variant: str, block: int,
                  tile: int):
    """origins/dirs [3, N] f32, tris_packed [9, T] f32 (N a multiple of
    `block`, T of `tile`) -> [2, N] f32, see the module docstring. The
    (variant, block, tile) must be one of TRACE_COMBOS'. CPU tensors run
    the twin; CUDA tensors launch csrc/ablate_trace.cu (the walk's slices
    sized by the library, `trace_pallas.dense_scratch`)."""
    if (variant, block, tile) not in TRACE_COMBOS.values():
        raise ValueError(f"no kernel for variant {variant!r} at block "
                         f"{block}, tile {tile}")
    _check("trace_variant", origins, tris_packed, block, tile)
    if not origins.is_cuda:
        return trace_variant_twin(origins, dirs, tris_packed, variant, tile)
    cuda_build.check_operands("ablate_trace", (
        ("origins", origins, torch.float32), ("dirs", dirs, torch.float32),
        ("tris_packed", tris_packed, torch.float32)))
    n, ttot = origins.shape[1], tris_packed.shape[1]
    if variant == "probe":       # its own loop: no slices
        lib, slices = cuda_build.load("ablate_trace"), 1
        part = torch.empty(0, device=origins.device)
    else:
        lib, slices, _, part = trace_pallas.dense_scratch(
            "ablate_trace", origins, ttot, 2, shape=(block, tile))
    out = torch.empty((2, n), dtype=torch.float32, device=origins.device)
    p = cuda_build.ptr
    rc = lib.ablate_trace(
        ctypes.c_int(VARIANT_CODES[variant]), ctypes.c_int(block),
        ctypes.c_int(tile), p(origins), p(dirs), ctypes.c_int(n),
        p(tris_packed), ctypes.c_int(ttot), ctypes.c_int(slices), p(part),
        p(out), cuda_build.stream_of(origins))
    cuda_build.check(lib, rc, "ablate_trace")
    trace_variant.launches[f"{variant}/{block}/{tile}"] += 1
    return out


trace_variant.launches = collections.Counter()


def sweep_variant(origins, dirs, tris_packed, outer_cols: int,
                  with_fwd2: bool, block_mask, variant: str):
    """The dense dual-shell sweep (`trace_pallas.sweep_shells_dense`'s
    contract) with the tile math of `variant` (SWEEP_VARIANTS). CPU tensors
    run `sweep_shells_dense_twin` with the variant's pairs; CUDA tensors
    launch csrc/ablate_sweep.cu."""
    if variant not in SWEEP_VARIANTS:
        raise ValueError(f"no sweep kernel for variant {variant!r}")
    args = (origins, dirs, tris_packed, outer_cols, with_fwd2, block_mask)
    trace_pallas._check_sweep_dense("sweep_variant", origins, tris_packed,
                                    outer_cols)
    if not origins.is_cuda:
        return trace_pallas.sweep_shells_dense_twin(
            *args, pairs=variant_pairs(variant))
    cuda_build.check_operands("ablate_sweep", (
        ("origins", origins, torch.float32), ("dirs", dirs, torch.float32),
        ("tris_packed", tris_packed, torch.float32),
        ("block_mask", block_mask, torch.int32)))
    n, ttot = origins.shape[1], tris_packed.shape[1]
    rows = 5 if with_fwd2 else 4
    lib, slices, _, part = trace_pallas.dense_scratch("ablate_sweep", origins,
                                                      ttot, rows)
    out = torch.empty((rows, n), dtype=torch.float32, device=origins.device)
    p = cuda_build.ptr
    rc = lib.ablate_sweep(
        ctypes.c_int(VARIANT_CODES[variant]), p(origins), p(dirs),
        ctypes.c_int(n), p(tris_packed), ctypes.c_int(ttot),
        ctypes.c_int(outer_cols), p(block_mask), ctypes.c_int(int(with_fwd2)),
        ctypes.c_int(slices), p(part), p(out), cuda_build.stream_of(origins))
    cuda_build.check(lib, rc, "ablate_sweep")
    sweep_variant.launches[variant] += 1
    return out


sweep_variant.launches = collections.Counter()


def _bf16_parts(x, passes: int):
    """x split into bf16 parts: [hi] for one pass, [hi, lo] with lo =
    bf16(x - hi) for three."""
    hi = x.to(torch.bfloat16)
    if passes == 1:
        return [hi]
    return [hi, (x - hi.float()).to(torch.bfloat16)]


def mxu_bf16_rule(det, u_num, v_num):
    """The bf16 matrix kernels' prefilter rule on the CPU
    (csrc/ablate_mxu_bf16.cu::bm_maybe, where it is argued) on a pair's f32
    det, u·det and v·det: False where pair_eval_raw's epilogue certainly
    rejects the pair, |rn(2 num - det)| >= rn(|det| (1 + 2^-19)) for num =
    u·det or v·det (or NaN). The kernel's fused multiply-add is taken here
    in float64 and rounded to f32: the difference is exact in float64 where
    the operands' exponents differ by 28 or less, and elsewhere the smaller
    one is too small to move the f32 rounding, so the value is the same."""
    h = det.abs() * MXU_BF16_H
    d64 = det.double()

    def near(num):
        return (2.0 * num.double() - d64).float().abs() < h

    return near(u_num) & near(v_num)


def mxu_bf16_products(o, d, tb, passes: int):
    """The four products of the matrix formulation with the TPU's bf16
    passes: one pass hi(F)·hi(f), or three, hi·hi + hi·lo + lo·hi; rays
    [3, N] x triangles [9, T] -> [det, u·det, v·det, t·det], each [N, T]
    f32. The bf16 products are exact in float64 and their sum is rounded
    once to f32."""
    fparts = _bf16_parts(trace_mxu.ray_features(o, d), passes)

    def dot(f):
        tparts = _bf16_parts(f, passes)
        terms = ([(0, 0)] if passes == 1 else [(0, 0), (0, 1), (1, 0)])
        acc = sum(torch.matmul(fparts[i].double().t(), tparts[j].double())
                  for i, j in terms)
        return acc.float()

    return [dot(f) for f in trace_mxu.tri_features(tb)]


def mxu_bf16_tile_t(o, d, tb, passes: int, prefilter: bool = False):
    """`mxu_bf16_products` through pair_eval_raw's epilogue: (t, det), each
    [N, T], with `trace_mxu.mxu_tile_t`'s contract. With `prefilter`, the
    pairs the kernel's rule (`mxu_bf16_rule` on the products) rejects miss
    without the epilogue deciding."""
    det, u_num, v_num, t_num = mxu_bf16_products(o, d, tb, passes)
    t, ok, det = trace_mxu.pair_epilogue(det, u_num, v_num, t_num)
    ok &= t > MIN_T
    if prefilter:
        ok &= mxu_bf16_rule(det, u_num, v_num)
    return torch.where(ok, t, torch.full_like(t, MISS)), det


def mxu_bf16_epilogue_pairs(origins, dirs, tris_packed, passes: int,
                            chunk: int = 32768) -> int:
    """The pairs the bf16 matrix kernel finishes in the epilogue: every pair
    of each 8-ray x 4-triangle slot in which the rule leaves some pair
    (`trace_mxu.slot_count` of `mxu_bf16_rule` on the twin's products),
    over all rays (no skip mask) and every triangle. Its bound counts the
    epilogue on these (bounds.mxu_seconds)."""
    n, ttot = origins.shape[1], tris_packed.shape[1]
    tile = trace_pallas.TRI_TILE
    total = 0
    for s in range(0, n, chunk):
        for c in range(0, ttot, tile):
            det, u_num, v_num, _ = mxu_bf16_products(
                origins[:, s:s + chunk], dirs[:, s:s + chunk],
                tris_packed[:, c:c + tile], passes)
            total += trace_mxu.slot_count(mxu_bf16_rule(det, u_num, v_num))
    return total


def trace_mxu_bf16_twin(origins, dirs, tris_packed, passes: int,
                        prefilter: bool = False):
    """Plain-PyTorch twin of `trace_mxu_bf16` (with `prefilter`, of its
    walk: see `mxu_bf16_tile_t`)."""
    return _closest_hit(
        origins, dirs, tris_packed, trace_pallas.TRI_TILE,
        lambda o, d, tb: mxu_bf16_tile_t(o, d, tb, passes, prefilter), MISS)


def trace_mxu_bf16(origins, dirs, tris_packed, passes: int):
    """K8's dense closest hit (ANY, no skip mask) with its four products
    taken from bf16 operands in `passes` 1 or 3 (MXU_BF16_PASSES):
    origins/dirs [3, N] f32 (N a multiple of 512), tris_packed [9, T] f32
    (T a multiple of MXU_BF16_TILE) -> [2, N] as `trace_variant`. CPU
    tensors run the twin; CUDA tensors launch csrc/ablate_mxu_bf16.cu (its
    slices and feature scratch sized by the library,
    `trace_pallas.dense_scratch`)."""
    if passes not in MXU_BF16_PASSES.values():
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    _check("trace_mxu_bf16", origins, tris_packed, trace_pallas.BLOCK_RAYS,
           MXU_BF16_TILE)
    if not origins.is_cuda:
        return trace_mxu_bf16_twin(origins, dirs, tris_packed, passes)
    cuda_build.check_operands("ablate_mxu_bf16", (
        ("origins", origins, torch.float32), ("dirs", dirs, torch.float32),
        ("tris_packed", tris_packed, torch.float32)))
    n, ttot = origins.shape[1], tris_packed.shape[1]
    lib, slices, feat, part = trace_pallas.dense_scratch(
        "ablate_mxu_bf16", origins, ttot, 2)
    out = torch.empty((2, n), dtype=torch.float32, device=origins.device)
    p = cuda_build.ptr
    rc = lib.ablate_mxu_bf16(
        ctypes.c_int(passes), p(origins), p(dirs), ctypes.c_int(n),
        p(tris_packed), ctypes.c_int(ttot), ctypes.c_int(slices), p(feat),
        p(part), p(out), cuda_build.stream_of(origins))
    cuda_build.check(lib, rc, "ablate_mxu_bf16")
    trace_mxu_bf16.launches[passes] += 1
    return out


trace_mxu_bf16.launches = collections.Counter()
