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

Kernel `csrc/ablate_trace.cu` replaces `trace_variant`: K3's skeleton (one
thread per ray, triangle tiles staged in shared memory, a strict `<` over
increasing ids), templated over (tile math, block, tile) with every
combination the script names instantiated in one library. Bound on the
card (`ops/bounds.py`): FP32 operations, 46 per pair (47 for `nodiv`, 50
for the probe), at the rate of unfused FP32 instructions; `bf16` at the
packed rate, two per lane per clock, but for its f32 divide.

The sweep family (`run_sweep_family` :182) re-traces the dense dual-shell
sweep K4 with its tile math replaced: `csrc/ablate_sweep.cu` instantiates
K4's templated loop (`csrc/sweep_dense.cuh`) with `nodiv`, `recip`,
`recipx` and `bf16`; the twin is `trace_pallas.sweep_shells_dense_twin`
with the variant's pairs.

`mxu_hi3` and `mxu_lo` are K8's matrix formulation with the dots at
`Precision.HIGH` and `DEFAULT` (:361-395). On the TPU these are bf16_3x
(hi·hi + hi·lo + lo·hi of bf16 halves) and one bf16 pass; the kernel
`csrc/ablate_mxu_bf16.cu` takes those bf16 products on the tensor cores.
Its twin rounds the operands to bf16 and sums the exact products in
float64, rounded once to f32.

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
MXU_BF16_TILE = 128   # triangles the kernel stages per step
PROBE_CHAIN = 48      # the probe's chain of multiplies and adds, per pair


def _mt_variant(o, d, tb, variant: str):
    """`_mt_tile` of scripts/ablate_trace_kernel.py: rays [3, N] x
    triangles [9, T] -> (t, det), each [N, T], t = 1e30 (bf16's in `bf16`)
    where the pair is rejected, in the script's operation order. `bf16`
    computes in bf16 (each operation rounds once, a divide in f32 first);
    `recipx`'s twin takes the exact reciprocal, as `recip`."""
    dt = torch.bfloat16 if variant == "bf16" else torch.float32

    def const(x):
        return torch.tensor(x, dtype=dt, device=o.device)

    one, big = const(1.0), const(MISS)
    eps, min_t = const(TRI_EPSILON), const(MIN_T)
    ox, oy, oz = (o[i].to(dt)[:, None] for i in range(3))
    dx, dy, dz = (d[i].to(dt)[:, None] for i in range(3))
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
        tb[i].to(dt)[None, :] for i in range(9))

    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u_num = tx * px + ty * py + tz * pz
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v_num = dx * qx + dy * qy + dz * qz
    t_num = e2x * qx + e2y * qy + e2z * qz

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
        return torch.where(ok, t, big), det
    inv_det = 1.0 / torch.where(ok, det, one)
    u = u_num * inv_det
    ok &= (u >= 0.0) & (u <= 1.0)
    v = v_num * inv_det
    ok &= (v >= 0.0) & (u + v <= 1.0)
    t = t_num * inv_det
    ok &= (t > eps) & (t > min_t)
    return torch.where(ok, t, big), det


def _probe(o, d, tb):
    """`_probe_tile`: x = a, then x = x * a + b 24 times, a = ox * v0x,
    b = dx + v0y; [N, T]."""
    a = o[0][:, None] * tb[0][None, :]
    b = d[0][:, None] + tb[1][None, :]
    x = a
    for _ in range(PROBE_CHAIN // 2):
        x = x * a + b
    return x


def variant_pairs(variant: str):
    """The pair function of a tile-math variant, with `_mt_tile_t`'s
    contract: (o, d, tb) -> (t, det)."""
    if variant not in VARIANT_CODES or variant == "probe":
        raise ValueError(f"no pair math {variant!r}")
    return lambda o, d, tb: _mt_variant(o, d, tb, variant)


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


def trace_variant_twin(origins, dirs, tris_packed, variant: str,
                       tile: int):
    """Plain-PyTorch twin of `trace_variant` (the kernel's block shapes
    only its grid)."""
    if variant != "probe":
        miss = BF16_MISS if variant == "bf16" else MISS
        return _closest_hit(origins, dirs, tris_packed, tile,
                            variant_pairs(variant), miss)
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
    the twin; CUDA tensors launch csrc/ablate_trace.cu."""
    if (variant, block, tile) not in TRACE_COMBOS.values():
        raise ValueError(f"no kernel for variant {variant!r} at block "
                         f"{block}, tile {tile}")
    _check("trace_variant", origins, tris_packed, block, tile)
    if not origins.is_cuda:
        return trace_variant_twin(origins, dirs, tris_packed, variant, tile)
    cuda_build.check_operands("ablate_trace", (
        ("origins", origins, torch.float32), ("dirs", dirs, torch.float32),
        ("tris_packed", tris_packed, torch.float32)))
    n = origins.shape[1]
    lib = cuda_build.load("ablate_trace")
    out = torch.empty((2, n), dtype=torch.float32, device=origins.device)
    p = cuda_build.ptr
    rc = lib.ablate_trace(
        ctypes.c_int(VARIANT_CODES[variant]), ctypes.c_int(block),
        ctypes.c_int(tile), p(origins), p(dirs), ctypes.c_int(n),
        p(tris_packed), ctypes.c_int(tris_packed.shape[1]), p(out),
        cuda_build.stream_of(origins))
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
    n = origins.shape[1]
    lib = cuda_build.load("ablate_sweep")
    out = torch.empty((5 if with_fwd2 else 4, n), dtype=torch.float32,
                      device=origins.device)
    p = cuda_build.ptr
    rc = lib.ablate_sweep(
        ctypes.c_int(VARIANT_CODES[variant]), p(origins), p(dirs),
        ctypes.c_int(n), p(tris_packed), ctypes.c_int(tris_packed.shape[1]),
        ctypes.c_int(outer_cols), p(block_mask), ctypes.c_int(int(with_fwd2)),
        p(out), cuda_build.stream_of(origins))
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


def mxu_bf16_tile_t(o, d, tb, passes: int):
    """The matrix formulation with the TPU's bf16 products: one pass
    hi(F)·hi(f), or three, hi·hi + hi·lo + lo·hi; rays [3, N] x triangles
    [9, T] -> (t, det), each [N, T], with `trace_mxu.mxu_tile_t`'s
    contract. The bf16 products are exact in float64 and their sum is
    rounded once to f32."""
    fparts = _bf16_parts(trace_mxu.ray_features(o, d), passes)

    def dot(f):
        tparts = _bf16_parts(f, passes)
        terms = ([(0, 0)] if passes == 1 else [(0, 0), (0, 1), (1, 0)])
        acc = sum(torch.matmul(fparts[i].double().t(), tparts[j].double())
                  for i, j in terms)
        return acc.float()

    t, ok, det = trace_mxu.pair_epilogue(
        *(dot(f) for f in trace_mxu.tri_features(tb)))
    return torch.where(ok & (t > MIN_T), t, torch.full_like(t, MISS)), det


def trace_mxu_bf16_twin(origins, dirs, tris_packed, passes: int):
    """Plain-PyTorch twin of `trace_mxu_bf16`."""
    return _closest_hit(origins, dirs, tris_packed, trace_pallas.TRI_TILE,
                        lambda o, d, tb: mxu_bf16_tile_t(o, d, tb, passes),
                        MISS)


def trace_mxu_bf16(origins, dirs, tris_packed, passes: int):
    """K8's dense closest hit (ANY, no skip mask) with its four products
    taken from bf16 operands in `passes` 1 or 3 (MXU_BF16_PASSES):
    origins/dirs [3, N] f32 (N a multiple of 512), tris_packed [9, T] f32
    (T a multiple of MXU_BF16_TILE) -> [2, N] as `trace_variant`. CPU
    tensors run the twin; CUDA tensors launch csrc/ablate_mxu_bf16.cu."""
    if passes not in MXU_BF16_PASSES.values():
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    _check("trace_mxu_bf16", origins, tris_packed, trace_pallas.BLOCK_RAYS,
           MXU_BF16_TILE)
    if not origins.is_cuda:
        return trace_mxu_bf16_twin(origins, dirs, tris_packed, passes)
    cuda_build.check_operands("ablate_mxu_bf16", (
        ("origins", origins, torch.float32), ("dirs", dirs, torch.float32),
        ("tris_packed", tris_packed, torch.float32)))
    n = origins.shape[1]
    lib = cuda_build.load("ablate_mxu_bf16")
    out = torch.empty((2, n), dtype=torch.float32, device=origins.device)
    p = cuda_build.ptr
    rc = lib.ablate_mxu_bf16(
        ctypes.c_int(passes), p(origins), p(dirs), ctypes.c_int(n),
        p(tris_packed), ctypes.c_int(tris_packed.shape[1]), p(out),
        cuda_build.stream_of(origins))
    cuda_build.check(lib, rc, "ablate_mxu_bf16")
    trace_mxu_bf16.launches[passes] += 1
    return out


trace_mxu_bf16.launches = collections.Counter()
