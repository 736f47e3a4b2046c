"""Möller–Trumbore as matrix products (the `NR_TRACE_MXU=1` variant): the
feature rows, the pair evaluation, and the dense closest-hit kernel + twin.

Port of `neural_renderer_tpu/ops/trace_mxu.py`. Every MT numerator and the
determinant is a scalar triple product of ray vectors (o, d) and triangle
vectors (v0, e1, e2), so each factors into a bilinear form of ray features
and triangle features:
    det   =  d·(e2×e1)
    u·det =  (o×d)·e2     - d·(e2×v0)
    v·det = -(o×d)·e1     - d·(v0×e1)
    t·det =  o·(e1×e2)    - e2·(v0×e1)
With ray features F = [d | o | o×d | 1 | 0 x 6] (RAY_K = 16 rows) and four
triangle feature columns, a ray-by-triangle sweep is four [N, 16] @ [16, T]
products plus a compare epilogue. Facing is -det, so the trace modes and
the sweeps' forward/backward split read det's sign.

`NR_TRACE_MXU=1` switches every trace and sweep wrapper (`trace_dense`,
`sweep_shells_dense`, `sweep_clusters_stream`, `trace_clusters_stream`) to
this formulation; the switch is read per call (`use_mxu`), as the JAX
wrappers read it.

Kernel `csrc/trace_dense_mxu.cu` replaces `trace_mxu.py::_mxu_kernel`. The
four products run on the tensor cores as FP64 `mma.sync` (m16n8k4 and
m16n8k8), the epilogue in FP32 in JAX's order (`csrc/mt_mxu.cuh`), only
on the pair slots a prefilter cannot rule out (`certain_miss` is its rule
on the CPU, `epilogue_pairs` counts what it leaves); the triangles'
features are built once per launch and short launches split the triangles
into slices (the library sizes the launch: `trace_pallas.dense_scratch`).
The TPU kernel's dots run at HIGHEST (bf16x6, about f32). The card's
3xTF32 split of f32 operands keeps 22 of their 24 bits: held against
float64 Möller–Trumbore on the parity tests' spheres
(`scripts/emulate_mxu_split.py`), it leaves t outside 1e-6 on up to 4 of
~3,100 hit rays per case, where FP64 products of the
f32 features (exact, their sums rounded once to f32) leave none.
The twin is `trace_pallas.trace_dense_twin(..., mxu=True)`, its pairs
`mxu_tile_t`, with the same FP64 products (`pair_eval_raw`). Bound on the
card (`ops/bounds.py`): the FP64 tensor products, the function's 38 flops
per pair (48 as issued) at 67 TFLOP/s, against the prefilter's 3 FP32
operations per pair and, on the pairs it leaves, the epilogue's 5 and its
4 FP64-to-FP32 conversions at their own rate.
"""

from __future__ import annotations

import ctypes
import os

import torch

from . import cuda_build, trace_pallas
from .trace_pallas import MIN_T, MISS, TRI_EPSILON

RAY_K = 16  # 10 live feature rows, padded to 16


def use_mxu(mxu: bool | None) -> bool:
    """The wrappers' `mxu` argument: None reads NR_TRACE_MXU per call."""
    if mxu is None:
        return os.environ.get("NR_TRACE_MXU") == "1"
    return bool(mxu)


def _cross_rows(a, b):
    """Row-wise cross product of [3, ...] tensors."""
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]], dim=0)


def ray_features(origins, dirs):
    """[3, ..., N] x2 -> [RAY_K, ..., N] f32: rows [d | o | o×d | 1 | 0]."""
    one = torch.ones_like(origins[:1])
    pad = torch.zeros((RAY_K - 10,) + tuple(origins.shape[1:]),
                      dtype=origins.dtype, device=origins.device)
    return torch.cat([dirs, origins, _cross_rows(origins, dirs), one, pad],
                     dim=0)


def tri_features(tb):
    """[9, ..., T] packed (v0 | e1 | e2) -> (f_det, f_u, f_v, f_t), each
    [RAY_K, ..., T]. Zero padding triangles give all-zero features: det 0,
    culled by the epsilon test."""
    v0, e1, e2 = tb[0:3], tb[3:6], tb[6:9]
    rest = tuple(tb.shape[1:])
    z3 = torch.zeros((3,) + rest, dtype=tb.dtype, device=tb.device)
    z1, zp = z3[:1], torch.zeros((RAY_K - 10,) + rest, dtype=tb.dtype,
                                 device=tb.device)
    v0xe1 = _cross_rows(v0, e1)
    f_det = torch.cat([_cross_rows(e2, e1), z3, z3, z1, zp], dim=0)
    f_u = torch.cat([-_cross_rows(e2, v0), z3, e2, z1, zp], dim=0)
    f_v = torch.cat([-v0xe1, z3, -e1, z1, zp], dim=0)
    p = e2 * v0xe1
    s = (p[0] + p[1]) + p[2]     # jnp.sum's order over three rows
    f_t = torch.cat([z3, _cross_rows(e1, e2), z3, -s[None], zp], dim=0)
    return f_det, f_u, f_v, f_t


def pair_eval_raw(F, tb):
    """[RAY_K, ..., N] ray features x [9, ..., T] triangles -> (t, ok, det),
    each [..., N, T] (leading dims batch). `ok` carries every cull but the
    facing modes. The four products are taken in float64 and rounded to
    f32, as the kernels' FP64 tensor-core products are: f32 products stray
    from the exact ones by up to a few 1e-6 of t on grazing rays, beyond
    the kernel-against-twin bound."""
    rays = F.movedim(0, -1).double()                     # [..., N, K]

    def dot(f):
        return torch.matmul(rays, f.movedim(0, -2).double()).float()

    f_det, f_u, f_v, f_t = tri_features(tb)
    return pair_epilogue(dot(f_det), dot(f_u), dot(f_v), dot(f_t))


def pair_epilogue(det, u_num, v_num, t_num):
    """`pair_eval_raw`'s FP32 epilogue on the four products: (t, ok,
    det)."""
    ok = torch.abs(det) >= TRI_EPSILON
    inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))
    u = u_num * inv_det
    ok &= (u >= 0.0) & (u <= 1.0)
    v = v_num * inv_det
    ok &= (v >= 0.0) & (u + v <= 1.0)
    t = t_num * inv_det
    ok &= t > TRI_EPSILON
    return t, ok, det


def mxu_tile_t(o, d, tb):
    """The matrix formulation with `_mt_tile_t`'s contract: rays [3, ..., N]
    against triangles [9, ..., T] -> (t, det), each [..., N, T], t = 1e30
    where the pair is rejected (every cull but facing, and t <= MIN_T)."""
    t, ok, det = pair_eval_raw(ray_features(o, d), tb)
    return torch.where(ok & (t > MIN_T), t, torch.full_like(t, MISS)), det


def _view(x):
    """The high 32-bit word of each float64 of `x`, read as an f32 bit
    pattern: monotone in |x| (csrc/mt_mxu.cuh::nr_dx_maybe)."""
    return x.contiguous().view(torch.int32)[..., 1::2].view(torch.float32)


def certain_miss(det, u_num, v_num, mode: int = 0):
    """The dense kernels' prefilter on the CPU (csrc/mt_mxu.cuh::nr_dx_maybe,
    where the argument is written out): True where a pair's float64
    products det, u·det and v·det certainly give a rejected pair in
    `pair_epilogue` (or, with mode 1 FORWARD_ONLY / 2 BACKWARD_ONLY, a
    culled facing), whatever t·det."""
    fd, fu, fv = (_view(x) for x in (det, u_num, v_num))
    a = fd.abs()
    step = a * 1.000003814697265625
    out = ((fu * fd < -0.0625) | (fv * fd < -0.0625) | (fu.abs() >= step)
           | (fv.abs() >= step))
    miss = (a < 0.1875) | ((a < 60.0) & out)
    if mode == 1:
        miss |= ~(fd > 0.0)
    elif mode == 2:
        miss |= ~(fd < 0.0)
    return miss


def slot_pairs(rays, feats, mode: int = 0) -> int:
    """The pairs whose products need the FP32 epilogue, counted as the dense
    kernels leave them (csrc/mt_mxu.cuh::nr_dx_walk): rays [..., R, RAY_K]
    float64 ray features (R in whole 16-ray m-tiles) against (f_det, f_u,
    f_v), each [..., RAY_K, T] float64 (T in whole 8-triangle n-tiles);
    every pair of each 8-ray x 4-triangle slot of a tile (rows g or g + 8,
    even or odd columns) in which `certain_miss` leaves some pair."""
    det, u, v = (rays @ f for f in feats)
    return slot_count(~certain_miss(det, u, v, mode))


def slot_count(keep) -> int:
    """The pairs of every 8-ray x 4-triangle pair slot of a 16 x 8 tile
    (rows g or g + 8 of the tile, even or odd columns: the pairs one
    mma.sync accumulator element holds across a warp) in which `keep`
    [..., R, T] (R in whole 16-ray m-tiles, T in whole 8-triangle n-tiles)
    keeps some pair: the pairs a matrix kernel's epilogue finishes."""
    r, t = keep.shape[-2:]
    slots = keep.reshape(-1, r // 16, 2, 8, t // 8, 4, 2).any(dim=(3, 5))
    return int(slots.sum()) * 32


def epilogue_pairs(origins, dirs, tris_packed, block_mask, mode: int = 0,
                   chunk: int = 32768) -> int:
    """The pairs whose products the dense kernels convert and finish in the
    FP32 epilogue: `slot_pairs` of the live blocks' rays against every
    triangle. The work of the kernels' epilogue depends on the data; the
    bound of every FP64 matrix kernel (ops/bounds.py::mxu_seconds) counts
    it from here (the clustered ones through
    trace_cluster.epilogue_pairs)."""
    live = torch.repeat_interleave(block_mask != 0, trace_pallas.BLOCK_RAYS)
    rays = ray_features(origins[:, live], dirs[:, live]).movedim(0, -1) \
        .double()
    feats = [f.double() for f in tri_features(tris_packed)[:3]]
    tile = trace_pallas.TRI_TILE
    return sum(slot_pairs(rays[s:s + chunk], [f[:, c:c + tile]
                                              for f in feats], mode)
               for s in range(0, rays.shape[0], chunk)
               for c in range(0, tris_packed.shape[1], tile))


def trace_dense_mxu(origins, dirs, tris_packed, mode: int, block_mask):
    """The dense closest hit in the matrix formulation, with
    `trace_pallas.trace_dense`'s contract. CPU tensors run the twin; CUDA
    tensors launch csrc/trace_dense_mxu.cu."""
    trace_pallas._check_trace_dense("trace_dense_mxu", origins, tris_packed)
    if not origins.is_cuda:
        return trace_pallas.trace_dense_twin(origins, dirs, tris_packed,
                                             mode, block_mask, mxu=True)
    cuda_build.check_operands("trace_dense_mxu", (
        ("origins", origins, torch.float32), ("dirs", dirs, torch.float32),
        ("tris_packed", tris_packed, torch.float32),
        ("block_mask", block_mask, torch.int32)))
    n, ttot = origins.shape[1], tris_packed.shape[1]
    lib, slices, feat, part = trace_pallas.dense_scratch(
        "trace_dense_mxu", origins, ttot, 2)
    out = torch.empty((2, n), dtype=torch.float32, device=origins.device)
    p = cuda_build.ptr
    rc = lib.trace_dense_mxu(
        p(origins), p(dirs), ctypes.c_int(n), p(tris_packed),
        ctypes.c_int(ttot), p(block_mask), ctypes.c_int(mode),
        ctypes.c_int(slices), p(feat), p(part), p(out),
        cuda_build.stream_of(origins))
    cuda_build.check(lib, rc, "trace_dense_mxu")
    trace_dense_mxu.launches += 1
    return out


trace_dense_mxu.launches = 0


def agreement(t_a, t_b, ids_a=None, ids_b=None, rtol: float = 1e-6,
              atol: float = 1e-6) -> dict:
    """How two traces (or sweep rows) of the same rays agree, 1e30 meaning
    a miss: `flips` the share of rays that hit in one only, `both` the rays
    that hit in both, `max_abs` and `max_rel` the largest |t_a - t_b| and
    |t_a - t_b| / |t_b| over them, `within` whether every such ray has
    |t_a - t_b| <= atol + rtol |t_b|, `ids` the share of them with equal
    ids (1.0 without ids)."""
    ha, hb = t_a < MISS, t_b < MISS
    both = ha & hb
    diff = (t_a - t_b).abs()[both]
    ref = t_b.abs()[both]
    ids = 1.0
    if ids_a is not None and int(both.sum()) > 0:
        ids = (ids_a == ids_b)[both].double().mean().item()
    return dict(
        flips=(ha != hb).double().mean().item(), both=int(both.sum()),
        max_abs=diff.max().item() if diff.numel() else 0.0,
        max_rel=(diff / ref).max().item() if diff.numel() else 0.0,
        within=bool((diff <= atol + rtol * ref).all()), ids=ids)
