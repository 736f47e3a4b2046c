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
four products run on the tensor cores as FP64 `mma.sync.m8n8k4`, the
epilogue in FP32 in JAX's order (`csrc/mt_mxu.cuh`). The TPU kernel's dots
run at HIGHEST (bf16x6, about f32). The card's 3xTF32 split of f32 operands
keeps 22 of their 24 bits: held against float64 Möller–Trumbore on the
parity tests' spheres (`scripts/emulate_mxu_split.py`), it leaves t outside
1e-6 on up to 4 of ~3,100 hit rays per case, where FP64 products of the
f32 features (exact, their sums rounded once to f32) leave none.
The twin is `trace_pallas.trace_dense_twin(..., mxu=True)`, its pairs
`mxu_tile_t`, with the same FP64 products (`pair_eval_raw`). Bound on the
card (`ops/bounds.py`): the FP64 tensor products, the function's 38 flops
per pair (48 as issued) at 67 TFLOP/s, against the FP32 epilogue (9
operations per pair: 5 arithmetic, 4 FP64-to-FP32 conversions).
"""

from __future__ import annotations

import os

import torch

from . import trace_pallas
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


def trace_dense_mxu(origins, dirs, tris_packed, mode: int, block_mask):
    """The dense closest hit in the matrix formulation, with
    `trace_pallas.trace_dense`'s contract. CPU tensors run the twin; CUDA
    tensors launch csrc/trace_dense_mxu.cu."""
    trace_pallas._check_trace_dense("trace_dense_mxu", origins, tris_packed)
    if not origins.is_cuda:
        return trace_pallas.trace_dense_twin(origins, dirs, tris_packed,
                                             mode, block_mask, mxu=True)
    out = trace_pallas._launch_trace_dense("trace_dense_mxu", origins, dirs,
                                           tris_packed, mode, block_mask)
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
