"""Dense closest-hit trace and dense dual-shell sweep: CUDA kernels +
PyTorch twins, and the shared Möller–Trumbore math.

Port of `neural_renderer_tpu/ops/trace_pallas.py`: `_kernel` /
`trace_dense_pallas` (the dense closest hit, TPU kernel K3), `_sweep_kernel`
/ `sweep_shells_pallas` (the dense dual-shell sweep, TPU kernel K4) and the
helpers `_mt_tile_t`, `_strict_pair_update`, `_lane_pair_reduce` that the
clustered kernels (`ops/trace_cluster.py`) share.

Kernel `csrc/trace_dense.cu` replaces `trace_pallas.py::_kernel`. One CUDA
thread per ray, 512-ray blocks (the TPU kernel's block, so the per-block
skip flag means the same thing), triangles staged through shared memory in
256-wide tiles, (best_t, best_tri) in registers. Bound on the card: FP32
operations, ~45 per (ray, triangle) pair over the live blocks; the design
keeps every operand in registers or broadcast shared-memory reads so the
inner loop is pure FP32 arithmetic. Built with -fmad=false, it rounds op by
op like `_mt_tile_t` below and is held bit-exact to `trace_dense_twin`.

Kernel `csrc/sweep_dense.cu` replaces `trace_pallas.py::_sweep_kernel`: the
five rows of the clustered sweep without worklists, for shell pairs too
small for clusters to pay. Same block shape and skip flag; outer tiles fold
the strict forward pair and the backward min, inner tiles the two mins, all
in registers. Bound on the card: FP32 operations, ~45 per pair over the
live blocks x the shells' real triangles. Bit-exact to
`sweep_shells_dense_twin`.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

BLOCK_RAYS = 512
TRI_TILE = 512
SWEEP_TRI_TILE = 256  # the dense sweep pads each shell to whole tiles
MIN_T = 1e-6
TRI_EPSILON = 1e-8
MISS = 1e30


def _mt_pairs(o, d, tb):
    """Möller–Trumbore of rays o, d [3, ...] against triangles tb [9, ...],
    the trailing shapes broadcasting against each other: returns (t, det)
    with t = 1e30 where the pair is rejected (det cull, barycentric bounds,
    epsilon). Facing is carried by det's sign: FORWARD (facing < 0) ==
    det > 0. The CUDA kernels evaluate the same expressions in the same
    order (csrc/mt.cuh)."""
    ox, oy, oz = o[0], o[1], o[2]
    dx, dy, dz = d[0], d[1], d[2]
    v0x, v0y, v0z = tb[0], tb[1], tb[2]
    e1x, e1y, e1z = tb[3], tb[4], tb[5]
    e2x, e2y, e2z = tb[6], tb[7], tb[8]

    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = torch.abs(det) >= TRI_EPSILON
    inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))

    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    ok &= (u >= 0.0) & (u <= 1.0)

    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    ok &= (v >= 0.0) & (u + v <= 1.0)

    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok &= (t > TRI_EPSILON) & (t > MIN_T)
    return torch.where(ok, t, torch.full_like(t, MISS)), det


def _mt_tile_t(o, d, tb):
    """`_mt_pairs` of rays o, d [3, N] against triangles tb [9, T]: (t, det),
    each [N, T]."""
    return _mt_pairs(o[:, :, None], d[:, :, None], tb[:, None, :])


def _strict_pair_update(m1, m2, tf):
    """Fold tf into the strict two-min pair (m1, m2): m1 the running min, m2
    the running min of values STRICTLY greater than m1. The pair of a
    multiset does not depend on how it is grouped, so any partition (per
    thread, per cluster, per chunk) gives bit-identical results."""
    n1 = torch.minimum(m1, tf)
    m2 = torch.minimum(torch.where(m1 > n1, m1, m2),
                       torch.where(tf > n1, tf, torch.full_like(tf, MISS)))
    return n1, m2


def _lane_pair_reduce(m1, m2):
    """Per-lane strict pairs [R, L] -> per-ray strict pair ([R], [R])."""
    g1 = m1.min(dim=1).values
    g2 = torch.where(m1 > g1[:, None], m1, m2).min(dim=1).values
    return g1, g2


def _mode_cull(t, det, mode: int):
    if mode == 1:    # FORWARD_ONLY
        return torch.where(det > 0.0, t, torch.full_like(t, MISS))
    if mode == 2:    # BACKWARD_ONLY
        return torch.where(det < 0.0, t, torch.full_like(t, MISS))
    return t


def trace_dense_twin(origins, dirs, tris_packed, mode: int, block_mask):
    """Plain-PyTorch twin of the dense trace kernel: the same outputs,
    [2, Npad] f32 (row 0 best t, 1e30 on miss; row 1 the best triangle id
    bitcast to f32, the smallest id among equal t; blocks with a 0 skip flag
    report a miss with id 0)."""
    n = origins.shape[1]
    best_t = torch.full((n,), MISS, dtype=torch.float32,
                        device=origins.device)
    best_tri = torch.zeros((n,), dtype=torch.int32, device=origins.device)
    for c in range(0, tris_packed.shape[1], TRI_TILE):
        t, det = _mt_tile_t(origins, dirs, tris_packed[:, c:c + TRI_TILE])
        t = _mode_cull(t, det, mode)
        tc, ci = t.min(dim=1)     # first index among equal minima
        better = tc < best_t
        best_t = torch.where(better, tc, best_t)
        best_tri = torch.where(better, (c + ci).to(torch.int32), best_tri)
    live = torch.repeat_interleave(block_mask != 0, BLOCK_RAYS)
    best_t = torch.where(live, best_t, torch.full_like(best_t, MISS))
    best_tri = torch.where(live, best_tri, torch.zeros_like(best_tri))
    return torch.stack([best_t, best_tri.view(torch.float32)], dim=0)


def trace_dense(origins, dirs, tris_packed, mode: int, block_mask):
    """origins/dirs [3, Npad] f32 (Npad a multiple of BLOCK_RAYS);
    tris_packed [9, T] f32 with T a multiple of TRI_TILE; block_mask
    [Npad / BLOCK_RAYS] int32 skip flags. Returns [2, Npad] f32 (see
    trace_dense_twin). CPU tensors run the twin; CUDA tensors launch
    csrc/trace_dense.cu."""
    n = origins.shape[1]
    if n % BLOCK_RAYS or tris_packed.shape[1] % TRI_TILE:
        raise ValueError(f"trace_dense needs Npad % {BLOCK_RAYS} == 0 and "
                         f"T % {TRI_TILE} == 0, got {n}, "
                         f"{tris_packed.shape[1]}")
    if not origins.is_cuda:
        return trace_dense_twin(origins, dirs, tris_packed, mode, block_mask)
    for name, x, dt in (("origins", origins, torch.float32),
                        ("dirs", dirs, torch.float32),
                        ("tris_packed", tris_packed, torch.float32),
                        ("block_mask", block_mask, torch.int32)):
        if not x.is_cuda or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"trace_dense: {name} must be a contiguous "
                             f"CUDA {dt} tensor")
    lib = cuda_build.load("trace_dense")
    out = torch.empty((2, n), dtype=torch.float32, device=origins.device)
    p = cuda_build.ptr
    rc = lib.trace_dense(p(origins), p(dirs), ctypes.c_int(n),
                         p(tris_packed), ctypes.c_int(tris_packed.shape[1]),
                         p(block_mask), ctypes.c_int(mode), p(out),
                         cuda_build.stream_of(origins))
    cuda_build.check(lib, rc, "trace_dense")
    trace_dense.launches += 1
    return out


trace_dense.launches = 0


def sweep_shells_dense_twin(origins, dirs, tris_packed, outer_cols: int,
                            with_fwd2: bool, block_mask):
    """Plain-PyTorch twin of the dense dual-shell sweep kernel: [5 or 4,
    Npad] f32 rows outer_fwd, outer_bwd, inner_fwd, inner_bwd[, outer_fwd2],
    1e30 on a miss and in blocks whose skip flag is 0."""
    n = origins.shape[1]
    miss = torch.full((n,), MISS, dtype=torch.float32, device=origins.device)
    m1f, m2f, m1b, i1f, i1b = miss, miss, miss, miss, miss
    for c in range(0, tris_packed.shape[1], SWEEP_TRI_TILE):
        t, det = _mt_tile_t(origins, dirs,
                            tris_packed[:, c:c + SWEEP_TRI_TILE])
        big = torch.full_like(t, MISS)
        tf = torch.where(det > 0.0, t, big)
        tbk = torch.where(det < 0.0, t, big).min(dim=1).values
        if c < outer_cols:
            if with_fwd2:
                lf1, lf2 = _lane_pair_reduce(tf, big)
                m1f, m2f = _strict_pair_update(m1f, m2f, lf1)
                m1f, m2f = _strict_pair_update(m1f, m2f, lf2)
            else:
                m1f = torch.minimum(m1f, tf.min(dim=1).values)
            m1b = torch.minimum(m1b, tbk)
        else:
            i1f = torch.minimum(i1f, tf.min(dim=1).values)
            i1b = torch.minimum(i1b, tbk)
    rows = torch.stack([m1f, m1b, i1f, i1b] + ([m2f] if with_fwd2 else []),
                       dim=0)
    live = torch.repeat_interleave(block_mask != 0, BLOCK_RAYS)
    return torch.where(live[None, :], rows, torch.full_like(rows, MISS))


def sweep_shells_dense(origins, dirs, tris_packed, outer_cols: int,
                       with_fwd2: bool, block_mask):
    """origins/dirs [3, Npad] f32 (Npad a multiple of BLOCK_RAYS);
    tris_packed [9, T] = outer shell (outer_cols columns) then inner shell,
    each padded to whole SWEEP_TRI_TILE tiles; block_mask [Npad /
    BLOCK_RAYS] int32 skip flags. Returns [5, Npad] (4 rows without fwd2),
    see sweep_shells_dense_twin. CPU tensors run the twin; CUDA tensors
    launch csrc/sweep_dense.cu."""
    n = origins.shape[1]
    if n % BLOCK_RAYS or tris_packed.shape[1] % SWEEP_TRI_TILE \
            or outer_cols % SWEEP_TRI_TILE:
        raise ValueError(f"sweep_shells_dense needs Npad % {BLOCK_RAYS} == 0 "
                         f"and whole {SWEEP_TRI_TILE}-triangle tiles, got "
                         f"{n}, {tris_packed.shape[1]}, {outer_cols}")
    if not origins.is_cuda:
        return sweep_shells_dense_twin(origins, dirs, tris_packed, outer_cols,
                                       with_fwd2, block_mask)
    for name, x, dt in (("origins", origins, torch.float32),
                        ("dirs", dirs, torch.float32),
                        ("tris_packed", tris_packed, torch.float32),
                        ("block_mask", block_mask, torch.int32)):
        if not x.is_cuda or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"sweep_shells_dense: {name} must be a "
                             f"contiguous CUDA {dt} tensor")
    lib = cuda_build.load("sweep_dense")
    out = torch.empty((5 if with_fwd2 else 4, n), dtype=torch.float32,
                      device=origins.device)
    p = cuda_build.ptr
    rc = lib.sweep_dense(p(origins), p(dirs), ctypes.c_int(n),
                         p(tris_packed), ctypes.c_int(tris_packed.shape[1]),
                         ctypes.c_int(outer_cols), p(block_mask),
                         ctypes.c_int(int(with_fwd2)), p(out),
                         cuda_build.stream_of(origins))
    cuda_build.check(lib, rc, "sweep_dense")
    sweep_shells_dense.launches += 1
    return out


sweep_shells_dense.launches = 0
