"""Dense closest-hit trace and dense dual-shell sweep: CUDA kernels +
PyTorch twins, and the shared Möller–Trumbore math.

Port of `neural_renderer_tpu/ops/trace_pallas.py`: `_kernel` /
`trace_dense_pallas` (the dense closest hit, TPU kernel K3), `_sweep_kernel`
/ `sweep_shells_pallas` (the dense dual-shell sweep, TPU kernel K4) and the
helpers `_mt_tile_t`, `_strict_pair_update`, `_lane_pair_reduce` that the
clustered kernels (`ops/trace_cluster.py`) share.

Kernel `csrc/trace_dense.cu` replaces `trace_pallas.py::_kernel`, kernel
`csrc/sweep_dense.cu` `trace_pallas.py::_sweep_kernel` (the five rows of
the clustered sweep without worklists, for shell pairs too small for
clusters to pay). Both walk `csrc/mt_dense.cuh`: CTAs of 512 rays, two a
thread (the TPU kernel's block, so its skip flag means the same thing);
triangles staged in a double-buffered triangle-major tile;
a prefilter that tests each pair's facing (det's sign, in FORWARD_ONLY
and BACKWARD_ONLY), then u·det, then v·det, each without a branch where
some pair of the warp still passes, and runs the divide and the rest of
Möller–Trumbore only there (`dense_rule` is its rule, `prefilter_pairs`
counts what each test leaves); and, for launches too short to fill the
card, triangle slices folded per ray (the library sizes the launch:
`dense_scratch`). Built with -fmad=false, they round op by op like
`_mt_pairs` below and are held bit-exact to `trace_dense_twin` and
`sweep_shells_dense_twin`. Bound on the card (`ops/bounds.py`): FP32
operations, 46 per (ray, triangle) pair of the live blocks (x the shells'
real triangles), or, counting what the prefilter leaves, 14 per pair
(det), 10 more on the pairs the facing test leaves, 14 on those its u
test leaves and 10 on those its v test leaves (`bounds.dense_seconds`).

With `NR_TRACE_MXU=1` (or `mxu=True`) both wrappers take the matrix
formulation of `ops/trace_mxu.py`: `trace_dense` the kernel
`csrc/trace_dense_mxu.cu` (TPU kernel K8, `trace_mxu.py::_mxu_kernel`),
`sweep_shells_dense` the kernel `csrc/sweep_dense_mxu.cu`, which replaces
the `mxu=True` body of `_sweep_block_body` (`trace_pallas.py:200-230`):
the same rows and skip flag, the pair math as FP64 tensor-core products
with an FP32 epilogue behind a prefilter, in 64-ray CTAs and triangle
slices (csrc/mt_mxu.cuh, "the dense kernels"). Bound on the card: the
FP64 tensor products, the function's 38 flops per pair of the live blocks
(48 as issued) against 67 TFLOP/s, over the FP32 operations and
conversions (`ops/bounds.py`); the twins are `trace_dense_twin` and
`sweep_shells_dense_twin` with `mxu=True`.
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
# The FP32 dense kernels' prefilter (csrc/mt_dense.cuh): a numerator w
# (u·det or v·det, times det's sign) below |det| DENSE_LO or at least
# |det| DENSE_HI rejects the pair.
DENSE_LO = -2.0 ** -20
DENSE_HI = 1.0 + 2.0 ** -20


def _mt_det(d, tb):
    """det of `_mt_pairs`, rays d [3, ...] against triangles tb [9, ...]:
    (det, d x e2)."""
    dx, dy, dz = d[0], d[1], d[2]
    e1x, e1y, e1z = tb[3], tb[4], tb[5]
    e2x, e2y, e2z = tb[6], tb[7], tb[8]

    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    return det, (px, py, pz)


def _mt_u_num(o, tb, pvec):
    """u·det of `_mt_pairs` from d x e2 (`_mt_det`): (u·det, o - v0)."""
    px, py, pz = pvec
    tx = o[0] - tb[0]
    ty = o[1] - tb[1]
    tz = o[2] - tb[2]
    return tx * px + ty * py + tz * pz, (tx, ty, tz)


def _mt_det_u(o, d, tb):
    """The first half of Möller–Trumbore (`_mt_pairs`), rays o, d [3, ...]
    against triangles tb [9, ...]: (det, u·det, o - v0)."""
    det, pvec = _mt_det(d, tb)
    u_num, tvec = _mt_u_num(o, tb, pvec)
    return det, u_num, tvec


def _mt_v_num(d, tb, tvec):
    """v·det of `_mt_pairs` from o - v0 (`_mt_det_u`): (v·det, q)."""
    tx, ty, tz = tvec
    e1x, e1y, e1z = tb[3], tb[4], tb[5]
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    return d[0] * qx + d[1] * qy + d[2] * qz, (qx, qy, qz)


def _mt_pairs(o, d, tb):
    """Möller–Trumbore of rays o, d [3, ...] against triangles tb [9, ...],
    the trailing shapes broadcasting against each other: returns (t, det)
    with t = 1e30 where the pair is rejected (det cull, barycentric bounds,
    epsilon). Facing is carried by det's sign: FORWARD (facing < 0) ==
    det > 0. The CUDA kernels evaluate the same expressions in the same
    order (csrc/mt.cuh)."""
    det, u_num, tvec = _mt_det_u(o, d, tb)
    ok = torch.abs(det) >= TRI_EPSILON
    inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))
    u = u_num * inv_det
    ok &= (u >= 0.0) & (u <= 1.0)

    v_num, (qx, qy, qz) = _mt_v_num(d, tb, tvec)
    v = v_num * inv_det
    ok &= (v >= 0.0) & (u + v <= 1.0)

    t = (tb[6] * qx + tb[7] * qy + tb[8] * qz) * inv_det
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


def _dense_facing(det, mode: int):
    """The prefilter's facing test: det > 0 in mode 1 FORWARD_ONLY, det < 0
    in mode 2 BACKWARD_ONLY, every pair in mode 0 ANY."""
    if mode == 1:
        return det > 0.0
    if mode == 2:
        return det < 0.0
    return torch.ones_like(det, dtype=torch.bool)


def _dense_bounds(det):
    """The prefilter's bounds on a numerator: |det| DENSE_LO, |det|
    DENSE_HI."""
    a = det.abs()
    return a * DENSE_LO, a * DENSE_HI


def _dense_out(num, det, lo, hi):
    """The prefilter's test of one numerator (u·det or v·det): True where
    num sgn(det) (det's sign bit flips num's) is below lo = |det| DENSE_LO
    or at least hi = |det| DENSE_HI."""
    w = torch.where(torch.signbit(det), -num, num)
    return (w < lo) | (w >= hi)


def dense_rule(det, u_num, v_num, mode: int = 0):
    """The FP32 dense kernels' prefilter rule on the CPU
    (csrc/mt_dense.cuh::df_face, df_keep_u, df_keep_v, where the argument
    is written out) on a pair's f32 det, u·det and v·det: (facing, keep_u,
    keep_v), False where the facing test (mode 1 FORWARD_ONLY, 2
    BACKWARD_ONLY; every pair passes in mode 0), then the u test, then the
    v test leave a pair that Möller–Trumbore (`_mt_pairs`, nr_mt_t)
    certainly rejects."""
    face = _dense_facing(det, mode)
    lo, hi = _dense_bounds(det)
    keep_u = face & ~_dense_out(u_num, det, lo, hi)
    return face, keep_u, keep_u & ~_dense_out(v_num, det, lo, hi)


def dense_prefilter(o, d, tb, mode: int = 0):
    """`dense_rule` on `_mt_pairs`'s own det, u·det and v·det of rays o, d
    [3, ...] against triangles tb [9, ...], broadcasting as there."""
    det, u_num, tvec = _mt_det_u(o, d, tb)
    v_num, _ = _mt_v_num(d, tb, tvec)
    return dense_rule(det, u_num, v_num, mode)


def prefilter_pairs(origins, dirs, tris_packed, block_mask, mode: int = 0,
                    chunk: int = 32768,
                    prefilter=None) -> tuple[int, int, int]:
    """(pairs the prefilter's facing test leaves, pairs its u test leaves,
    pairs its v test leaves) of the live blocks' rays against every
    triangle: the FP32 dense kernels' bound (ops/bounds.py::dense_seconds)
    counts the u test on the first, the v test on the second and the rest
    of Möller–Trumbore on the third. Triangles with e1 = 0 (the padding,
    which the kernels skip, and a mesh's degenerate ones: det = 0, which
    every test rejects) are not counted. `prefilter` (o, d, tb, mode) ->
    (facing, keep_u, keep_v) replaces `dense_prefilter` (the ablation's
    sweep variants' rules)."""
    prefilter = prefilter or dense_prefilter
    live = torch.repeat_interleave(block_mask != 0, BLOCK_RAYS)
    o, d = origins[:, live], dirs[:, live]
    tris_packed = tris_packed[:, (tris_packed[3:6] != 0).any(dim=0)]
    left = [0, 0, 0]
    for s in range(0, o.shape[1], chunk):
        for c in range(0, tris_packed.shape[1], TRI_TILE):
            kept = prefilter(
                o[:, s:s + chunk, None], d[:, s:s + chunk, None],
                tris_packed[:, None, c:c + TRI_TILE], mode)
            for k, keep in enumerate(kept):
                left[k] += int(keep.sum())
    return tuple(left)


def dense_scratch(name: str, origins, ttot: int, rows: int,
                  shape: tuple[int, ...] = ()):
    """(library, slices, feature scratch, partial rows) of a launch of the
    dense library `name` (trace_dense, sweep_dense, trace_dense_mxu,
    sweep_dense_mxu; the ablation's ablate_trace, ablate_sweep,
    ablate_mxu_bf16), as the library's own `<name>_shape` sizes it
    (csrc/dense_slices.cuh::nr_dense_slices; the FP32 kernels need no
    feature scratch). `shape`: ints the entry takes before the ray count
    (ablate_trace's block and tile)."""
    lib = cuda_build.load(name)
    npad = origins.shape[1]
    slices, feat_doubles = ctypes.c_int(), ctypes.c_longlong()
    rc = getattr(lib, name + "_shape")(
        *(ctypes.c_int(x) for x in shape), ctypes.c_int(npad),
        ctypes.c_int(ttot), ctypes.byref(slices),
        ctypes.byref(feat_doubles))
    cuda_build.check(lib, rc, name + "_shape")
    feat = torch.empty(feat_doubles.value, dtype=torch.float64,
                       device=origins.device)
    part = torch.empty((slices.value if slices.value > 1 else 0, rows, npad),
                       dtype=torch.float32, device=origins.device)
    return lib, slices.value, feat, part


# Rays the twins below evaluate at once on the CPU: whole live blocks, few
# enough that the [rays, tile] temporaries stay in cache. The per-ray math
# does not depend on the batch, so the grouping leaves every bit as it is.
# On the card the twins take every ray in one batch (fewer launches).
_TWIN_RAYS = 2048


def _over_live_blocks(block_mask, n, fill, fn):
    """[R, n] f32: `fill` (R values) in every block whose skip flag is 0,
    fn(cols) ([R, len(cols)]) on the rays `cols` of the live blocks (on
    the CPU _TWIN_RAYS at a time; on the card all n rays in one call,
    dead blocks then overwritten)."""
    dev = block_mask.device
    live = block_mask != 0
    fill = torch.tensor(fill, dtype=torch.float32, device=dev)[:, None]
    if block_mask.is_cuda:
        rows = fn(torch.arange(n, device=dev))
        return torch.where(torch.repeat_interleave(live, BLOCK_RAYS)[None],
                           rows, fill)
    out = fill.repeat(1, n)
    blocks = torch.nonzero(live).squeeze(1)
    lane = torch.arange(BLOCK_RAYS, device=dev)
    per = _TWIN_RAYS // BLOCK_RAYS
    for g in range(0, blocks.numel(), per):
        cols = (blocks[g:g + per, None] * BLOCK_RAYS + lane).reshape(-1)
        out[:, cols] = fn(cols)
    return out


def trace_dense_twin(origins, dirs, tris_packed, mode: int, block_mask,
                     mxu: bool = False):
    """Plain-PyTorch twin of the dense trace kernel: the same outputs,
    [2, Npad] f32 (row 0 best t, 1e30 on miss; row 1 the best triangle id
    bitcast to f32, the smallest id among equal t; blocks with a 0 skip flag
    report a miss with id 0). `mxu` evaluates the pairs in the matrix
    formulation (`trace_mxu.mxu_tile_t`)."""
    from . import trace_mxu
    pairs = trace_mxu.mxu_tile_t if mxu else _mt_tile_t

    def rays(cols):
        o, d = origins[:, cols], dirs[:, cols]
        best_t = torch.full((cols.numel(),), MISS, dtype=torch.float32,
                            device=o.device)
        best_tri = torch.zeros((cols.numel(),), dtype=torch.int32,
                               device=o.device)
        for c in range(0, tris_packed.shape[1], TRI_TILE):
            t, det = pairs(o, d, tris_packed[:, c:c + TRI_TILE])
            t = _mode_cull(t, det, mode)
            tc, ci = t.min(dim=1)     # first index among equal minima
            better = tc < best_t
            best_t = torch.where(better, tc, best_t)
            best_tri = torch.where(better, (c + ci).to(torch.int32),
                                   best_tri)
        return torch.stack([best_t, best_tri.view(torch.float32)], dim=0)

    return _over_live_blocks(block_mask, origins.shape[1], [MISS, 0.0], rays)


def _check_trace_dense(what, origins, tris_packed):
    n = origins.shape[1]
    if n % BLOCK_RAYS or tris_packed.shape[1] % TRI_TILE:
        raise ValueError(f"{what} needs Npad % {BLOCK_RAYS} == 0 and "
                         f"T % {TRI_TILE} == 0, got {n}, "
                         f"{tris_packed.shape[1]}")


def _launch_trace_dense(origins, dirs, tris_packed, mode, block_mask):
    """Check the dense trace's operands and launch csrc/trace_dense.cu;
    returns [2, Npad]."""
    lib_name = "trace_dense"
    cuda_build.check_operands(lib_name, (
        ("origins", origins, torch.float32), ("dirs", dirs, torch.float32),
        ("tris_packed", tris_packed, torch.float32),
        ("block_mask", block_mask, torch.int32)))
    n, ttot = origins.shape[1], tris_packed.shape[1]
    lib, slices, _, part = dense_scratch(lib_name, origins, ttot, 2)
    out = torch.empty((2, n), dtype=torch.float32, device=origins.device)
    p = cuda_build.ptr
    rc = lib.trace_dense(
        p(origins), p(dirs), ctypes.c_int(n), p(tris_packed),
        ctypes.c_int(ttot), p(block_mask), ctypes.c_int(mode),
        ctypes.c_int(slices), p(part), p(out), cuda_build.stream_of(origins))
    cuda_build.check(lib, rc, lib_name)
    return out


def trace_dense(origins, dirs, tris_packed, mode: int, block_mask,
                mxu: bool | None = None):
    """origins/dirs [3, Npad] f32 (Npad a multiple of BLOCK_RAYS);
    tris_packed [9, T] f32 with T a multiple of TRI_TILE; block_mask
    [Npad / BLOCK_RAYS] int32 skip flags. Returns [2, Npad] f32 (see
    trace_dense_twin). CPU tensors run the twin; CUDA tensors launch
    csrc/trace_dense.cu, or with `mxu` (None reads NR_TRACE_MXU) the
    matrix formulation `trace_mxu.trace_dense_mxu`."""
    from . import trace_mxu
    if trace_mxu.use_mxu(mxu):
        return trace_mxu.trace_dense_mxu(origins, dirs, tris_packed, mode,
                                         block_mask)
    _check_trace_dense("trace_dense", origins, tris_packed)
    if not origins.is_cuda:
        return trace_dense_twin(origins, dirs, tris_packed, mode, block_mask)
    out = _launch_trace_dense(origins, dirs, tris_packed, mode, block_mask)
    trace_dense.launches += 1
    return out


trace_dense.launches = 0


def sweep_shells_dense_twin(origins, dirs, tris_packed, outer_cols: int,
                            with_fwd2: bool, block_mask, mxu: bool = False,
                            pairs=None):
    """Plain-PyTorch twin of the dense dual-shell sweep kernel: [5 or 4,
    Npad] f32 rows outer_fwd, outer_bwd, inner_fwd, inner_bwd[, outer_fwd2],
    1e30 on a miss and in blocks whose skip flag is 0. `mxu` evaluates the
    pairs in the matrix formulation (`trace_mxu.mxu_tile_t`); `pairs`, a
    function with `_mt_tile_t`'s contract, replaces the pair math (the
    tile-math variants of `trace_ablation`)."""
    from . import trace_mxu
    if pairs is None:
        pairs = trace_mxu.mxu_tile_t if mxu else _mt_tile_t

    def rays(cols):
        o, d = origins[:, cols], dirs[:, cols]
        miss = torch.full((cols.numel(),), MISS, dtype=torch.float32,
                          device=o.device)
        m1f, m2f, m1b, i1f, i1b = miss, miss, miss, miss, miss
        for c in range(0, tris_packed.shape[1], SWEEP_TRI_TILE):
            t, det = pairs(o, d, tris_packed[:, c:c + SWEEP_TRI_TILE])
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
        return torch.stack([m1f, m1b, i1f, i1b]
                           + ([m2f] if with_fwd2 else []), dim=0)

    return _over_live_blocks(block_mask, origins.shape[1],
                             [MISS] * (5 if with_fwd2 else 4), rays)


def _check_sweep_dense(what, origins, tris_packed, outer_cols):
    n = origins.shape[1]
    if n % BLOCK_RAYS or tris_packed.shape[1] % SWEEP_TRI_TILE \
            or outer_cols % SWEEP_TRI_TILE:
        raise ValueError(f"{what} needs Npad % {BLOCK_RAYS} == 0 and whole "
                         f"{SWEEP_TRI_TILE}-triangle tiles, got {n}, "
                         f"{tris_packed.shape[1]}, {outer_cols}")


def _launch_sweep_dense(origins, dirs, tris_packed, outer_cols, with_fwd2,
                        block_mask):
    """Check the dense sweep's operands and launch csrc/sweep_dense.cu;
    returns [5 or 4, Npad]."""
    lib_name = "sweep_dense"
    cuda_build.check_operands(lib_name, (
        ("origins", origins, torch.float32), ("dirs", dirs, torch.float32),
        ("tris_packed", tris_packed, torch.float32),
        ("block_mask", block_mask, torch.int32)))
    n, ttot = origins.shape[1], tris_packed.shape[1]
    rows = 5 if with_fwd2 else 4
    lib, slices, _, part = dense_scratch(lib_name, origins, ttot, rows)
    out = torch.empty((rows, n), dtype=torch.float32, device=origins.device)
    p = cuda_build.ptr
    rc = lib.sweep_dense(
        p(origins), p(dirs), ctypes.c_int(n), p(tris_packed),
        ctypes.c_int(ttot), ctypes.c_int(outer_cols), p(block_mask),
        ctypes.c_int(int(with_fwd2)), ctypes.c_int(slices), p(part), p(out),
        cuda_build.stream_of(origins))
    cuda_build.check(lib, rc, lib_name)
    return out


def sweep_shells_dense(origins, dirs, tris_packed, outer_cols: int,
                       with_fwd2: bool, block_mask, mxu: bool | None = None):
    """origins/dirs [3, Npad] f32 (Npad a multiple of BLOCK_RAYS);
    tris_packed [9, T] = outer shell (outer_cols columns) then inner shell,
    each padded to whole SWEEP_TRI_TILE tiles; block_mask [Npad /
    BLOCK_RAYS] int32 skip flags. Returns [5, Npad] (4 rows without fwd2),
    see sweep_shells_dense_twin. CPU tensors run the twin; CUDA tensors
    launch csrc/sweep_dense.cu, or with `mxu` (None reads NR_TRACE_MXU)
    `sweep_shells_dense_mxu`."""
    from . import trace_mxu
    args = (origins, dirs, tris_packed, outer_cols, with_fwd2, block_mask)
    if trace_mxu.use_mxu(mxu):
        return sweep_shells_dense_mxu(*args)
    _check_sweep_dense("sweep_shells_dense", origins, tris_packed,
                       outer_cols)
    if not origins.is_cuda:
        return sweep_shells_dense_twin(*args)
    out = _launch_sweep_dense(*args)
    sweep_shells_dense.launches += 1
    return out


sweep_shells_dense.launches = 0


def sweep_shells_dense_mxu(origins, dirs, tris_packed, outer_cols: int,
                           with_fwd2: bool, block_mask):
    """`sweep_shells_dense` in the matrix formulation, the same contract.
    CPU tensors run `sweep_shells_dense_twin(..., mxu=True)`; CUDA tensors
    launch csrc/sweep_dense_mxu.cu."""
    args = (origins, dirs, tris_packed, outer_cols, with_fwd2, block_mask)
    _check_sweep_dense("sweep_shells_dense_mxu", origins, tris_packed,
                       outer_cols)
    if not origins.is_cuda:
        return sweep_shells_dense_twin(*args, mxu=True)
    cuda_build.check_operands("sweep_dense_mxu", (
        ("origins", origins, torch.float32), ("dirs", dirs, torch.float32),
        ("tris_packed", tris_packed, torch.float32),
        ("block_mask", block_mask, torch.int32)))
    n, ttot = origins.shape[1], tris_packed.shape[1]
    rows = 5 if with_fwd2 else 4
    lib, slices, feat, part = dense_scratch("sweep_dense_mxu", origins, ttot,
                                            rows)
    out = torch.empty((rows, n), dtype=torch.float32, device=origins.device)
    p = cuda_build.ptr
    rc = lib.sweep_dense_mxu(
        p(origins), p(dirs), ctypes.c_int(n), p(tris_packed),
        ctypes.c_int(ttot), ctypes.c_int(outer_cols), p(block_mask),
        ctypes.c_int(int(with_fwd2)), ctypes.c_int(slices), p(feat),
        p(part), p(out), cuda_build.stream_of(origins))
    cuda_build.check(lib, rc, "sweep_dense_mxu")
    sweep_shells_dense_mxu.launches += 1
    return out


sweep_shells_dense_mxu.launches = 0
