"""Ray-mesh queries: closest-hit traces and the fused dual-shell sweep.

Port of `neural_renderer_tpu/ops/traversal.py`: `trace_mesh` (dense branch
up to 4,096 triangles, clustered two-level branch above, with the BVH walk
for blocks whose worklist overflows), `sweep_shells` (clustered, dense and
per-mesh branches), `trace_mesh_brute`, `_trace_bvh`, `_ray_hits_box`,
`_mt_from_packed` and `_ray_sort_order`, with the same thresholds, so a
scene takes the same kernel in both packages. The dispatch is the same on
every device; only the innermost call differs (the CUDA kernel for CUDA
tensors, its PyTorch twin for CPU tensors). The BVH walk is plain PyTorch
in both packages.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import spans
from . import trace_cluster as tc
from .linalg import cross, dot
from .intersect import intersect_aabb
from .trace_pallas import (BLOCK_RAYS, SWEEP_TRI_TILE, TRI_TILE,
                           sweep_shells_dense, trace_dense)

ANY = 0
FORWARD_ONLY = 1
BACKWARD_ONLY = 2

MIN_T = 1e-6
TRI_EPSILON = 1e-8
MISS = 1e30

DENSE_MAX_TRIANGLES = 16384
_CLUSTERED_SWEEP_MIN_TRIS = 4096
_CLUSTERED_TRACE_MIN_TRIS = 4096
_CLUSTERED_SWEEP_MAX_CLUSTERS = 1024
# Rays per clustered-trace launch: bounds the [NB, C] worklist build.
_CHUNK_RAYS = 512 * 512


class TraceResult(NamedTuple):
    t: torch.Tensor     # [N] f32, 1e30 on miss
    tri: torch.Tensor   # [N] int64 triangle index (mesh order)
    u: torch.Tensor     # [N] f32
    v: torch.Tensor     # [N] f32
    hit: torch.Tensor   # [N] bool


class ShellSweep(NamedTuple):
    """Nearest-hit t per facing per shell, 1e30 on miss; outer_fwd2 is the
    strictly second-nearest outer forward crossing."""
    outer_fwd: torch.Tensor
    outer_bwd: torch.Tensor
    inner_fwd: torch.Tensor
    inner_bwd: torch.Tensor
    outer_fwd2: torch.Tensor


def _ray_hits_box(origins, dirs, bmin, bmax):
    """Conservative slab test of [3, N] rays vs one AABB (t >= 0), the box
    padded by a relative epsilon; zero direction components handled
    explicitly. The block-skip prefilter of the dense trace."""
    pad = 1e-4 * torch.max(bmax - bmin) + 1e-6
    lo = (bmin - pad)[:, None]
    hi = (bmax + pad)[:, None]
    deg = torch.abs(dirs) < 1e-30
    inv = 1.0 / torch.where(deg, torch.ones_like(dirs), dirs)
    t0 = (lo - origins) * inv
    t1 = (hi - origins) * inv
    inside = (origins >= lo) & (origins <= hi)
    inf = torch.full_like(t0, float("inf"))
    near = torch.where(deg, torch.where(inside, -inf, inf),
                       torch.minimum(t0, t1))
    far = torch.where(deg, torch.where(inside, inf, -inf),
                      torch.maximum(t0, t1))
    tmin = near.amax(dim=0)
    tmax = far.amin(dim=0)
    return tmax >= torch.clamp(tmin, min=0.0)


def _miss(n, device):
    z = torch.zeros((n,), dtype=torch.float32, device=device)
    return TraceResult(t=torch.full((n,), MISS, device=device),
                       tri=torch.zeros((n,), dtype=torch.int64,
                                       device=device),
                       u=z, v=z, hit=torch.zeros((n,), dtype=torch.bool,
                                                 device=device))


def _mt_from_packed(origins, dirs, v0, e1, e2, mode: int):
    """Möller–Trumbore on (v0, e1, e2) rows broadcast against the rays.
    Returns (t, u, v, ok)."""
    pvec = cross(dirs, e2)
    det = dot(e1, pvec)
    ok = torch.abs(det) >= TRI_EPSILON
    inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tvec = origins - v0
    u = dot(tvec, pvec) * inv_det
    ok &= (u >= 0.0) & (u <= 1.0)
    qvec = cross(tvec, e1)
    v = dot(dirs, qvec) * inv_det
    ok &= (v >= 0.0) & (u + v <= 1.0)
    t = dot(e2, qvec) * inv_det
    ok &= t > TRI_EPSILON
    if mode == FORWARD_ONLY:
        ok &= det > 0.0
    elif mode == BACKWARD_ONLY:
        ok &= det < 0.0
    return t, u, v, ok


def _pad_cols(x, width):
    return torch.nn.functional.pad(x, (0, width - x.shape[-1])) \
        if x.shape[-1] != width else x


def trace_mesh(mesh, origins, dirs, mode: int = ANY,
               active=None, presorted: bool = False) -> TraceResult:
    """Closest-hit trace of [3, N] rays against one mesh (MeshTensors).
    `active` ([N] bool) masks rays out; the smallest triangle id wins a tie.
    `presorted`: the caller already put the rays in `_ray_sort_order`, so
    the clustered branch skips its own sort and both permutes (the training
    sampler sorts its batch once for all of its traces)."""
    n = origins.shape[1]
    if mesh.is_empty:
        return _miss(n, origins.device)
    if mesh.num_triangles <= _CLUSTERED_TRACE_MIN_TRIS:
        return _trace_dense(mesh, origins, dirs, mode, active)
    return _trace_two_level(mesh, origins, dirs, mode, active, presorted)


def dense_trace_operands(mesh, origins, dirs, active=None):
    """The dense trace kernel's operands for [3, N] rays: (origins, dirs)
    padded to BLOCK_RAYS, triangles padded to TRI_TILE, and the per-block
    skip flags (a block with no active ray inside the padded root AABB is
    skipped)."""
    n = origins.shape[1]
    num_tris = mesh.num_triangles
    t_pad = -(-num_tris // TRI_TILE) * TRI_TILE
    tp = _pad_cols(mesh.tris_packed[:, :num_tris], t_pad).contiguous()
    n_pad = -(-n // BLOCK_RAYS) * BLOCK_RAYS
    o = _pad_cols(origins, n_pad).contiguous()
    d = _pad_cols(dirs, n_pad).contiguous()
    hit_box = _ray_hits_box(o, d, mesh.bounds_min, mesh.bounds_max)
    if active is not None:
        hit_box &= _pad_cols(active, n_pad)
    elif n_pad != n:
        hit_box &= torch.arange(n_pad, device=o.device) < n
    block_mask = hit_box.reshape(-1, BLOCK_RAYS).any(dim=1).to(torch.int32)
    return o, d, tp, block_mask


def _trace_dense(mesh, origins, dirs, mode: int, active) -> TraceResult:
    """All rays x all triangles through the dense trace kernel (K3)."""
    n = origins.shape[1]
    num_tris = mesh.num_triangles
    o, d, tp, block_mask = dense_trace_operands(mesh, origins, dirs, active)
    out = trace_dense(o, d, tp, mode, block_mask)
    best_t = out[0, :n]
    best_tri = torch.clamp(out[1].view(torch.int32)[:n].to(torch.int64), 0,
                           num_tris - 1)
    hit = best_t < MISS
    if active is not None:
        hit &= active
        best_t = torch.where(hit, best_t, torch.full_like(best_t, MISS))
    tb = mesh.tris_packed[:, best_tri]
    _, u, v, _ = _mt_from_packed(origins, dirs, tb[0:3], tb[3:6], tb[6:9],
                                 ANY)
    zero = torch.zeros_like(u)
    return TraceResult(t=best_t, tri=best_tri, u=torch.where(hit, u, zero),
                       v=torch.where(hit, v, zero), hit=hit)


def sweep_shells(outer, inner, origins, dirs,
                 with_fwd2: bool = False) -> ShellSweep:
    """ONE pass over both shell meshes computing the four facing-culled
    closest hits (and optionally the second outer-forward) that the march
    and early-termination stages consume. origins/dirs [3, N]; raw t's,
    callers apply their own masks. Shell pairs of at least 4,096 triangles
    in at most 1,024 clusters take the clustered sweep, smaller ones (and
    an empty inner shell) the dense sweep; shells above 16,384 triangles,
    or a missing outer shell, take one closest-hit trace per row."""
    n = origins.shape[1]
    miss = torch.full((n,), MISS, dtype=torch.float32, device=origins.device)
    if outer.is_empty and inner.is_empty:
        return ShellSweep(miss, miss, miss, miss, miss)
    big = max(outer.num_triangles, inner.num_triangles)
    if big > DENSE_MAX_TRIANGLES or outer.is_empty:
        return _sweep_per_mesh(outer, inner, origins, dirs, with_fwd2)
    if _takes_clustered_sweep(outer, inner):
        o, d, tp, ids, counts, co = clustered_sweep_operands(outer, inner,
                                                             origins, dirs)
        out = tc.sweep_clusters_stream(o, d, tp, ids, counts, co,
                                       with_fwd2=with_fwd2)
    else:
        o, d, tp, outer_cols, block_mask = dense_sweep_operands(
            outer, inner, origins, dirs)
        out = sweep_shells_dense(o, d, tp, outer_cols, with_fwd2, block_mask)
    has_inner = not inner.is_empty
    return ShellSweep(out[0, :n], out[1, :n],
                      out[2, :n] if has_inner else miss,
                      out[3, :n] if has_inner else miss,
                      out[4, :n] if with_fwd2 else miss)


def _sweep_per_mesh(outer, inner, origins, dirs, with_fwd2) -> ShellSweep:
    """The sweep's rows from separate closest-hit traces."""
    n = origins.shape[1]
    miss = torch.full((n,), MISS, dtype=torch.float32, device=origins.device)

    def one(mesh, mode):
        if mesh.is_empty:
            return miss
        r = trace_mesh(mesh, origins, dirs, mode)
        return torch.where(r.hit, r.t, miss)

    of = one(outer, FORWARD_ONLY)
    if outer.is_empty or not with_fwd2:
        of2 = miss
    else:
        # Second forward crossing: a re-trace from just beyond the first.
        found = of < MISS
        step = torch.where(found, of, torch.zeros_like(of)) + 1e-5
        r2 = trace_mesh(outer, origins + dirs * step[None, :], dirs,
                        FORWARD_ONLY, active=found)
        of2 = torch.where(r2.hit & found, of + 1e-5 + r2.t, miss)
    return ShellSweep(of, one(outer, BACKWARD_ONLY), one(inner, FORWARD_ONLY),
                      one(inner, BACKWARD_ONLY), of2)


def _takes_clustered_sweep(outer, inner) -> bool:
    co = outer.cluster_bounds.shape[1]
    ci = 0 if inner.is_empty else inner.cluster_bounds.shape[1]
    return (not inner.is_empty
            and outer.num_triangles + inner.num_triangles
            >= _CLUSTERED_SWEEP_MIN_TRIS
            and co + ci <= _CLUSTERED_SWEEP_MAX_CLUSTERS)


def _padded_rays(origins, dirs):
    """(origins, dirs) padded to whole BLOCK_RAYS blocks and the mask of the
    real rays (None when nothing was added): all-zero padding rays can pass
    clamped slab tests and must stay out of worklists and skip flags."""
    n = origins.shape[1]
    n_pad = -(-n // BLOCK_RAYS) * BLOCK_RAYS
    o = _pad_cols(origins, n_pad).contiguous()
    d = _pad_cols(dirs, n_pad).contiguous()
    act = None
    if n_pad != n:
        act = torch.arange(n_pad, device=origins.device) < n
    return o, d, act


def dense_sweep_operands(outer, inner, origins, dirs):
    """The dense sweep kernel's operands for [3, N] rays: (origins, dirs)
    padded to BLOCK_RAYS, [outer | inner] triangles padded per shell to
    whole SWEEP_TRI_TILE tiles, the outer column count and the per-block
    skip flags (a block with no ray inside the shells' padded union AABB is
    skipped)."""
    o, d, act = _padded_rays(origins, dirs)

    def tiles(mesh):
        t = mesh.num_triangles
        return _pad_cols(mesh.tris_packed[:, :t],
                         -(-t // SWEEP_TRI_TILE) * SWEEP_TRI_TILE)

    outer_tp = tiles(outer)
    bmin, bmax = outer.bounds_min, outer.bounds_max
    if inner.is_empty:
        tp = outer_tp
    else:
        tp = torch.cat([outer_tp, tiles(inner)], dim=1)
        bmin = torch.minimum(bmin, inner.bounds_min)
        bmax = torch.maximum(bmax, inner.bounds_max)
    hit_box = _ray_hits_box(o, d, bmin, bmax)
    if act is not None:
        hit_box &= act
    block_mask = hit_box.reshape(-1, BLOCK_RAYS).any(dim=1).to(torch.int32)
    return o, d, tp.contiguous(), outer_tp.shape[1], block_mask


def clustered_sweep_operands(outer, inner, origins, dirs):
    """The clustered sweep kernel's operands for [3, N] rays: (origins,
    dirs) padded to BLOCK_RAYS, [outer | inner] triangles padded per shell
    to whole clusters, the per-block worklist (ids, counts) in id order and
    the outer cluster count."""
    co = outer.cluster_bounds.shape[1]
    ci = inner.cluster_bounds.shape[1]
    o, d, act = _padded_rays(origins, dirs)
    cb = torch.cat([outer.cluster_bounds, inner.cluster_bounds], dim=1)
    tp = torch.cat([
        _pad_cols(outer.tris_packed, co * tc.CLUSTER_SIZE),
        _pad_cols(inner.tris_packed, ci * tc.CLUSTER_SIZE)], dim=1)
    mask = tc._block_cluster_mask(o, d, cb, act)
    ids, _, counts, _ = tc._stream_worklist(mask)
    return o, d, tp.contiguous(), ids, counts, co


_SORT_BITS = 4  # morton bits per axis in the ray sort key


def _ray_sort_order(origins, dirs, active=None):
    """Stable order grouping rays by direction octant, origin morton cell,
    then direction morton cell, so 512-ray blocks form tight frusta and
    short cluster worklists. Inactive rays sort to the end."""
    n = origins.shape[1]
    i64 = torch.int64
    octant = ((dirs[0] < 0).to(i64) * 4 + (dirs[1] < 0).to(i64) * 2
              + (dirs[2] < 0).to(i64))
    if active is not None:
        inf = torch.full_like(origins, float("inf"))
        lo = torch.where(active[None, :], origins, inf).amin(dim=1)
        hi = torch.where(active[None, :], origins, -inf).amax(dim=1)
        bad = lo[0] > hi[0]
        lo = torch.where(bad, torch.zeros_like(lo), lo)
        hi = torch.where(bad, torch.ones_like(hi), hi)
    else:
        lo = origins.amin(dim=1)
        hi = origins.amax(dim=1)
    cells = 1 << _SORT_BITS
    scale = cells / torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp(((origins - lo[:, None]) * scale[:, None]).to(i64), 0,
                    cells - 1)
    qd = torch.clamp((torch.abs(dirs) * cells).to(i64), 0, cells - 1)
    omorton = torch.zeros((n,), dtype=i64, device=origins.device)
    dmorton = torch.zeros((n,), dtype=i64, device=origins.device)
    for b in range(_SORT_BITS):
        for a in range(3):
            omorton |= ((q[a] >> b) & 1) << (3 * b + (2 - a))
            dmorton |= ((qd[a] >> b) & 1) << (3 * b + (2 - a))
    key = (octant << (6 * _SORT_BITS)) | (omorton << (3 * _SORT_BITS)) \
        | dmorton
    if active is not None:
        key = torch.where(active, key, torch.full_like(key, 2 ** 31 - 1))
    return torch.argsort(key, stable=True)


def _trace_two_level(mesh, origins, dirs, mode: int, active,
                     presorted: bool = False) -> TraceResult:
    """Octant/morton-sorted rays -> clustered trace in chunks of at most
    _CHUNK_RAYS sorted rays (bounded worklist builds; the sort keeps each
    chunk spatially coherent) -> un-sort. With `presorted` the rays are
    traced in the caller's order and the result stays in it."""
    n = origins.shape[1]
    if presorted:
        o_s, d_s, act_s = origins, dirs, active
    else:
        order = _ray_sort_order(origins, dirs, active)
        o_s, d_s = origins[:, order], dirs[:, order]
        act_s = active[order] if active is not None else None
    parts = []
    for s0 in range(0, n, _CHUNK_RAYS):
        sl = slice(s0, s0 + _CHUNK_RAYS)
        parts.append(_trace_two_level_impl(
            mesh, o_s[:, sl], d_s[:, sl], mode,
            act_s[sl] if act_s is not None else None))
    out = []
    for f in range(5):
        col = parts[0][f] if len(parts) == 1 else \
            torch.cat([p[f] for p in parts])
        if presorted:
            out.append(col)
            continue
        full = torch.empty_like(col)
        full[order] = col
        out.append(full)
    return TraceResult(*out)


def clustered_trace_operands(mesh, origins, dirs, active=None,
                             kmax: int = tc.STREAM_K):
    """The clustered trace kernel's operands for [3, N] rays: (origins,
    dirs) padded to BLOCK_RAYS, triangles padded to whole clusters, the
    front-to-back worklist (ids, tmins, counts), the per-ray exit t, and the
    flags of the blocks whose worklist was cut at kmax."""
    o, d, act = _padded_rays(origins, dirs)
    if active is not None:
        act_pad = _pad_cols(active, o.shape[1])
    else:
        act_pad = act
    c = mesh.cluster_bounds.shape[1]
    tp = _pad_cols(mesh.tris_packed[:, :mesh.num_triangles],
                   c * tc.CLUSTER_SIZE).contiguous()
    mask, btmin = tc._block_cluster_mask(o, d, mesh.cluster_bounds, act_pad,
                                         with_tmin=True)
    ids, tmins, counts, overflow = tc._stream_worklist(mask, btmin, kmax)
    exit_t = tc.mesh_exit_t(o, d, mesh.cluster_bounds, act_pad)
    return o, d, tp, ids, tmins, counts, exit_t, overflow


def _trace_two_level_impl(mesh, origins, dirs, mode: int, active,
                          kmax: int = tc.STREAM_K) -> TraceResult:
    """Per-block cluster worklists + the clustered closest-hit kernel (K5);
    rays of blocks whose worklist was cut at the capacity are re-traced by
    the BVH walk (usually none)."""
    n = origins.shape[1]
    num_tris = mesh.num_triangles
    o, d, tp, ids, tmins, counts, exit_t, overflow = \
        clustered_trace_operands(mesh, origins, dirs, active, kmax)
    best_t, best_tri = tc.trace_clusters_stream(o, d, tp, ids, tmins, counts,
                                                exit_t, mode)
    best_t = best_t[:n]
    best_tri = torch.clamp(best_tri[:n].to(torch.int64), 0, num_tris - 1)

    with spans.span("sync.traceOverflow"):
        idx = None
        if bool(overflow.any()):
            over_rays = torch.repeat_interleave(overflow, BLOCK_RAYS)[:n]
            if active is not None:
                over_rays = over_rays & active
            idx = torch.nonzero(over_rays).squeeze(1)
    if idx is not None and idx.numel() > 0:
        w = _trace_bvh(mesh, origins[:, idx], dirs[:, idx], mode, None)
        best_t = best_t.index_copy(0, idx, w.t)
        best_tri = best_tri.index_copy(0, idx, w.tri)

    hit = best_t < MISS
    if active is not None:
        hit &= active
        best_t = torch.where(hit, best_t, torch.full_like(best_t, MISS))
    tb = mesh.tris_packed[:, best_tri]
    _, u, v, _ = _mt_from_packed(origins, dirs, tb[0:3], tb[3:6], tb[6:9],
                                 ANY)
    zero = torch.zeros_like(u)
    return TraceResult(t=best_t, tri=best_tri, u=torch.where(hit, u, zero),
                       v=torch.where(hit, v, zero), hit=hit)


def _trace_bvh(mesh, origins, dirs, mode: int, active) -> TraceResult:
    """Stackless skip-link BVH walk, all rays in lockstep: per iteration one
    packed node gather [11, N] and, at leaves, packed triangle gathers.
    Node boxes are tested against the running best t."""
    if mesh.nodes_packed is None:
        raise ValueError("this mesh carries no BVH nodes (built from packed "
                         "triangles only)")
    n = origins.shape[1]
    dev = origins.device
    small = torch.abs(dirs) < 1e-30
    inv_dirs = 1.0 / torch.where(
        small, torch.where(dirs < 0, -1e-30, 1e-30), dirs)
    node = torch.zeros((n,), dtype=torch.int64, device=dev)
    if active is not None:
        node = torch.where(active, node, torch.full_like(node, -1))
    max_leaf = max(1, mesh.max_leaf)
    num_nodes = mesh.nodes_packed.shape[1]
    num_tris = mesh.num_triangles
    best_t = torch.full((n,), MISS, dtype=torch.float32, device=dev)
    best_tri = torch.zeros((n,), dtype=torch.int64, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((n,), dtype=torch.float32, device=dev)
    ints = mesh.nodes_packed[6:11].view(torch.int32)
    while True:
        live = node >= 0
        with spans.span("sync.bvhWalk"):
            going = bool(live.any())
        if not going:
            break
        nidx = torch.clamp(node, 0, num_nodes - 1)
        g = mesh.nodes_packed[:, nidx]
        gi = ints[:, nidx].to(torch.int64)
        left, skip, first, count = gi[0], gi[1], gi[2], gi[3]
        is_leaf = gi[4] != 0
        box_hit, _ = intersect_aabb(origins, inv_dirs, g[0:3], g[3:6], best_t)
        box_hit &= live
        process = box_hit & is_leaf
        for i in range(max_leaf):
            tri_idx = torch.clamp(first + i, 0, num_tris - 1)
            valid = process & (i < count)
            tb = mesh.tris_packed[:, tri_idx]
            t, u, v, ok = _mt_from_packed(origins, dirs, tb[0:3], tb[3:6],
                                          tb[6:9], mode)
            better = valid & ok & (t > MIN_T) & (t < best_t)
            best_t = torch.where(better, t, best_t)
            best_tri = torch.where(better, tri_idx, best_tri)
            best_u = torch.where(better, u, best_u)
            best_v = torch.where(better, v, best_v)
        descend = box_hit & ~is_leaf
        nxt = torch.where(descend, left, skip)
        node = torch.where(live, nxt, torch.full_like(node, -1))
    return TraceResult(t=best_t, tri=best_tri, u=best_u, v=best_v,
                       hit=best_t < MISS)


def trace_mesh_brute(mesh, origins, dirs, mode: int = ANY) -> TraceResult:
    """O(N*T) oracle, one triangle at a time with a strict `<`: the smallest
    triangle id wins among equal t. Ground truth for every trace path."""
    n = origins.shape[1]
    dev = origins.device
    if mesh.is_empty:
        return _miss(n, dev)
    best_t = torch.full((n,), MISS, dtype=torch.float32, device=dev)
    best_tri = torch.zeros((n,), dtype=torch.int64, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((n,), dtype=torch.float32, device=dev)
    for i in range(mesh.num_triangles):
        col = mesh.tris_packed[:, i:i + 1]
        t, u, v, ok = _mt_from_packed(origins, dirs, col[0:3], col[3:6],
                                      col[6:9], mode)
        better = ok & (t > MIN_T) & (t < best_t)
        best_t = torch.where(better, t, best_t)
        best_tri = torch.where(better, torch.full_like(best_tri, i), best_tri)
        best_u = torch.where(better, u, best_u)
        best_v = torch.where(better, v, best_v)
    return TraceResult(t=best_t, tri=best_tri, u=best_u, v=best_v,
                       hit=best_t < MISS)
