"""Clustered traces for large meshes: the dual-shell sweep and the closest
hit, each a CUDA kernel + PyTorch twin, and the level-0 worklist helpers.

Port of `neural_renderer_tpu/ops/trace_cluster.py`: `cluster_bounds_from_packed`,
`_block_cluster_mask`, `_stream_worklist`, `mesh_exit_t` (level 0, plain
PyTorch), `sweep_clusters_stream` (TPU kernel K1, `_sweep_stream_kernel`)
and `trace_clusters_stream` (TPU kernel K5, `_stream_kernel`).

Triangles sit in BVH-leaf order, so consecutive CLUSTER_SIZE chunks are
spatially tight. Every 512-ray block gets a worklist of the clusters that
any of its rays' slabs enter.

Sweep: clusters of both shells in one id space (outer first), listed in id
order; the kernel runs Möller–Trumbore only against those and emits, per
ray, the closest outer-forward, outer-backward, inner-forward and
inner-backward t, plus the strict second outer-forward t (1e30 on a miss).
Kernel `csrc/sweep_stream.cu` replaces `_sweep_stream_kernel`. One CUDA
block per 512-ray worklist block (the TPU's granularity), one thread per
ray; the block loads its own count and worklist row, stages each cluster's
[9, 256] f32 tile (9 KB) in shared memory and loops its ray over it with
the five accumulators in registers. Bound on the card: FP32 operations,
~45 per swept (ray, triangle) pair; the block-sized worklist keeps the
swept pairs at the block frustum's footprint. Built with -fmad=false, it is
bit-exact to `sweep_clusters_twin`: min and strict second-min are
selections, independent of how the pairs are grouped.

Closest hit: the worklist is sorted front to back by the block's
conservative entry t, and the kernel breaks out of it once no listed
cluster can still beat any ray of the block (bound = max over rays of
min(best_t, exit_t) against the next entry t). Kernel
`csrc/trace_cluster_stream.cu` replaces `_stream_kernel`, with the same
block shape and tile staging as the sweep; the bound is a block-wide max
reduction after each cluster. Bound on the card: FP32 operations, ~45 per
pair actually swept (the wrapper can report clusters swept per block). The
smallest triangle id wins among equal t, as in `trace_mesh_brute`, so
kernel, twin and oracle agree exactly, with the break on or off.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_build
from .trace_pallas import (MIN_T, MISS, _lane_pair_reduce, _mode_cull,
                           _mt_pairs, _mt_tile_t, _strict_pair_update)

CLUSTER_SIZE = 256
BLOCK_RAYS = 512
STREAM_K = 1024  # per-block worklist capacity (= the worklist row stride)
_MASK_CLUSTER_CHUNK = 128
# Ray blocks per pass of the ray-by-cluster slab test: its [3, blocks, 512,
# 128] f32 temporaries stay at 400 MB each whatever the batch.
_MASK_BLOCK_CHUNK = 512


def cluster_bounds_from_packed(tris_packed, num_triangles: int) -> np.ndarray:
    """[9, T] packed (v0, e1, e2) -> [6, C] cluster AABBs (numpy).
    Padding triangles beyond num_triangles are excluded; fully-empty
    clusters get an inverted box that can never be hit."""
    tp = np.asarray(tris_packed, np.float32)
    t = tp.shape[1]
    c = max(1, -(-t // CLUSTER_SIZE))
    pad = c * CLUSTER_SIZE - t
    v0 = tp[0:3]
    v1 = tp[0:3] + tp[3:6]
    v2 = tp[0:3] + tp[6:9]
    lo = np.minimum(np.minimum(v0, v1), v2)
    hi = np.maximum(np.maximum(v0, v1), v2)
    valid = np.arange(t) < num_triangles
    lo = np.where(valid[None, :], lo, 1e30)
    hi = np.where(valid[None, :], hi, -1e30)
    if pad:
        lo = np.pad(lo, ((0, 0), (0, pad)), constant_values=1e30)
        hi = np.pad(hi, ((0, 0), (0, pad)), constant_values=-1e30)
    lo = lo.reshape(3, c, CLUSTER_SIZE).min(axis=2)
    hi = hi.reshape(3, c, CLUSTER_SIZE).max(axis=2)
    return np.concatenate([lo, hi], axis=0).astype(np.float32)


def _safe_inv(dirs):
    small = torch.abs(dirs) < 1e-30
    d_safe = torch.where(small, torch.where(dirs < 0, -1e-30, 1e-30), dirs)
    return 1.0 / d_safe


def _block_cluster_mask(origins, dirs, cluster_bounds, active,
                        with_tmin: bool = False):
    """[3, Npad] rays (Npad % BLOCK_RAYS == 0) x [6, C] boxes -> bool
    [NB, C]: does any (active) ray of block b enter cluster c. With
    with_tmin also returns f32 [NB, C]: the smallest (clamped >= 0) slab
    entry t over the block's hitting rays, +inf where none hits: the
    conservative key for front-to-back traversal. Rays are taken
    _MASK_BLOCK_CHUNK blocks at a time and clusters _MASK_CLUSTER_CHUNK at a
    time, so the slab temporaries stay bounded."""
    n = origins.shape[1]
    nb = n // BLOCK_RAYS
    c = cluster_bounds.shape[1]
    inv_d = _safe_inv(dirs)
    o_all = origins.reshape(3, nb, BLOCK_RAYS, 1)
    inv_all = inv_d.reshape(3, nb, BLOCK_RAYS, 1)
    act_all = (active.reshape(nb, BLOCK_RAYS, 1) if active is not None
               else None)
    mask_rows, tmin_rows = [], []
    for b0 in range(0, nb, _MASK_BLOCK_CHUNK):
        o = o_all[:, b0:b0 + _MASK_BLOCK_CHUNK]
        inv = inv_all[:, b0:b0 + _MASK_BLOCK_CHUNK]
        act = (act_all[b0:b0 + _MASK_BLOCK_CHUNK] if act_all is not None
               else None)
        masks, entries = [], []
        for s in range(0, c, _MASK_CLUSTER_CHUNK):
            blk = cluster_bounds[:, s:s + _MASK_CLUSTER_CHUNK]
            lo = blk[0:3][:, None, None, :]
            hi = blk[3:6][:, None, None, :]
            t0 = (lo - o) * inv
            t1 = (hi - o) * inv
            tmin = torch.minimum(t0, t1).amax(dim=0)
            tmax = torch.maximum(t0, t1).amin(dim=0)
            tmin = torch.clamp(tmin, min=0.0)
            hit = (tmax >= tmin) & (tmax > MIN_T)
            if act is not None:
                hit &= act
            masks.append(hit.any(dim=1))
            if with_tmin:
                entries.append(torch.where(
                    hit, tmin, torch.full_like(tmin, float("inf")))
                    .amin(dim=1))
        mask_rows.append(torch.cat(masks, dim=1))
        if with_tmin:
            tmin_rows.append(torch.cat(entries, dim=1))
    if nb == 0:
        mask = torch.zeros((0, c), dtype=torch.bool, device=origins.device)
        return (mask, mask.to(torch.float32)) if with_tmin else mask
    mask = torch.cat(mask_rows, dim=0)
    if with_tmin:
        return mask, torch.cat(tmin_rows, dim=0)
    return mask


def mesh_exit_t(origins, dirs, cluster_bounds, active):
    """Per-ray exit t from the whole-mesh AABB (union of the cluster
    bounds); 0 where the ray misses the box or is inactive. The cap of the
    closest-hit kernel's break bound."""
    lo = cluster_bounds[0:3].amin(dim=1)
    hi3 = cluster_bounds[3:6]
    hi = torch.where(hi3 < cluster_bounds[0:3],
                     torch.full_like(hi3, float("-inf")), hi3).amax(dim=1)
    inv = _safe_inv(dirs)
    t0 = (lo[:, None] - origins) * inv
    t1 = (hi[:, None] - origins) * inv
    tmin = torch.clamp(torch.minimum(t0, t1).amax(dim=0), min=0.0)
    tmax = torch.maximum(t0, t1).amin(dim=0)
    ok = tmax >= tmin
    if active is not None:
        ok &= active
    return torch.where(ok, tmax, torch.zeros_like(tmax))


def _stream_worklist(mask, btmin=None, kmax: int = STREAM_K):
    """mask [NB, C] (and btmin [NB, C] f32) -> (ids [NB*K] int32, tmins
    [NB*K] f32 (+inf pad), counts [NB] int32, overflow [NB] bool). Row b
    lists the masked cluster ids at offset b*K; counts are clamped to
    min(kmax, C, K) and overflow flags the rows that were cut. With btmin
    the ids go by ascending entry t (ties in id order) and tmins carries
    their keys; without it (the sweep, which visits every listed cluster)
    the ids go in id order and tmins is None."""
    c = mask.shape[1]
    k = STREAM_K
    if btmin is None:
        rank = torch.where(mask, 0.0, float("inf"))
    else:
        rank = torch.where(mask, btmin, torch.full_like(btmin, float("inf")))
    order = torch.argsort(rank, dim=1, stable=True)
    tmins = None
    if k > c:
        if btmin is not None:
            tmins = torch.nn.functional.pad(torch.gather(rank, 1, order),
                                            (0, k - c), value=float("inf"))
        order = torch.nn.functional.pad(order, (0, k - c))
    else:
        order = order[:, :k]
        if btmin is not None:
            tmins = torch.gather(rank, 1, order)
    raw = mask.sum(dim=1).to(torch.int32)
    kcap = min(kmax, c, k)
    if tmins is not None:
        tmins = tmins.reshape(-1).contiguous()
    return (order.to(torch.int32).reshape(-1).contiguous(), tmins,
            torch.clamp(raw, max=kcap), raw > kcap)


def sweep_clusters_twin(origins, dirs, tris_packed, ids, counts,
                        outer_clusters: int, with_fwd2: bool):
    """Plain-PyTorch twin of the clustered sweep kernel, the same [5 or 4,
    Npad] output. Each cluster is swept for the rays whose block lists it."""
    n = origins.shape[1]
    nb = n // BLOCK_RAYS
    num_clusters = tris_packed.shape[1] // CLUSTER_SIZE
    k = ids.shape[0] // nb
    slot = torch.arange(k, device=ids.device)[None, :]
    listed = ids.reshape(nb, k).to(torch.int64)
    listed = torch.where(slot < counts[:, None], listed, -1)
    in_list = torch.zeros((nb, num_clusters + 1), dtype=torch.bool,
                          device=ids.device)
    in_list.scatter_(1, torch.where(listed < 0, num_clusters, listed), True)
    in_list = torch.repeat_interleave(in_list[:, :num_clusters], BLOCK_RAYS,
                                      dim=0)                       # [N, C]
    miss = torch.full((n,), MISS, dtype=torch.float32, device=origins.device)
    m1f, m2f, m1b, i1f, i1b = miss, miss, miss, miss, miss
    for cl in range(num_clusters):
        rows = torch.nonzero(in_list[:, cl]).squeeze(1)
        if rows.numel() == 0:
            continue
        tb = tris_packed[:, cl * CLUSTER_SIZE:(cl + 1) * CLUSTER_SIZE]
        t, det = _mt_tile_t(origins[:, rows], dirs[:, rows], tb)
        big = torch.full_like(t, MISS)
        tf = torch.where(det > 0.0, t, big)
        tbk = torch.where(det < 0.0, t, big).min(dim=1).values
        lf1 = tf.min(dim=1).values
        if cl < outer_clusters:
            if with_fwd2:
                # The cluster's strict pair, folded into the running pair:
                # the pair of a multiset is grouping-independent.
                lf1, lf2 = _lane_pair_reduce(tf, big)
                n1, n2 = _strict_pair_update(m1f[rows], m2f[rows], lf1)
                n1, n2 = _strict_pair_update(n1, n2, lf2)
                m2f = m2f.index_copy(0, rows, n2)
            else:
                n1 = torch.minimum(m1f[rows], lf1)
            m1f = m1f.index_copy(0, rows, n1)
            m1b = m1b.index_copy(0, rows, torch.minimum(m1b[rows], tbk))
        else:
            i1f = i1f.index_copy(0, rows, torch.minimum(i1f[rows], lf1))
            i1b = i1b.index_copy(0, rows, torch.minimum(i1b[rows], tbk))
    rows_out = [m1f, m1b, i1f, i1b] + ([m2f] if with_fwd2 else [])
    return torch.stack(rows_out, dim=0)


def sweep_clusters_stream(origins, dirs, tris_packed, ids, counts,
                          outer_clusters: int, with_fwd2: bool = False):
    """origins/dirs [3, Npad] f32; tris_packed [9, (Co+Ci)*CLUSTER_SIZE] =
    outer clusters then inner clusters; ids [NB*K] / counts [NB] int32 from
    `_stream_worklist` over the concatenated cluster bounds. Returns
    [5, Npad] (4 rows without fwd2): outer_fwd, outer_bwd, inner_fwd,
    inner_bwd[, outer_fwd2], 1e30 on a miss. CPU tensors run the twin; CUDA
    tensors launch csrc/sweep_stream.cu."""
    n = origins.shape[1]
    if n % BLOCK_RAYS or tris_packed.shape[1] % CLUSTER_SIZE:
        raise ValueError("sweep_clusters_stream needs Npad % 512 == 0 and "
                         "T % 256 == 0")
    if not origins.is_cuda:
        return sweep_clusters_twin(origins, dirs, tris_packed, ids, counts,
                                   outer_clusters, with_fwd2)
    for name, x, dt in (("origins", origins, torch.float32),
                        ("dirs", dirs, torch.float32),
                        ("tris_packed", tris_packed, torch.float32),
                        ("ids", ids, torch.int32),
                        ("counts", counts, torch.int32)):
        if not x.is_cuda or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"sweep_clusters_stream: {name} must be a "
                             f"contiguous CUDA {dt} tensor")
    nb = n // BLOCK_RAYS
    lib = cuda_build.load("sweep_stream")
    out = torch.empty((5 if with_fwd2 else 4, n), dtype=torch.float32,
                      device=origins.device)
    p = cuda_build.ptr
    rc = lib.sweep_stream(p(origins), p(dirs), ctypes.c_int(n),
                          p(tris_packed), ctypes.c_int(tris_packed.shape[1]),
                          p(ids), p(counts), ctypes.c_int(ids.shape[0] // nb),
                          ctypes.c_int(outer_clusters),
                          ctypes.c_int(int(with_fwd2)), p(out),
                          cuda_build.stream_of(origins))
    cuda_build.check(lib, rc, "sweep_stream")
    sweep_clusters_stream.launches += 1
    return out


sweep_clusters_stream.launches = 0


def trace_clusters_twin(origins, dirs, tris_packed, ids, tmins, counts,
                        exit_t, mode: int, early_out: bool = True,
                        swept_out=None):
    """Plain-PyTorch twin of the clustered closest-hit kernel: (best_t
    [Npad] f32, best_tri [Npad] int32). All blocks step through their
    worklists together, slot by slot; a block that has broken out (or run
    out) drops from the step. Smallest triangle id among equal t."""
    n = origins.shape[1]
    nb = n // BLOCK_RAYS
    dev = origins.device
    k = ids.shape[0] // max(nb, 1)
    ids2 = ids.reshape(nb, k).to(torch.int64)
    tmins2 = tmins.reshape(nb, k)
    o = origins.reshape(3, nb, BLOCK_RAYS)
    d = dirs.reshape(3, nb, BLOCK_RAYS)
    cap = exit_t.reshape(nb, BLOCK_RAYS)
    best_t = torch.full((nb, BLOCK_RAYS), MISS, dtype=torch.float32,
                        device=dev)
    best_tri = torch.zeros((nb, BLOCK_RAYS), dtype=torch.int64, device=dev)
    swept = torch.zeros((nb,), dtype=torch.int32, device=dev)
    going = counts > 0
    lane = torch.arange(CLUSTER_SIZE, device=dev)
    tiles = tris_packed.reshape(9, -1, CLUSTER_SIZE)
    j = 0
    while bool(going.any()):
        live = torch.nonzero(going).squeeze(1)
        cl = ids2[live, j]                                   # [L]
        tb = tiles[:, cl][:, :, None, :]                     # [9, L, 1, 256]
        t, det = _mt_pairs(o[:, live][..., None], d[:, live][..., None], tb)
        t = _mode_cull(t, det, mode)                         # [L, 512, 256]
        tc = t.min(dim=2).values
        first = torch.where(t == tc[..., None], lane,
                            CLUSTER_SIZE).min(dim=2).values
        cand = cl[:, None] * CLUSTER_SIZE + first
        bt, btri = best_t[live], best_tri[live]
        better = (tc < bt) | ((tc == bt) & (cand < btri))
        bt = torch.where(better, tc, bt)
        best_t[live] = bt
        best_tri[live] = torch.where(better, cand, btri)
        swept[live] += 1
        j += 1
        more = counts[live] > j
        if early_out and j < k:
            bound = torch.minimum(bt, cap[live]).amax(dim=1)
            more &= bound > tmins2[live, j] * 0.9999 - 1e-4
        going = going.clone()
        going[live] = more
    if swept_out is not None:
        swept_out.copy_(swept)
    return best_t.reshape(-1), best_tri.reshape(-1).to(torch.int32)


def trace_clusters_stream(origins, dirs, tris_packed, ids, tmins, counts,
                          exit_t, mode: int, early_out: bool = True,
                          swept_out=None):
    """origins/dirs [3, Npad] f32; tris_packed [9, C*CLUSTER_SIZE] f32;
    ids/tmins [NB*K] + counts [NB] from `_stream_worklist` (front to back);
    exit_t [Npad] from `mesh_exit_t`. Returns (best_t [Npad] f32, 1e30 on a
    miss, best_tri [Npad] int32, 0 on a miss). `early_out=False` sweeps every
    listed cluster (same result, more work); `swept_out` ([NB] int32), when
    given, receives the clusters each block swept. CPU tensors run the twin;
    CUDA tensors launch csrc/trace_cluster_stream.cu."""
    n = origins.shape[1]
    if n % BLOCK_RAYS or tris_packed.shape[1] % CLUSTER_SIZE:
        raise ValueError("trace_clusters_stream needs Npad % 512 == 0 and "
                         "T % 256 == 0")
    if not origins.is_cuda:
        return trace_clusters_twin(origins, dirs, tris_packed, ids, tmins,
                                   counts, exit_t, mode, early_out, swept_out)
    checks = [("origins", origins, torch.float32),
              ("dirs", dirs, torch.float32),
              ("tris_packed", tris_packed, torch.float32),
              ("ids", ids, torch.int32), ("tmins", tmins, torch.float32),
              ("counts", counts, torch.int32),
              ("exit_t", exit_t, torch.float32)]
    if swept_out is not None:
        checks.append(("swept_out", swept_out, torch.int32))
    for name, x, dt in checks:
        if not x.is_cuda or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"trace_clusters_stream: {name} must be a "
                             f"contiguous CUDA {dt} tensor")
    nb = n // BLOCK_RAYS
    lib = cuda_build.load("trace_cluster_stream")
    best_t = torch.empty((n,), dtype=torch.float32, device=origins.device)
    best_tri = torch.empty((n,), dtype=torch.int32, device=origins.device)
    p = cuda_build.ptr
    rc = lib.trace_cluster_stream(
        p(origins), p(dirs), ctypes.c_int(n), p(tris_packed),
        ctypes.c_int(tris_packed.shape[1]), p(ids), p(tmins), p(counts),
        ctypes.c_int(ids.shape[0] // max(nb, 1)), p(exit_t),
        ctypes.c_int(mode), ctypes.c_int(int(early_out)), p(best_t),
        p(best_tri),
        p(swept_out) if swept_out is not None else ctypes.c_void_p(None),
        cuda_build.stream_of(origins))
    cuda_build.check(lib, rc, "trace_cluster_stream")
    trace_clusters_stream.launches += 1
    return best_t, best_tri


trace_clusters_stream.launches = 0
