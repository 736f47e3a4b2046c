"""Binned SAH BVH builder (host side) with flat array output.

Port of `neural_renderer_tpu/scene/bvh.py`, same contract:
  * triangles are reordered into BVH leaf order, so leaves reference
    contiguous index ranges and consecutive 256-triangle clusters are
    spatially tight;
  * per-primitive material ranges are remapped to the new order;
  * nodes come in a flat layout: bounds_min/max, left/right child ids,
    first/count, is_leaf; children of an internal node are adjacent.

The C++ builder `csrc/bvh_builder.cpp` is compiled with the host compiler
at first use and is two orders of magnitude faster on large meshes; the
numpy builder below is the fallback and says so on stderr, with its time,
when it had to build a large mesh. The two (and the JAX package's builders)
break SAH ties differently, so their leaf orders differ: triangle ids are
comparable only between meshes that share one build.
"""

from __future__ import annotations

import ctypes
import sys
import time
from dataclasses import dataclass

import numpy as np

_NUM_BINS = 16
_TRAVERSAL_COST = 1.0
_INTERSECT_COST = 1.5
_SLOW_BUILD_TRIANGLES = 4096  # numpy builds above this are announced


@dataclass
class BvhArrays:
    """Flat SoA BVH (device-ready)."""
    bounds_min: np.ndarray  # [N, 3] f32
    bounds_max: np.ndarray  # [N, 3] f32
    left: np.ndarray        # [N] i32 (-1 for leaves)
    right: np.ndarray       # [N] i32 (-1 for leaves)
    first: np.ndarray       # [N] i32 (leaf: first triangle)
    count: np.ndarray       # [N] i32 (leaf: triangle count)
    is_leaf: np.ndarray     # [N] i32

    @property
    def num_nodes(self) -> int:
        return int(self.bounds_min.shape[0])

    def max_leaf_count(self) -> int:
        leaf = self.is_leaf.astype(bool)
        return int(self.count[leaf].max()) if leaf.any() else 0


def _surface_area(bmin: np.ndarray, bmax: np.ndarray) -> np.ndarray:
    d = np.maximum(bmax - bmin, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])


def build_bvh(tri_min: np.ndarray, tri_max: np.ndarray,
              max_leaf_size: int = 4) -> tuple[BvhArrays, np.ndarray]:
    """Build a binned-SAH BVH.

    Args:
      tri_min/tri_max: [T, 3] per-triangle AABBs.
      max_leaf_size: leaves are split (median fallback) above this size.
    Returns:
      (BvhArrays, perm) where perm maps new triangle order -> old index
      (new_tris[i] = old_tris[perm[i]]).
    """
    lib = _load_native()
    if lib is not None:
        return _build_native(lib, tri_min, tri_max, max_leaf_size)
    t0 = time.perf_counter()
    out = _build_numpy(tri_min, tri_max, max_leaf_size)
    if len(tri_min) >= _SLOW_BUILD_TRIANGLES:
        print(f"neural_renderer_tpu_torch: no native BVH builder (no host "
              f"C++ compiler?); the numpy build of {len(tri_min)} triangles "
              f"took {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return out


def _build_numpy(tri_min, tri_max, max_leaf_size):
    tri_min = np.asarray(tri_min, dtype=np.float32)
    tri_max = np.asarray(tri_max, dtype=np.float32)
    num_tris = tri_min.shape[0]
    centers = 0.5 * (tri_min + tri_max)

    perm = np.arange(num_tris, dtype=np.int64)

    bounds_min, bounds_max = [], []
    lefts, rights, firsts, counts, leaf_flags = [], [], [], [], []

    def alloc_node():
        bounds_min.append(None)
        bounds_max.append(None)
        lefts.append(-1)
        rights.append(-1)
        firsts.append(0)
        counts.append(0)
        leaf_flags.append(0)
        return len(lefts) - 1

    root = alloc_node()
    # Work stack of (node_id, start, end) over the perm array.
    stack = [(root, 0, num_tris)]
    while stack:
        node, start, end = stack.pop()
        ids = perm[start:end]
        nmin = tri_min[ids].min(axis=0)
        nmax = tri_max[ids].max(axis=0)
        bounds_min[node] = nmin
        bounds_max[node] = nmax
        n = end - start

        split = None
        if n > 1:
            split = _find_sah_split(tri_min[ids], tri_max[ids], centers[ids], n)
        if split is None and n > max_leaf_size:
            # Median fallback on the widest centroid axis.
            cmin = centers[ids].min(axis=0)
            cmax = centers[ids].max(axis=0)
            axis = int(np.argmax(cmax - cmin))
            order = np.argsort(centers[ids, axis], kind="stable")
            mid = n // 2
            lmask = np.zeros(n, dtype=bool)
            lmask[order[:mid]] = True
            split = (lmask, float("inf"))
        elif split is not None and n <= max_leaf_size:
            leaf_cost = n * _INTERSECT_COST
            if split[1] >= leaf_cost:
                split = None

        if split is None:
            leaf_flags[node] = 1
            firsts[node] = start
            counts[node] = n
            continue

        lmask = split[0]
        left_ids = ids[lmask]
        right_ids = ids[~lmask]
        nl = left_ids.shape[0]
        perm[start:start + nl] = left_ids
        perm[start + nl:end] = right_ids

        lchild = alloc_node()
        rchild = alloc_node()
        lefts[node] = lchild
        rights[node] = rchild
        stack.append((rchild, start + nl, end))
        stack.append((lchild, start, start + nl))

    arrays = BvhArrays(
        bounds_min=np.stack(bounds_min).astype(np.float32),
        bounds_max=np.stack(bounds_max).astype(np.float32),
        left=np.asarray(lefts, dtype=np.int32),
        right=np.asarray(rights, dtype=np.int32),
        first=np.asarray(firsts, dtype=np.int32),
        count=np.asarray(counts, dtype=np.int32),
        is_leaf=np.asarray(leaf_flags, dtype=np.int32),
    )
    return arrays, perm.astype(np.int64)


def _find_sah_split(tmin, tmax, cen, n):
    """Binned SAH over all 3 axes; returns (left_mask, split_cost) or None."""
    cmin = cen.min(axis=0)
    cmax = cen.max(axis=0)
    extent = cmax - cmin
    parent_sa = _surface_area(tmin.min(axis=0), tmax.max(axis=0))
    if parent_sa <= 0.0:
        return None

    best = None  # (cost, axis, bin_edge_idx, bin_of)
    for axis in range(3):
        if extent[axis] <= 1e-12:
            continue
        scale = _NUM_BINS / extent[axis]
        bin_of = np.minimum(
            ((cen[:, axis] - cmin[axis]) * scale).astype(np.int32), _NUM_BINS - 1)
        # Per-bin counts and bounds.
        bin_counts = np.bincount(bin_of, minlength=_NUM_BINS)
        bmin = np.full((_NUM_BINS, 3), np.inf, dtype=np.float64)
        bmax = np.full((_NUM_BINS, 3), -np.inf, dtype=np.float64)
        for c in range(3):
            np.minimum.at(bmin[:, c], bin_of, tmin[:, c])
            np.maximum.at(bmax[:, c], bin_of, tmax[:, c])
        # Sweep: left-to-right and right-to-left prefix bounds.
        lmin = np.minimum.accumulate(bmin, axis=0)
        lmax = np.maximum.accumulate(bmax, axis=0)
        rmin = np.minimum.accumulate(bmin[::-1], axis=0)[::-1]
        rmax = np.maximum.accumulate(bmax[::-1], axis=0)[::-1]
        lcount = np.cumsum(bin_counts)
        rcount = n - lcount
        # Split after bin i (i in 0.._NUM_BINS-2).
        valid = (lcount[:-1] > 0) & (rcount[:-1] > 0)
        if not valid.any():
            continue
        sa_l = _surface_area(lmin[:-1], lmax[:-1])
        sa_r = _surface_area(rmin[1:], rmax[1:])
        cost = _TRAVERSAL_COST + _INTERSECT_COST * (
            sa_l * lcount[:-1] + sa_r * rcount[:-1]) / parent_sa
        cost = np.where(valid, cost, np.inf)
        i = int(np.argmin(cost))
        if best is None or cost[i] < best[0]:
            best = (float(cost[i]), axis, i, bin_of)

    if best is None:
        return None
    cost, axis, edge, bin_of = best
    lmask = bin_of <= edge
    if not lmask.any() or lmask.all():
        return None
    return lmask, cost


def remap_material_ranges(material_map: np.ndarray, material_ids: np.ndarray,
                          perm: np.ndarray, num_tris: int
                          ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Remap per-primitive material ranges after BVH triangle reorder.

    Expand ranges to per-triangle material ids,
    permute them into the new triangle order, then regroup consecutive runs.
    Returns (new_material_map, new_material_ids, per_tri_material).
    """
    per_tri = np.full(num_tris, -1, dtype=np.int32)
    if material_map is not None and len(material_map) > 0:
        starts = np.asarray(material_map, dtype=np.int64)
        ids = np.asarray(material_ids, dtype=np.int32)
        ends = np.append(starts[1:], num_tris)
        for s, e, mid in zip(starts, ends, ids):
            per_tri[s:e] = mid
    new_per_tri = per_tri[perm]

    # Regroup runs.
    if num_tris == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32), new_per_tri
    change = np.nonzero(np.diff(new_per_tri))[0] + 1
    run_starts = np.concatenate([[0], change]).astype(np.int32)
    run_ids = new_per_tri[run_starts].astype(np.int32)
    return run_starts, run_ids, new_per_tri


def compute_skip_links(bvh: BvhArrays) -> np.ndarray:
    """Skip link per node: where a depth-first walk continues after this
    subtree. For internal node n with children (l, r): skip[l] = r and
    skip[r] = skip[n]; skip[root] = -1 ends the walk."""
    skip = np.full(bvh.num_nodes, -1, dtype=np.int32)
    stack = [(0, -1)]
    while stack:
        node, cont = stack.pop()
        skip[node] = cont
        if not bvh.is_leaf[node]:
            left, right = int(bvh.left[node]), int(bvh.right[node])
            stack.append((right, cont))
            stack.append((left, right))
    return skip


# ---------------------------------------------------------------------------
# Native (C++) builder binding: csrc/bvh_builder.cpp
# ---------------------------------------------------------------------------

_NATIVE = {}


def _load_native():
    if "lib" in _NATIVE:
        return _NATIVE["lib"]
    from ..utils.native import ensure_native_lib
    lib = None
    path = ensure_native_lib("bvh_builder.cpp")
    if path is not None:
        lib = ctypes.CDLL(path)
        pf = ctypes.POINTER(ctypes.c_float)
        pi = ctypes.POINTER(ctypes.c_int)
        lib.build_bvh_sah.restype = ctypes.c_int
        lib.build_bvh_sah.argtypes = [
            pf, pf, ctypes.c_int, ctypes.c_int,   # tri_min, tri_max, T, leaf
            pf, pf, pi, pi, pi, pi, pi,           # out nodes (capacity 2T)
            ctypes.POINTER(ctypes.c_longlong)]    # out perm [T]
    _NATIVE["lib"] = lib
    return lib


def _build_native(lib, tri_min, tri_max, max_leaf_size):
    tri_min = np.ascontiguousarray(tri_min, dtype=np.float32)
    tri_max = np.ascontiguousarray(tri_max, dtype=np.float32)
    t = tri_min.shape[0]
    max_nodes = max(1, 2 * t)
    bmin = np.empty((max_nodes, 3), dtype=np.float32)
    bmax = np.empty((max_nodes, 3), dtype=np.float32)
    ints = [np.empty(max_nodes, dtype=np.int32) for _ in range(5)]
    perm = np.empty(t, dtype=np.int64)

    def fp(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def ip(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))

    n = lib.build_bvh_sah(
        fp(tri_min), fp(tri_max), t, max_leaf_size, fp(bmin), fp(bmax),
        *(ip(a) for a in ints),
        perm.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)))
    if n <= 0:
        raise RuntimeError("native BVH build failed")
    left, right, first, count, is_leaf = (a[:n].copy() for a in ints)
    return BvhArrays(bounds_min=bmin[:n].copy(), bounds_max=bmax[:n].copy(),
                     left=left, right=right, first=first, count=count,
                     is_leaf=is_leaf), perm
