"""Meshes and ray queries of the plain reference: an OBJ reader, closest
hits and the nearest crossing of each facing, all by brute force.

Every ray is tested against every triangle with Möller–Trumbore in
float32 (or, for the lower-precision control, with every operand and
every operation in bfloat16), in blocks of rays by tiles of triangles so
that the pair tensors fit; the nearest hit wins and, among equal t, the
smallest triangle id. No acceleration structure is built, so nothing the
program derives at set-up (its BVH, clusters or packed shells) is taken.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

MISS = 1e30
MIN_T = 1e-6
TRI_EPSILON = 1e-8
ANY, FORWARD_ONLY, BACKWARD_ONLY = 0, 1, 2

# Ray-triangle pairs evaluated at once (the tensors of one block).
PAIRS_PER_BLOCK = 1 << 23


def read_obj(path: str):
    """(positions [V, 3] f32, normals [Vn, 3] f32, faces [T, 3] position
    ids, face normals [T, 3] normal ids or None). Polygons are fanned
    from their first corner; negative ids count from the end."""
    pos, nrm, faces, fnorm = [], [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                pos.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vn "):
                nrm.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                corners = [c.split("/") for c in line.split()[1:]]

                def idx(s, count):
                    i = int(s)
                    return i - 1 if i > 0 else count + i
                vid = [idx(c[0], len(pos)) for c in corners]
                nid = [idx(c[2], len(nrm)) if len(c) > 2 and c[2] else -1
                       for c in corners]
                for k in range(1, len(corners) - 1):
                    faces.append([vid[0], vid[k], vid[k + 1]])
                    fnorm.append([nid[0], nid[k], nid[k + 1]])
    faces = np.asarray(faces, np.int64)
    fnorm = np.asarray(fnorm, np.int64)
    normals = (None if len(nrm) == 0 or (fnorm < 0).any() else fnorm)
    return (np.asarray(pos, np.float32), np.asarray(nrm, np.float32).reshape(
        -1, 3), faces, normals)


@dataclass
class Mesh:
    """Triangles as corner rows [3, T] (v0, v1, v2, the edges e1 = v1 - v0
    and e2 = v2 - v0) and the corner normals n0, n1, n2 (None without
    normals); bounds of the positions the faces use."""
    v0: torch.Tensor
    v1: torch.Tensor
    v2: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    n0: torch.Tensor | None
    n1: torch.Tensor | None
    n2: torch.Tensor | None
    bmin: np.ndarray
    bmax: np.ndarray

    @property
    def num_triangles(self) -> int:
        return self.v0.shape[1]

    @staticmethod
    def from_obj(path: str, device) -> "Mesh":
        pos, nrm, faces, fn = read_obj(path)

        def rows(a, ids):
            return torch.as_tensor(np.ascontiguousarray(a[ids].T),
                                   device=device)
        v0, v1, v2 = (rows(pos, faces[:, k]) for k in range(3))
        if fn is None:
            n0 = n1 = n2 = None
        else:
            n0, n1, n2 = (rows(nrm, fn[:, k]) for k in range(3))
        used = pos[np.unique(faces)]
        return Mesh(v0, v1, v2, v1 - v0, v2 - v0, n0, n1, n2,
                    used.min(axis=0), used.max(axis=0))


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _pairs(o, d, v0, e1, e2):
    """Möller–Trumbore of rays o, d [3, R, 1] against triangles v0, e1, e2
    [3, 1, T] in the operands' dtype: (t [R, T] f32 with MISS where the
    pair is rejected, det [R, T])."""
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    ok = torch.abs(det) >= TRI_EPSILON
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tvec = (o[0] - v0[0], o[1] - v0[1], o[2] - v0[2])
    u = _dot(tvec, pvec) * inv
    ok &= (u >= 0.0) & (u <= 1.0)
    qvec = _cross(tvec, e1)
    v = _dot(d, qvec) * inv
    ok &= (v >= 0.0) & (u + v <= 1.0)
    t = (_dot(e2, qvec) * inv).float()
    ok &= (t > TRI_EPSILON) & (t > MIN_T)
    return torch.where(ok, t, torch.full_like(t, MISS)), det


def _blocks(n_rays: int, n_tris: int):
    tile = min(n_tris, 8192)
    rays = max(256, PAIRS_PER_BLOCK // tile)
    for r0 in range(0, n_rays, rays):
        yield slice(r0, min(n_rays, r0 + rays)), tile


def _operands(mesh: Mesh, o, d, low: bool):
    dt = torch.bfloat16 if low else torch.float32
    return (o.to(dt), d.to(dt), mesh.v0.to(dt), mesh.e1.to(dt),
            mesh.e2.to(dt))


def closest_hit(mesh: Mesh, o, d, mode: int = ANY, active=None,
                low: bool = False):
    """Closest hit of rays o, d [3, N] (those in `active`). Returns
    (t [N] with MISS on a miss, tri [N] int64, u [N], v [N])."""
    n = o.shape[1]
    dev = o.device
    best_t = torch.full((n,), MISS, dtype=torch.float32, device=dev)
    best_i = torch.zeros((n,), dtype=torch.int64, device=dev)
    idx = (torch.arange(n, device=dev) if active is None
           else torch.nonzero(active).squeeze(1))
    if idx.numel() and mesh.num_triangles:
        oo, dd, v0, e1, e2 = _operands(mesh, o[:, idx], d[:, idx], low)
        t_run = torch.full((idx.numel(),), MISS, device=dev)
        i_run = torch.zeros((idx.numel(),), dtype=torch.int64, device=dev)
        for rs, tile in _blocks(idx.numel(), mesh.num_triangles):
            for c in range(0, mesh.num_triangles, tile):
                cs = slice(c, c + tile)
                t, det = _pairs(oo[:, rs, None], dd[:, rs, None],
                                v0[:, None, cs], e1[:, None, cs],
                                e2[:, None, cs])
                if mode == FORWARD_ONLY:
                    t = torch.where(det > 0.0, t, torch.full_like(t, MISS))
                elif mode == BACKWARD_ONLY:
                    t = torch.where(det < 0.0, t, torch.full_like(t, MISS))
                tmin, arg = t.min(dim=1)
                better = tmin < t_run[rs]
                t_run[rs] = torch.where(better, tmin, t_run[rs])
                i_run[rs] = torch.where(better, arg + c, i_run[rs])
        best_t[idx] = t_run
        best_i[idx] = i_run
    u, v = barycentrics(mesh, o, d, best_i, low)
    hit = best_t < MISS
    zero = torch.zeros_like(u)
    return best_t, best_i, torch.where(hit, u, zero), torch.where(hit, v,
                                                                  zero)


def barycentrics(mesh: Mesh, o, d, tri, low: bool = False):
    """(u, v) of each ray on its triangle `tri`, as the pair test has them."""
    dt = torch.bfloat16 if low else torch.float32
    d_, o_ = d.to(dt), o.to(dt)
    v0, e1, e2 = (x[:, tri].to(dt) for x in (mesh.v0, mesh.e1, mesh.e2))
    pvec = _cross(d_, e2)
    det = _dot(e1, pvec)
    inv = 1.0 / torch.where(torch.abs(det) >= TRI_EPSILON, det,
                            torch.ones_like(det))
    tvec = (o_[0] - v0[0], o_[1] - v0[1], o_[2] - v0[2])
    u = _dot(tvec, pvec) * inv
    v = _dot(d_, _cross(tvec, e1)) * inv
    return u.float(), v.float()


def nearest_by_facing(mesh: Mesh, o, d, active=None, low: bool = False):
    """The nearest crossing of each facing: (forward t [N], backward t
    [N]), MISS where there is none; forward means det > 0 (the ray meets
    the front of the triangle)."""
    n = o.shape[1]
    dev = o.device
    fwd = torch.full((n,), MISS, dtype=torch.float32, device=dev)
    bwd = fwd.clone()
    idx = (torch.arange(n, device=dev) if active is None
           else torch.nonzero(active).squeeze(1))
    if idx.numel() == 0 or mesh.num_triangles == 0:
        return fwd, bwd
    oo, dd, v0, e1, e2 = _operands(mesh, o[:, idx], d[:, idx], low)
    f_run = torch.full((idx.numel(),), MISS, device=dev)
    b_run = f_run.clone()
    for rs, tile in _blocks(idx.numel(), mesh.num_triangles):
        for c in range(0, mesh.num_triangles, tile):
            cs = slice(c, c + tile)
            t, det = _pairs(oo[:, rs, None], dd[:, rs, None],
                            v0[:, None, cs], e1[:, None, cs],
                            e2[:, None, cs])
            big = torch.full_like(t, MISS)
            f_run[rs] = torch.minimum(
                f_run[rs], torch.where(det > 0.0, t, big).min(dim=1).values)
            b_run[rs] = torch.minimum(
                b_run[rs], torch.where(det < 0.0, t, big).min(dim=1).values)
    fwd[idx] = f_run
    bwd[idx] = b_run
    return fwd, bwd
