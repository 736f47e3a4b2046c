"""Mesh container: host-side buffers and device-ready tensors.

Port of `neural_renderer_tpu/scene/mesh.py` (`Mesh` -> `HostMesh`,
`MeshArrays` -> `MeshTensors`, `to_arrays` -> `to_tensors`) and of
`scene/mesh_loader.py::generate_uv_sphere`. `HostMesh.build_bvh` reorders
the triangles into SAH-BVH leaf order (`scene/bvh.py`), which makes
consecutive 256-triangle clusters spatially tight; `to_tensors` emits the
channel-major tensors the traces, the BVH walk and the hit-data stage read,
with the material tables and the texture atlas of `MaterialTable.build`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.trace_cluster import cluster_bounds_from_packed
from .bvh import (BvhArrays, build_bvh, compute_skip_links,
                  remap_material_ranges)
from .materials import MaterialTable


@dataclass
class MeshTensors:
    """Device-side mesh, triangles in leaf order.

    tris_packed rows 0-2 v0, 3-5 e1 = v1 - v0, 6-8 e2 = v2 - v0;
    cluster_bounds rows 0-2 min, 3-5 max of consecutive 256-triangle
    clusters; bounds_min/max the root AABB. These five serve the shell
    traces. The ground-truth path also reads the indexed geometry, the
    packed BVH nodes (rows 0-2 bmin, 3-5 bmax, 6 left, 7 skip, 8 first,
    9 count, 10 is_leaf, the int rows bitcast to f32), the material rows,
    the per-material texture slots and channels and the texture atlas;
    they are None on a mesh built from packed triangles only."""
    tris_packed: torch.Tensor     # [9, T] f32 (T >= 1; zeros when empty)
    cluster_bounds: torch.Tensor  # [6, C] f32
    bounds_min: torch.Tensor      # [3] f32
    bounds_max: torch.Tensor      # [3] f32
    num_triangles: int
    vertices: torch.Tensor | None = None      # [3, V] f32
    normals: torch.Tensor | None = None       # [3, V] f32
    uvs: torch.Tensor | None = None           # [2, V] f32
    indices: torch.Tensor | None = None       # [3, T] int64
    tri_material: torch.Tensor | None = None  # [T] int64, -1 = global
    nodes_packed: torch.Tensor | None = None  # [11, N] f32
    mat_scalars: torch.Tensor | None = None   # [NUM_SCALARS, M] f32
    mat_tex_ids: torch.Tensor | None = None   # [NUM_TEX_SLOTS, M] int64
    mat_tex_chans: torch.Tensor | None = None  # [NUM_TEX_SLOTS, M] int64
    atlas: torch.Tensor | None = None         # [3, P] f32
    tex_offset: torch.Tensor | None = None    # [Ntex] int64
    tex_width: torch.Tensor | None = None     # [Ntex] int64
    tex_height: torch.Tensor | None = None    # [Ntex] int64
    has_normals: bool = False
    has_uvs: bool = False
    has_materials: bool = False
    has_textures: bool = False
    has_normal_maps: bool = False
    texture_nearest: bool = False
    max_leaf: int = 4

    @property
    def is_empty(self) -> bool:
        return self.num_triangles == 0

    @staticmethod
    def from_packed(tris_packed: np.ndarray, num_triangles: int,
                    device="cuda", **extra) -> "MeshTensors":
        """From packed triangles; `extra` are further fields as numpy arrays
        (moved to `device`) or flags."""
        tp = np.ascontiguousarray(tris_packed, np.float32)
        if num_triangles == 0:
            lo = hi = np.zeros(3, np.float32)
        else:
            real = tp[:, :num_triangles]
            v0 = real[0:3]
            pts = np.concatenate([v0, v0 + real[3:6], v0 + real[6:9]], axis=1)
            lo, hi = pts.min(axis=1), pts.max(axis=1)

        def t(x):
            return torch.as_tensor(np.array(x, np.float32), device=device)

        fields = {}
        for name, val in extra.items():
            if name in _INT_FIELDS:
                val = torch.as_tensor(np.array(val, np.int64), device=device)
            elif isinstance(val, np.ndarray):
                val = t(val)
            fields[name] = val
        return MeshTensors(
            tris_packed=t(tp),
            cluster_bounds=t(cluster_bounds_from_packed(tp, num_triangles)),
            bounds_min=t(lo), bounds_max=t(hi),
            num_triangles=int(num_triangles), **fields)


_INT_FIELDS = ("indices", "tri_material", "mat_tex_ids", "mat_tex_chans",
               "tex_offset", "tex_width", "tex_height")


def pack_nodes(bvh: BvhArrays) -> np.ndarray:
    """[11, N] f32 node rows for the BVH walk (see MeshTensors)."""
    nodes = np.zeros((11, bvh.num_nodes), np.float32)
    nodes[0:3] = bvh.bounds_min.T
    nodes[3:6] = bvh.bounds_max.T
    for row, ints in ((6, bvh.left), (7, compute_skip_links(bvh)),
                      (8, bvh.first), (9, bvh.count), (10, bvh.is_leaf)):
        nodes[row] = ints.astype(np.int32).view(np.float32)
    return nodes


@dataclass
class HostMesh:
    """Indexed triangle mesh on the host: vertices [V, 3], indices [T, 3],
    optional per-vertex normals [V, 3] and texcoords [V, 2], per-primitive
    material ranges, materials and their textures ([H, W(, C)] arrays;
    nearest or bilinear filtering)."""
    vertices: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 3), np.float32))
    indices: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 3), np.uint32))
    normals: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 3), np.float32))
    texcoords: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 2), np.float32))
    material_map: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.uint32))  # first tri per range
    material_ids: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32))   # material per range
    materials: list = field(default_factory=list)        # [Material]
    has_mesh_materials: bool = False
    textures: list = field(default_factory=list)         # [np.ndarray]
    texture_nearest: bool = False
    _bvh: BvhArrays | None = field(default=None, repr=False)
    _tri_material: np.ndarray | None = field(default=None, repr=False)

    @property
    def num_triangles(self) -> int:
        return int(self.indices.shape[0])

    def bounds(self):
        if self.vertices.shape[0] == 0:
            z = np.zeros(3, np.float32)
            return z, z
        return (self.vertices.min(axis=0).astype(np.float32),
                self.vertices.max(axis=0).astype(np.float32))

    def normalize(self):
        """Center at the origin and scale so the largest extent is 10."""
        if self.vertices.shape[0] == 0:
            return
        vmin = self.vertices.min(axis=0)
        vmax = self.vertices.max(axis=0)
        extent = float((vmax - vmin).max())
        if extent <= 0.0:
            return
        center = 0.5 * (vmin + vmax)
        self.vertices = ((self.vertices - center)
                         * (2.0 / extent * 5.0)).astype(np.float32)
        self._bvh = None

    def scale(self, s: float):
        if s != 1.0:
            self.vertices = (self.vertices * np.float32(s)).astype(np.float32)
            self._bvh = None

    def build_bvh(self, max_leaf_size: int = 4) -> BvhArrays:
        """Build (or return the cached) SAH BVH; reorders self.indices to
        leaf order and remaps the material ranges."""
        if self._bvh is not None:
            return self._bvh
        t = self.num_triangles
        if t == 0:
            self._bvh = BvhArrays(
                bounds_min=np.zeros((1, 3), np.float32),
                bounds_max=np.zeros((1, 3), np.float32),
                left=np.full(1, -1, np.int32), right=np.full(1, -1, np.int32),
                first=np.zeros(1, np.int32), count=np.zeros(1, np.int32),
                is_leaf=np.ones(1, np.int32))
            self._tri_material = np.zeros(0, np.int32)
            return self._bvh
        tri = self.vertices[self.indices.astype(np.int64)]  # [T, 3, 3]
        bvh, perm = build_bvh(tri.min(axis=1), tri.max(axis=1),
                              max_leaf_size=max_leaf_size)
        self.indices = self.indices[perm]
        mmap, mids, per_tri = remap_material_ranges(
            self.material_map, self.material_ids, perm, t)
        self.material_map = mmap.astype(np.uint32)
        self.material_ids = mids.astype(np.int32)
        self._tri_material = per_tri
        self._bvh = bvh
        return bvh

    def to_tensors(self, device="cuda") -> MeshTensors:
        bvh = self.build_bvh()
        nv, nt = self.vertices.shape[0], self.num_triangles
        v, t = max(1, nv), max(1, nt)
        vertices = np.zeros((v, 3), np.float32)
        vertices[:nv] = self.vertices
        normals = np.zeros((v, 3), np.float32)
        has_normals = self.normals.shape[0] > 0
        if has_normals:
            normals[:self.normals.shape[0]] = self.normals
        uvs = np.zeros((v, 2), np.float32)
        has_uvs = self.texcoords.shape[0] > 0
        if has_uvs:
            uvs[:self.texcoords.shape[0]] = self.texcoords
        indices = np.zeros((t, 3), np.int64)
        indices[:nt] = self.indices.astype(np.int64)
        tri_material = np.full(t, -1, np.int64)
        tri_material[:nt] = self._tri_material

        tri = vertices[indices]  # [T, 3, 3]
        packed = np.zeros((9, t), np.float32)
        packed[0:3] = tri[:, 0].T
        packed[3:6] = (tri[:, 1] - tri[:, 0]).T
        packed[6:9] = (tri[:, 2] - tri[:, 0]).T

        table = MaterialTable.build(self.materials, self.textures,
                                    texture_nearest=self.texture_nearest)
        mesh = MeshTensors.from_packed(
            packed, nt, device=device, vertices=vertices.T.copy(),
            normals=normals.T.copy(), uvs=uvs.T.copy(),
            indices=indices.T.copy(), tri_material=tri_material,
            nodes_packed=pack_nodes(bvh),
            mat_scalars=table.scalars.T.copy(),
            mat_tex_ids=table.tex_ids.T.copy(),
            mat_tex_chans=table.tex_chans.T.copy(),
            atlas=table.atlas.T.copy(), tex_offset=table.tex_offset,
            tex_width=table.tex_width, tex_height=table.tex_height,
            has_normals=has_normals, has_uvs=has_uvs,
            has_materials=self.has_mesh_materials and len(self.materials) > 0,
            has_textures=len(self.textures) > 0,
            has_normal_maps=(len(self.textures) > 0 and any(
                m.normal.textured for m in self.materials)),
            texture_nearest=self.texture_nearest,
            max_leaf=max(1, bvh.max_leaf_count()))
        # The walk and the skip flags use the BVH root box, as the JAX
        # package does.
        mesh.bounds_min = torch.as_tensor(bvh.bounds_min[0].copy(),
                                          device=device)
        mesh.bounds_max = torch.as_tensor(bvh.bounds_max[0].copy(),
                                          device=device)
        return mesh


def generate_uv_sphere(stacks: int, slices: int, radius: float) -> HostMesh:
    """Procedural UV sphere with per-vertex normals and uvs, wound inward
    like `neural_renderer_tpu/scene/mesh_loader.py::generate_uv_sphere`."""
    if stacks < 2 or slices < 3:
        return HostMesh()
    verts, normals, uvs = [], [], []
    for i in range(stacks + 1):
        phi = (i / stacks) * math.pi
        for j in range(slices + 1):
            theta = (j / slices) * 2.0 * math.pi
            x = math.sin(phi) * math.cos(theta)
            y = math.cos(phi)
            z = math.sin(phi) * math.sin(theta)
            verts.append([x * radius, y * radius, z * radius])
            normals.append([x, y, z])
            uvs.append([j / slices, i / stacks])
    idx = []
    for i in range(stacks):
        for j in range(slices):
            p0 = i * (slices + 1) + j
            p1 = p0 + 1
            p2 = p0 + (slices + 1)
            p3 = p2 + 1
            idx.append([p0, p2, p1])
            idx.append([p1, p2, p3])
    return HostMesh(np.asarray(verts, np.float32), np.asarray(idx, np.uint32),
                    np.asarray(normals, np.float32),
                    np.asarray(uvs, np.float32),
                    material_map=np.zeros(1, np.uint32),
                    material_ids=np.full(1, -1, np.int32))


def outward_sphere(stacks: int, slices: int, radius: float) -> HostMesh:
    """UV sphere with outward geometric normals (the shell scenes')."""
    m = generate_uv_sphere(stacks, slices, radius)
    m.indices = m.indices[:, [0, 2, 1]].copy()
    return m
