"""Mesh loading: Wavefront OBJ.

Port of the OBJ path of `neural_renderer_tpu/scene/mesh_loader.py`
(`load_obj`, `_parse_obj_python`, `_smooth_normals`, `load_mesh_labeled`):
geometry only, one primitive with the global material (-1), smooth vertex
normals generated when the file has none. The native parser
`csrc/obj_parser.cpp` is compiled with the host compiler at first use and
gives the Python parser's output exactly; without a compiler the Python
parser runs. glTF/GLB, FBX, PLY and STL are not ported yet and raise
MeshLoadError naming the loader still to port.
"""

from __future__ import annotations

import ctypes
import os
import sys

import numpy as np

from .mesh import HostMesh

_UNPORTED = {".gltf": "load_gltf_with_materials", ".glb":
             "load_gltf_with_materials", ".fbx": "load_fbx",
             ".ply": "load_ply_stl", ".stl": "load_ply_stl"}


class MeshLoadError(RuntimeError):
    pass


def load_obj(path: str, scale: float = 1.0) -> HostMesh:
    parsed = _parse_obj_native(path)
    if parsed is None:
        parsed = _parse_obj_python(path)
    (positions, uvs, normals, norm_valid, indices, has_tex,
     has_norm) = parsed
    mesh = HostMesh(vertices=positions, indices=indices)
    if has_tex:
        mesh.texcoords = uvs
    if has_norm and bool(norm_valid.all()):
        lens = np.linalg.norm(normals, axis=1, keepdims=True)
        mesh.normals = np.where(
            lens > 1e-8, normals / np.maximum(lens, 1e-20),
            np.array([0, 1, 0], np.float32)).astype(np.float32)
    else:
        mesh.normals = _smooth_normals(mesh.vertices, mesh.indices)
    mesh.material_map = np.zeros(1, dtype=np.uint32)
    mesh.material_ids = np.full(1, -1, dtype=np.int32)
    mesh.scale(scale)
    return mesh


def _parse_obj_python(path: str):
    """Pure-Python OBJ parse. Returns the unified-vertex tuple
    (positions [V,3] f32, uvs [V,2] f32, normals [V,3] f32,
     norm_valid [V] bool, indices [T,3] u32, has_tex, has_norm)."""
    positions, tex, norms = [], [], []
    faces = []  # lists of (vi, ti, ni)
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                p = line.split()
                positions.append([float(p[1]), float(p[2]), float(p[3])])
            elif line.startswith("vt "):
                p = line.split()
                tex.append([float(p[1]), float(p[2]) if len(p) > 2 else 0.0])
            elif line.startswith("vn "):
                p = line.split()
                norms.append([float(p[1]), float(p[2]), float(p[3])])
            elif line.startswith("f "):
                corners = []
                for tok in line.split()[1:]:
                    comps = tok.split("/")
                    vi = int(comps[0])
                    ti = int(comps[1]) if len(comps) > 1 and comps[1] else 0
                    ni = int(comps[2]) if len(comps) > 2 and comps[2] else 0
                    corners.append((vi, ti, ni))
                faces.append(corners)
    if not faces:
        raise MeshLoadError(f"No triangles found in mesh: {path}")

    npos, ntex, nnorm = len(positions), len(tex), len(norms)

    def fix(i, n):
        return i - 1 if i > 0 else (n + i if i < 0 else -1)

    # Join identical (v, vt, vn) triples into unified vertices.
    vert_cache: dict[tuple, int] = {}
    out_pos, out_uv, out_norm, out_idx = [], [], [], []

    def vertex_id(corner):
        key = (fix(corner[0], npos), fix(corner[1], ntex),
               fix(corner[2], nnorm))
        cached = vert_cache.get(key)
        if cached is not None:
            return cached
        vert_cache[key] = idx = len(out_pos)
        out_pos.append(positions[key[0]])
        out_uv.append(tex[key[1]] if key[1] >= 0 else [0.0, 0.0])
        out_norm.append(norms[key[2]] if key[2] >= 0 else None)
        return idx

    for corners in faces:
        ids = [vertex_id(c) for c in corners]
        for k in range(1, len(ids) - 1):  # fan triangulation
            out_idx.append((ids[0], ids[k], ids[k + 1]))

    v = len(out_pos)
    norm_valid = np.array([n is not None for n in out_norm], dtype=bool)
    normals = np.asarray([n if n is not None else [0.0, 0.0, 0.0]
                          for n in out_norm], dtype=np.float32).reshape(v, 3)
    return (np.asarray(out_pos, dtype=np.float32).reshape(v, 3),
            np.asarray(out_uv, dtype=np.float32).reshape(v, 2),
            normals, norm_valid,
            np.asarray(out_idx, dtype=np.uint32).reshape(len(out_idx), 3),
            ntex > 0, nnorm > 0)


_NATIVE = {}


def _load_native():
    if "lib" in _NATIVE:
        return _NATIVE["lib"]
    from ..utils.native import ensure_native_lib
    lib = None
    path = ensure_native_lib("obj_parser.cpp", flags=("-O2",))
    if path is not None:
        lib = ctypes.CDLL(path)
        pf = ctypes.POINTER(ctypes.c_float)
        pu8 = ctypes.POINTER(ctypes.c_uint8)
        pu32 = ctypes.POINTER(ctypes.c_uint32)
        pll = ctypes.POINTER(ctypes.c_longlong)
        pi32 = ctypes.POINTER(ctypes.c_int32)
        lib.parse_obj.restype = ctypes.c_int
        lib.parse_obj.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(pf), ctypes.POINTER(pf),
            ctypes.POINTER(pf), ctypes.POINTER(pu8), ctypes.POINTER(pu32),
            pll, pll, pll, pi32, pi32]
        lib.free_obj.restype = None
        lib.free_obj.argtypes = [pf, pf, pf, pu8, pu32]
    _NATIVE["lib"] = lib
    return lib


def _parse_obj_native(path: str):
    """The tuple of `_parse_obj_python` from csrc/obj_parser.cpp, or None
    when there is no native library or it declines the file (the Python
    parser then gives the result or the user-facing error)."""
    lib = _load_native()
    if lib is None:
        return None
    pf = ctypes.POINTER(ctypes.c_float)
    pos, uv, norm = pf(), pf(), pf()
    nvalid = ctypes.POINTER(ctypes.c_uint8)()
    idx = ctypes.POINTER(ctypes.c_uint32)()
    n_verts, n_tris, n_faces = (ctypes.c_longlong() for _ in range(3))
    has_tex, has_norm = ctypes.c_int32(), ctypes.c_int32()
    rc = lib.parse_obj(path.encode(), ctypes.byref(pos), ctypes.byref(uv),
                       ctypes.byref(norm), ctypes.byref(nvalid),
                       ctypes.byref(idx), ctypes.byref(n_verts),
                       ctypes.byref(n_tris), ctypes.byref(n_faces),
                       ctypes.byref(has_tex), ctypes.byref(has_norm))
    if rc != 0:
        return None
    try:
        v, t = n_verts.value, n_tris.value

        def grab(ptr, count, dtype):
            if count == 0:
                return np.zeros(0, dtype)
            return np.ctypeslib.as_array(ptr, shape=(count,)).astype(
                dtype, copy=True)

        positions = grab(pos, v * 3, np.float32).reshape(v, 3)
        uvs = grab(uv, v * 2, np.float32).reshape(v, 2)
        normals = grab(norm, v * 3, np.float32).reshape(v, 3)
        valid = grab(nvalid, v, np.uint8).astype(bool)
        indices = grab(idx, t * 3, np.uint32).reshape(t, 3)
    finally:
        lib.free_obj(pos, uv, norm, nvalid, idx)
    return (positions, uvs, normals, valid, indices, bool(has_tex.value),
            bool(has_norm.value))


def _smooth_normals(vertices: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals."""
    idx = indices.astype(np.int64)
    v0 = vertices[idx[:, 0]]
    v1 = vertices[idx[:, 1]]
    v2 = vertices[idx[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    normals = np.zeros_like(vertices)
    for c in range(3):
        np.add.at(normals, idx[:, c], fn)
    lens = np.linalg.norm(normals, axis=1, keepdims=True)
    return np.where(lens > 1e-8, normals / np.maximum(lens, 1e-20),
                    np.array([0, 1, 0], np.float32)).astype(np.float32)


def load_mesh_auto(path: str, scale: float = 1.0) -> HostMesh:
    """Dispatch on the file extension."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        return load_obj(path, scale=scale)
    if ext in _UNPORTED:
        raise MeshLoadError(
            f"'{ext}' meshes are not ported yet (neural_renderer_tpu/scene/"
            f"mesh_loader.py::{_UNPORTED[ext]}): {path}")
    raise MeshLoadError(f"Unsupported mesh format '{ext}': {path}")


def load_mesh_labeled(path: str, label: str,
                      scale: float = 1.0) -> HostMesh | None:
    """Load a scene mesh; a failure is reported on stderr and gives None."""
    if not path:
        return None
    try:
        return load_mesh_auto(path, scale=scale)
    except (OSError, MeshLoadError) as e:
        print(f"Failed to load {label} mesh '{path}': {e}", file=sys.stderr)
        return None
