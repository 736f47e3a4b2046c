"""Mesh loading: glTF 2.0 / GLB with PBR materials, OBJ, PLY, STL and FBX.

Port of `neural_renderer_tpu/scene/mesh_loader.py`:
  * glTF / GLB (`load_gltf_with_materials`): GLB chunks, external buffers
    and data URIs, strided and sparse accessors, the node tree with TRS and
    matrix transforms, per-primitive material ranges, `_gltf_material`
    (base colour and normal textures, emissive, the transmission / IOR /
    emissive-strength extensions; the metallic-roughness texture is read as
    the constant factors, as the reference does) and embedded or external
    PNG and JPEG images, decoded by `metrics/image_io.decode_png` and
    `metrics/jpeg.decode_jpeg` to the dtype and channels imageio gives the
    reference. An image that fails to decode is reported and replaced by
    one black texel, as the reference does;
  * OBJ (`load_obj`, `_parse_obj_python`, `_smooth_normals`): geometry only,
    one primitive with the global material (-1), smooth vertex normals
    generated when the file has none. The native parser
    `csrc/obj_parser.cpp` is compiled with the host compiler at first use
    and gives the Python parser's output exactly; without a compiler the
    Python parser runs;
  * PLY and STL (`load_ply_stl`, parsers in `scene/ply_stl_loader.py`) and
    binary FBX (`load_fbx`, `scene/fbx_loader.py`): geometry only, like OBJ.
Every loader takes `normalize` (fit the mesh to an extent of 10 about the
origin, `HostMesh.normalize`) and then `scale`.
"""

from __future__ import annotations

import base64
import ctypes
import json
import os
import struct
import sys
import zlib
from urllib.parse import unquote

import numpy as np

from .materials import Material, MaterialParam, MaterialParamVec3
from .mesh import HostMesh

class MeshLoadError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# glTF 2.0
# ---------------------------------------------------------------------------

_GLTF_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_GLTF_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
               "MAT2": 4, "MAT3": 9, "MAT4": 16}


def _read_glb(path: str) -> tuple[dict, bytes | None]:
    with open(path, "rb") as f:
        data = f.read()
    magic, _version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:
        raise MeshLoadError(f"not a GLB file: {path}")
    offset = 12
    gltf_json, binary = None, None
    while offset + 8 <= len(data):
        chunk_len, chunk_type = struct.unpack_from("<II", data, offset)
        offset += 8
        chunk = data[offset:offset + chunk_len]
        offset += chunk_len
        if chunk_type == 0x4E4F534A:  # 'JSON'
            gltf_json = json.loads(chunk.decode("utf-8"))
        elif chunk_type == 0x004E4942:  # 'BIN\0'
            binary = chunk
    if gltf_json is None:
        raise MeshLoadError(f"GLB file has no JSON chunk: {path}")
    return gltf_json, binary


def _load_buffers(gltf: dict, base_dir: str,
                  glb_bin: bytes | None) -> list[bytes]:
    buffers = []
    for buf in gltf.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            buffers.append(glb_bin or b"")
        elif uri.startswith("data:"):
            buffers.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, unquote(uri)), "rb") as f:
                buffers.append(f.read())
    return buffers


def _read_accessor(gltf: dict, buffers: list[bytes],
                   accessor_idx: int) -> np.ndarray:
    acc = gltf["accessors"][accessor_idx]
    ncomp = _GLTF_NCOMP[acc["type"]]
    dtype = _GLTF_DTYPES[acc["componentType"]]
    count = acc["count"]
    itemsize = np.dtype(dtype).itemsize
    out = np.zeros((count, ncomp), dtype=dtype)
    if "bufferView" in acc:
        view = gltf["bufferViews"][acc["bufferView"]]
        buf = buffers[view["buffer"]]
        start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = view.get("byteStride") or ncomp * itemsize
        if stride == ncomp * itemsize:
            raw = np.frombuffer(buf, dtype=dtype, count=count * ncomp,
                                offset=start)
            out = raw.reshape(count, ncomp).copy()
        else:
            for i in range(count):
                out[i] = np.frombuffer(buf, dtype=dtype, count=ncomp,
                                       offset=start + i * stride)
    sparse = acc.get("sparse")
    if sparse:
        sc = sparse["count"]
        iview = gltf["bufferViews"][sparse["indices"]["bufferView"]]
        idt = _GLTF_DTYPES[sparse["indices"]["componentType"]]
        ioff = iview.get("byteOffset", 0) \
            + sparse["indices"].get("byteOffset", 0)
        sidx = np.frombuffer(buffers[iview["buffer"]], dtype=idt, count=sc,
                             offset=ioff).astype(np.int64)
        vview = gltf["bufferViews"][sparse["values"]["bufferView"]]
        voff = vview.get("byteOffset", 0) \
            + sparse["values"].get("byteOffset", 0)
        svals = np.frombuffer(buffers[vview["buffer"]], dtype=dtype,
                              count=sc * ncomp, offset=voff).reshape(sc,
                                                                     ncomp)
        out[sidx] = svals
    return out


def _trs_matrix(node: dict) -> np.ndarray:
    """A node's transform as a [4, 4] matrix M, points mapped as M @ p."""
    if "matrix" in node:
        return np.asarray(node["matrix"], dtype=np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "scale" in node:
        s = node["scale"]
        m = np.diag([s[0], s[1], s[2], 1.0]) @ m
    if "rotation" in node:
        qx, qy, qz, qw = node["rotation"]
        r = np.eye(4)
        r[0, 0] = 1 - 2 * (qy * qy + qz * qz)
        r[1, 0] = 2 * (qx * qy + qz * qw)
        r[2, 0] = 2 * (qx * qz - qy * qw)
        r[0, 1] = 2 * (qx * qy - qz * qw)
        r[1, 1] = 1 - 2 * (qx * qx + qz * qz)
        r[2, 1] = 2 * (qy * qz + qx * qw)
        r[0, 2] = 2 * (qx * qz + qy * qw)
        r[1, 2] = 2 * (qy * qz - qx * qw)
        r[2, 2] = 1 - 2 * (qx * qx + qy * qy)
        m = r @ m
    if "translation" in node:
        t = np.eye(4)
        t[:3, 3] = node["translation"]
        m = t @ m
    return m


def _load_gltf_image(gltf: dict, buffers: list[bytes], base_dir: str,
                     image: dict) -> np.ndarray | None:
    """An image's pixels as imageio gives them (decode_png(rgb=False), or
    decode_jpeg for data that starts with the JPEG SOI marker), or None (an
    image that fails to decode, reported on stderr)."""
    from ..metrics.image_io import decode_png
    from ..metrics.jpeg import JPEG_SOI, decode_jpeg
    try:
        if "uri" in image:
            uri = image["uri"]
            if uri.startswith("data:"):
                raw = base64.b64decode(uri.split(",", 1)[1])
            else:
                with open(os.path.join(base_dir, unquote(uri)), "rb") as f:
                    raw = f.read()
        elif "bufferView" in image:
            view = gltf["bufferViews"][image["bufferView"]]
            start = view.get("byteOffset", 0)
            raw = bytes(buffers[view["buffer"]][start:start
                                                 + view["byteLength"]])
        else:
            return None
        if raw[:3] == JPEG_SOI:
            return decode_jpeg(raw)
        return decode_png(raw, rgb=False)
    except (OSError, ValueError, struct.error, zlib.error) as e:
        print(f"GLTF Warning: failed to load image: {e}", file=sys.stderr)
        return None


def _gltf_material(gmat: dict, textures_src: list[int]) -> Material:
    """One glTF material."""
    mat = Material.default()
    pbr = gmat.get("pbrMetallicRoughness", {})
    bcf = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])
    mat.base_color = MaterialParamVec3.constant(bcf[:3])
    bct = pbr.get("baseColorTexture")
    if bct is not None and bct.get("index", -1) >= 0:
        src = textures_src[bct["index"]]
        if src >= 0:
            mat.base_color = MaterialParamVec3.texture(src)

    mat.metallic = MaterialParam.constant(pbr.get("metallicFactor", 1.0))
    mat.roughness = MaterialParam.constant(pbr.get("roughnessFactor", 1.0))
    # The reference reads the metallicRoughness texture and then disables
    # it: the constant factors stand.

    nt = gmat.get("normalTexture")
    if nt is not None and nt.get("index", -1) >= 0:
        src = textures_src[nt["index"]]
        if src >= 0:
            mat.normal = MaterialParamVec3.texture(src)

    emissive = gmat.get("emissiveFactor")
    if emissive:
        mat.base_emission = MaterialParamVec3.constant(emissive)
        et = gmat.get("emissiveTexture")
        if et is not None and et.get("index", -1) >= 0:
            src = textures_src[et["index"]]
            if src >= 0:
                mat.base_emission = MaterialParamVec3(
                    value=tuple(emissive), texture_id=src)

    ext = gmat.get("extensions", {})
    if "KHR_materials_transmission" in ext:
        mat.specular_transmission = float(
            ext["KHR_materials_transmission"].get("transmissionFactor", 0.0))
    if "KHR_materials_ior" in ext:
        mat.ior = float(ext["KHR_materials_ior"].get("ior", 1.5))
    if "KHR_materials_emissive_strength" in ext:
        mat.emission_scale = float(
            ext["KHR_materials_emissive_strength"].get("emissiveStrength",
                                                       1.0))
    return mat


def load_gltf_with_materials(path: str, normalize: bool = False,
                             scale: float = 1.0) -> HostMesh:
    base_dir = os.path.dirname(os.path.abspath(path))
    if path.lower().endswith(".glb"):
        gltf, glb_bin = _read_glb(path)
    else:
        with open(path, "r") as f:
            gltf = json.load(f)
        glb_bin = None
    buffers = _load_buffers(gltf, base_dir, glb_bin)

    mesh = HostMesh()
    # Images are decoded eagerly; a texture names its image (source).
    for image in gltf.get("images", []):
        img = _load_gltf_image(gltf, buffers, base_dir, image)
        if img is None:
            img = np.zeros((1, 1, 3), dtype=np.uint8)
        mesh.textures.append(img)
    textures_src = [t.get("source", -1) for t in gltf.get("textures", [])]

    for gmat in gltf.get("materials", []):
        mesh.materials.append(_gltf_material(gmat, textures_src))
    if not mesh.materials:
        mesh.materials.append(Material.default())
    mesh.has_mesh_materials = True

    vertices, normals, uvs, indices = [], [], [], []
    material_map, material_ids = [], []

    def process_node(node_idx: int, parent: np.ndarray):
        node = gltf["nodes"][node_idx]
        world = parent @ _trs_matrix(node)
        if "mesh" in node:
            for prim in gltf["meshes"][node["mesh"]].get("primitives", []):
                if prim.get("mode", 4) != 4:  # TRIANGLES only
                    continue
                attrs = prim.get("attributes", {})
                if "POSITION" not in attrs:
                    continue
                material_map.append(sum(len(f) for f in indices))
                base_vertex = sum(len(v) for v in vertices)

                pos = _read_accessor(gltf, buffers,
                                     attrs["POSITION"]).astype(np.float64)
                n = pos.shape[0]
                pos_w = (world[:3, :3] @ pos.T).T + world[:3, 3]
                vertices.append(pos_w.astype(np.float32))

                if "NORMAL" in attrs:
                    nor = _read_accessor(gltf, buffers,
                                         attrs["NORMAL"]).astype(np.float64)
                    nor_w = (world[:3, :3] @ nor.T).T
                    lens = np.linalg.norm(nor_w, axis=1, keepdims=True)
                    nor_w = np.where(lens > 1e-8,
                                     nor_w / np.maximum(lens, 1e-20),
                                     np.array([0.0, 1.0, 0.0]))
                    normals.append(nor_w.astype(np.float32))
                else:
                    d = np.zeros((n, 3), np.float32)
                    d[:, 1] = 1.0
                    normals.append(d)

                if "TEXCOORD_0" in attrs:
                    uv = _read_accessor(gltf, buffers, attrs["TEXCOORD_0"])
                    if uv.dtype == np.uint8:
                        uv = uv.astype(np.float32) / 255.0
                    elif uv.dtype == np.uint16:
                        uv = uv.astype(np.float32) / 65535.0
                    uvs.append(uv[:, :2].astype(np.float32))
                else:
                    uvs.append(np.zeros((n, 2), np.float32))

                if "indices" in prim and prim["indices"] >= 0:
                    idx = _read_accessor(gltf, buffers,
                                         prim["indices"]).reshape(-1)
                    ntri = idx.shape[0] // 3
                    tris = idx[:ntri * 3].reshape(ntri, 3).astype(np.uint32)
                else:
                    ntri = n // 3
                    tris = np.arange(ntri * 3, dtype=np.uint32).reshape(
                        ntri, 3)
                indices.append(tris + np.uint32(base_vertex))
                material_ids.append(prim.get("material", 0)
                                    if prim.get("material", -1) >= 0 else 0)
        for child in node.get("children", []):
            process_node(child, world)

    for scene_desc in gltf.get("scenes", []):
        for node_idx in scene_desc.get("nodes", []):
            process_node(node_idx, np.eye(4))

    if not indices or sum(len(f) for f in indices) == 0:
        raise MeshLoadError(f"No triangles found in GLTF file: {path}")

    mesh.vertices = np.concatenate(vertices, axis=0)
    mesh.normals = np.concatenate(normals, axis=0)
    mesh.texcoords = np.concatenate(uvs, axis=0)
    mesh.indices = np.concatenate(indices, axis=0)
    mesh.material_map = np.asarray(material_map, dtype=np.uint32)
    mesh.material_ids = np.asarray(material_ids, dtype=np.int32)
    if normalize:
        mesh.normalize()
    mesh.scale(scale)
    return mesh


# ---------------------------------------------------------------------------
# OBJ
# ---------------------------------------------------------------------------


def load_obj(path: str, normalize: bool = False,
             scale: float = 1.0) -> HostMesh:
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
    if normalize:
        mesh.normalize()
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


def _geometry_mesh(vertices, indices, normals, normalize: bool,
                   scale: float) -> HostMesh:
    """A geometry-only mesh: one primitive with the global material (-1),
    smooth normals where the file has none."""
    mesh = HostMesh(vertices=vertices.astype(np.float32),
                    indices=indices.astype(np.uint32))
    mesh.normals = (_smooth_normals(mesh.vertices, mesh.indices)
                    if normals is None else normals.astype(np.float32))
    mesh.material_map = np.zeros(1, np.uint32)
    mesh.material_ids = np.full(1, -1, np.int32)
    if normalize:
        mesh.normalize()
    mesh.scale(scale)
    return mesh


def load_ply_stl(path: str, normalize: bool = False,
                 scale: float = 1.0) -> HostMesh:
    """PLY (ascii and binary; fan-triangulated polygons, optional vertex
    normals) or STL (binary and ascii, exact-duplicate vertices welded)."""
    from .ply_stl_loader import (GeometryParseError, load_ply_geometry,
                                 load_stl_geometry)
    loader = (load_ply_geometry
              if os.path.splitext(path)[1].lower() == ".ply"
              else load_stl_geometry)
    try:
        vertices, indices, normals = loader(path)
    except (GeometryParseError, struct.error, KeyError, IndexError) as e:
        raise MeshLoadError(f"{path}: {e}") from e
    return _geometry_mesh(vertices, indices, normals, normalize, scale)


def load_fbx(path: str, normalize: bool = False,
             scale: float = 1.0) -> HostMesh:
    """Binary FBX: every geometry pre-transformed by its model chain, fan
    triangulated, the file's normals or smooth ones."""
    from .fbx_loader import FbxError, load_fbx_geometry
    try:
        vertices, indices, normals = load_fbx_geometry(path)
    except FbxError as e:
        raise MeshLoadError(str(e)) from e
    return _geometry_mesh(vertices, indices, normals, normalize, scale)


def load_mesh_from_file(path: str, normalize: bool = False,
                        scale: float = 1.0) -> HostMesh:
    """OBJ, FBX, PLY or STL by the file extension."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        return load_obj(path, normalize=normalize, scale=scale)
    if ext == ".fbx":
        return load_fbx(path, normalize=normalize, scale=scale)
    if ext in (".ply", ".stl"):
        return load_ply_stl(path, normalize=normalize, scale=scale)
    raise MeshLoadError(f"Unsupported mesh format '{ext}': {path}")


def load_mesh_auto(path: str, normalize: bool = False,
                   scale: float = 1.0) -> HostMesh:
    """Dispatch on the file extension."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".gltf", ".glb"):
        return load_gltf_with_materials(path, normalize=normalize,
                                        scale=scale)
    return load_mesh_from_file(path, normalize=normalize, scale=scale)


def load_mesh_labeled(path: str, label: str, normalize: bool = False,
                      nearest_tex: bool = False,
                      scale: float = 1.0) -> HostMesh | None:
    """Load a scene mesh with nearest (or bilinear) texture filtering; a
    failure is reported on stderr and gives None."""
    if not path:
        return None
    try:
        mesh = load_mesh_auto(path, normalize=normalize, scale=scale)
    except (OSError, MeshLoadError) as e:
        print(f"Failed to load {label} mesh '{path}': {e}", file=sys.stderr)
        return None
    mesh.texture_nearest = nearest_tex
    return mesh
