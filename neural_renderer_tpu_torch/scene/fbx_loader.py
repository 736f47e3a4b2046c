"""Minimal binary-FBX geometry loader.

Port (a copy: the module imports nothing of JAX) of
`neural_renderer_tpu/scene/fbx_loader.py`. Parity target: the reference
renderer's Assimp import path (triangulate, pretransform vertices, smooth
normals), geometry only: one primitive with the global material.

  * binary FBX 7.x container (Kaydara header, nested node records, typed
    properties, zlib-compressed arrays)
  * Objects/Geometry: Vertices, PolygonVertexIndex (negative index ends a
    polygon, value = ~index), LayerElementNormal (ByPolygonVertex / ByVertex
    mappings, Direct / IndexToDirect reference modes)
  * Objects/Model transforms: Lcl Translation / Rotation (XYZ Euler,
    degrees) / Scaling, plus the geometric pivot properties
    (GeometricTranslation/Rotation/Scaling), composed through the
    Connections (OO) parent chain — the pretransform step
  * fan triangulation of n-gons; area-weighted smooth vertex normals when
    the file carries none (GenSmoothNormals equivalent)

ASCII FBX is detected and rejected with a pointer to supported formats.
FBX native units/axes are passed through untouched (the reference relies on
Assimp defaults, which also pass through unless the exporter says otherwise).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_BINARY_MAGIC = b"Kaydara FBX Binary  \x00"


class FbxError(ValueError):
    pass


class _Node:
    __slots__ = ("name", "props", "children")

    def __init__(self, name, props, children):
        self.name = name
        self.props = props
        self.children = children

    def find(self, name):
        for c in self.children:
            if c.name == name:
                return c
        return None

    def find_all(self, name):
        return [c for c in self.children if c.name == name]


def _read_array(buf, off, fmt, itemsize):
    length, encoding, comp_len = struct.unpack_from("<III", buf, off)
    off += 12
    if encoding == 1:
        raw = zlib.decompress(buf[off:off + comp_len])
        off += comp_len
    else:
        raw = buf[off:off + length * itemsize]
        off += length * itemsize
    return np.frombuffer(raw, dtype=fmt).copy(), off


def _read_property(buf, off):
    code = buf[off:off + 1]
    off += 1
    if code == b"Y":
        v = struct.unpack_from("<h", buf, off)[0]; off += 2
    elif code == b"C":
        v = bool(buf[off]); off += 1
    elif code == b"I":
        v = struct.unpack_from("<i", buf, off)[0]; off += 4
    elif code == b"F":
        v = struct.unpack_from("<f", buf, off)[0]; off += 4
    elif code == b"D":
        v = struct.unpack_from("<d", buf, off)[0]; off += 8
    elif code == b"L":
        v = struct.unpack_from("<q", buf, off)[0]; off += 8
    elif code == b"f":
        v, off = _read_array(buf, off, "<f4", 4)
    elif code == b"d":
        v, off = _read_array(buf, off, "<f8", 8)
    elif code == b"l":
        v, off = _read_array(buf, off, "<i8", 8)
    elif code == b"i":
        v, off = _read_array(buf, off, "<i4", 4)
    elif code == b"b":
        v, off = _read_array(buf, off, "u1", 1)
    elif code == b"S" or code == b"R":
        n = struct.unpack_from("<I", buf, off)[0]; off += 4
        raw = buf[off:off + n]; off += n
        v = raw.decode("utf-8", "replace") if code == b"S" else raw
    else:
        raise FbxError(f"unknown FBX property type {code!r}")
    return v, off


def _read_node(buf, off, version):
    """Returns (node_or_None, next_offset). None = NULL terminator record."""
    if version >= 7500:
        end, n_props, _props_len = struct.unpack_from("<QQQ", buf, off)
        off += 24
    else:
        end, n_props, _props_len = struct.unpack_from("<III", buf, off)
        off += 12
    name_len = buf[off]
    off += 1
    name = buf[off:off + name_len].decode("utf-8", "replace")
    off += name_len
    if end == 0 and n_props == 0 and not name:
        return None, off
    props = []
    for _ in range(n_props):
        v, off = _read_property(buf, off)
        props.append(v)
    children = []
    while off < end:
        child, off = _read_node(buf, off, version)
        if child is None:
            break
        children.append(child)
    return _Node(name, props, children), end


def _parse(data: bytes):
    if not data.startswith(_BINARY_MAGIC):
        if data[:1] == b";" or b"FBXHeaderExtension" in data[:4096]:
            raise FbxError(
                "ASCII FBX is not supported — export as binary FBX, or use "
                "glTF/GLB/OBJ (scene/mesh_loader.py).")
        raise FbxError("not an FBX binary file")
    version = struct.unpack_from("<I", data, 23)[0]
    off = 27
    roots = []
    while off < len(data):
        node, off = _read_node(data, off, version)
        if node is None:
            break
        roots.append(node)
    return _Node("", [], roots), version


# ---------------------------------------------------------------------------
# Scene reconstruction
# ---------------------------------------------------------------------------

def _euler_xyz_deg(rx, ry, rz):
    """FBX default rotation order is XYZ (applied X then Y then Z):
    R = Rz @ Ry @ Rx."""
    rx, ry, rz = np.radians([rx, ry, rz])
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return mz @ my @ mx


def _prop70(node, name, default):
    """Fetch a Properties70 vector (3 doubles) by name."""
    p70 = node.find("Properties70")
    if p70 is None:
        return np.asarray(default, np.float64)
    for p in p70.find_all("P"):
        if p.props and p.props[0] == name:
            return np.asarray(p.props[-3:], np.float64)
    return np.asarray(default, np.float64)


def _model_matrix(model):
    t = _prop70(model, "Lcl Translation", (0, 0, 0))
    r = _prop70(model, "Lcl Rotation", (0, 0, 0))
    s = _prop70(model, "Lcl Scaling", (1, 1, 1))
    gt = _prop70(model, "GeometricTranslation", (0, 0, 0))
    gr = _prop70(model, "GeometricRotation", (0, 0, 0))
    gs = _prop70(model, "GeometricScaling", (1, 1, 1))

    def trs(t, r, s):
        m = np.eye(4)
        m[:3, :3] = _euler_xyz_deg(*r) @ np.diag(s)
        m[:3, 3] = t
        return m

    return trs(t, r, s), trs(gt, gr, gs)


def _triangulate(poly_idx):
    """PolygonVertexIndex -> [T, 3] int triangles (fan) +
    per-triangle polygon-vertex index triples (for per-polyvertex normals)."""
    tris = []
    pv_tris = []
    poly = []
    pv_pos = []
    for k, raw in enumerate(poly_idx):
        idx = int(raw)
        last = idx < 0
        if last:
            idx = ~idx
        poly.append(idx)
        pv_pos.append(k)
        if last:
            for i in range(1, len(poly) - 1):
                tris.append((poly[0], poly[i], poly[i + 1]))
                pv_tris.append((pv_pos[0], pv_pos[i], pv_pos[i + 1]))
            poly = []
            pv_pos = []
    return (np.asarray(tris, np.int64).reshape(-1, 3),
            np.asarray(pv_tris, np.int64).reshape(-1, 3))


def _geometry_normals(geom, tris, pv_tris, n_vertices):
    """LayerElementNormal -> per-vertex normals [V, 3] or None."""
    layer = geom.find("LayerElementNormal")
    if layer is None:
        return None
    normals_node = layer.find("Normals")
    if normals_node is None or not len(normals_node.props):
        return None
    data = np.asarray(normals_node.props[0], np.float64).reshape(-1, 3)
    mapping = ""
    ref = "Direct"
    m = layer.find("MappingInformationType")
    if m is not None and m.props:
        mapping = str(m.props[0])
    r = layer.find("ReferenceInformationType")
    if r is not None and r.props:
        ref = str(r.props[0])
    if ref == "IndexToDirect":
        idx_node = layer.find("NormalsIndex") or layer.find("NormalIndex")
        if idx_node is not None and len(idx_node.props):
            data = data[np.asarray(idx_node.props[0], np.int64)]

    out = np.zeros((n_vertices, 3), np.float64)
    if mapping == "ByVertice" or mapping == "ByVertex":
        n = min(n_vertices, data.shape[0])
        out[:n] = data[:n]
    elif mapping == "ByPolygonVertex":
        # Average the per-corner normals onto vertices (the loader keeps one
        # normal per vertex like the reference's Assimp-imported mesh).
        np.add.at(out, tris.reshape(-1), data[pv_tris.reshape(-1)])
    else:
        return None
    norm = np.linalg.norm(out, axis=1, keepdims=True)
    return out / np.where(norm > 1e-20, norm, 1.0)


def smooth_normals(vertices, tris):
    """Area-weighted vertex normals (aiProcess_GenSmoothNormals stand-in)."""
    v = vertices
    e1 = v[tris[:, 1]] - v[tris[:, 0]]
    e2 = v[tris[:, 2]] - v[tris[:, 0]]
    face_n = np.cross(e1, e2)   # area-weighted
    out = np.zeros_like(vertices)
    for c in range(3):
        np.add.at(out, tris[:, c], face_n)
    norm = np.linalg.norm(out, axis=1, keepdims=True)
    return out / np.where(norm > 1e-20, norm, 1.0)


def load_fbx_geometry(path: str):
    """Load all FBX geometries pre-transformed into one buffer set.

    Returns (vertices [V, 3] f32, indices [T, 3] u32, normals [V, 3] f32).
    Geometry only — single primitive, global material, like the reference's
    Assimp path."""
    with open(path, "rb") as f:
        data = f.read()
    root, _version = _parse(data)

    objects = root.find("Objects")
    if objects is None:
        raise FbxError("FBX has no Objects section")

    geoms = {}
    models = {}
    for node in objects.children:
        if node.name == "Geometry" and len(node.props) >= 1:
            geoms[int(node.props[0])] = node
        elif node.name == "Model" and len(node.props) >= 1:
            models[int(node.props[0])] = node

    # Connections: child_id -> parent_id (OO links only).
    parent = {}
    conns = root.find("Connections")
    if conns is not None:
        for c in conns.find_all("C"):
            if len(c.props) >= 3 and c.props[0] == "OO":
                parent[int(c.props[1])] = int(c.props[2])

    def global_matrix(model_id):
        m = np.eye(4)
        node_id = model_id
        depth = 0
        while node_id in models and depth < 64:
            local, _geo = _model_matrix(models[node_id])
            m = local @ m
            node_id = parent.get(node_id, 0)
            depth += 1
        return m

    all_v = []
    all_n = []
    all_t = []
    base = 0
    for gid, geom in geoms.items():
        vn = geom.find("Vertices")
        pn = geom.find("PolygonVertexIndex")
        if vn is None or pn is None or not len(vn.props) or not len(pn.props):
            continue
        verts = np.asarray(vn.props[0], np.float64).reshape(-1, 3)
        tris, pv_tris = _triangulate(np.asarray(pn.props[0], np.int64))
        if tris.size == 0:
            continue
        normals = _geometry_normals(geom, tris, pv_tris, verts.shape[0])

        model_id = parent.get(gid)
        xform = np.eye(4)
        geo_pivot = np.eye(4)
        if model_id in models:
            xform = global_matrix(model_id)
            _, geo_pivot = _model_matrix(models[model_id])
        full = xform @ geo_pivot
        verts_h = np.concatenate(
            [verts, np.ones((verts.shape[0], 1))], axis=1)
        verts_w = (full @ verts_h.T).T[:, :3]
        if normals is not None:
            nrm_m = np.linalg.inv(full[:3, :3]).T
            normals = normals @ nrm_m.T
            ln = np.linalg.norm(normals, axis=1, keepdims=True)
            normals = normals / np.where(ln > 1e-20, ln, 1.0)
        else:
            normals = smooth_normals(verts_w, tris)
        # Mirror transforms flip winding; keep outward orientation like
        # Assimp's pretransform does.
        if np.linalg.det(full[:3, :3]) < 0:
            tris = tris[:, ::-1]

        all_v.append(verts_w.astype(np.float32))
        all_n.append(normals.astype(np.float32))
        all_t.append(tris + base)
        base += verts.shape[0]

    if not all_v:
        raise FbxError("FBX contains no polygon geometry")
    vertices = np.concatenate(all_v, axis=0)
    normals = np.concatenate(all_n, axis=0)
    indices = np.concatenate(all_t, axis=0).astype(np.uint32)
    return vertices, indices, normals
