"""Binary PLY, STL and FBX writers for triangle meshes (numpy only).

The port's loaders (neural_renderer_tpu_torch/scene/ply_stl_loader.py,
fbx_loader.py) read what these write; chip_smoke.py (phase 23) writes the
knot scene's meshes in the three formats with them, and
tests/test_torch_mesh_formats.py writes its fixtures with them. Positions
keep their float32 values exactly: PLY and STL store float32, FBX float64.

    write_ply(path, vertices, indices, normals=None)
    write_stl(path, vertices, indices)
    write_fbx(path, vertices, polygons, translation=..., rotation=...,
              scaling=..., compress=True)
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_ply(path: str, vertices, indices, normals=None) -> None:
    """Binary little-endian PLY: float x y z (and nx ny nz), triangles as
    `list uchar uint vertex_indices`."""
    v = np.asarray(vertices, np.float32).reshape(-1, 3)
    idx = np.asarray(indices, np.uint32).reshape(-1, 3)
    props = ["x", "y", "z"] + (["nx", "ny", "nz"] if normals is not None
                               else [])
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(v)}\n"
              + "".join(f"property float {p}\n" for p in props)
              + f"element face {len(idx)}\n"
              "property list uchar uint vertex_indices\nend_header\n")
    cols = [v] if normals is None else [
        v, np.asarray(normals, np.float32).reshape(-1, 3)]
    vrec = np.ascontiguousarray(np.concatenate(cols, axis=1), "<f4")
    frec = np.zeros(len(idx), np.dtype([("n", "u1"), ("i", "<u4", 3)]))
    frec["n"] = 3
    frec["i"] = idx
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(vrec.tobytes())
        f.write(frec.tobytes())


def write_stl(path: str, vertices, indices) -> None:
    """Binary STL: one 50-byte record per triangle (its unit normal, three
    corners, a zero attribute word)."""
    v = np.asarray(vertices, np.float32).reshape(-1, 3)
    corners = v[np.asarray(indices, np.int64).reshape(-1, 3)]  # [T, 3, 3]
    n = np.cross(corners[:, 1] - corners[:, 0], corners[:, 2] - corners[:, 0])
    length = np.linalg.norm(n, axis=1, keepdims=True)
    n = np.where(length > 0, n / np.maximum(length, 1e-30), 0.0)
    rec = np.zeros(len(corners), np.dtype([
        ("normal", "<f4", 3), ("verts", "<f4", (3, 3)), ("attr", "<u2")]))
    rec["normal"] = n
    rec["verts"] = corners
    with open(path, "wb") as f:
        f.write(struct.pack("<80sI", b"binary STL", len(corners)))
        f.write(rec.tobytes())


# -- binary FBX 7.4: 32-bit node records, typed properties ------------------

def _array(code: bytes, dtype: str, vals, compress: bool) -> bytes:
    raw = np.ascontiguousarray(vals, dtype).tobytes()
    count = len(raw) // np.dtype(dtype).itemsize
    if compress:
        packed = zlib.compress(raw)
        return code + struct.pack("<III", count, 1, len(packed)) + packed
    return code + struct.pack("<III", count, 0, len(raw)) + raw


def _string(s: str) -> bytes:
    raw = s.encode()
    return b"S" + struct.pack("<I", len(raw)) + raw


def _long(v: int) -> bytes:
    return b"L" + struct.pack("<q", v)


def _double(v: float) -> bytes:
    return b"D" + struct.pack("<d", v)


def _node(name: str, props=(), children=(), offset: int = 0) -> bytes:
    """One node record placed at file offset `offset`; `children` are
    callables offset -> bytes."""
    name_b = name.encode()
    props_b = b"".join(props)
    body = offset + 13 + len(name_b) + len(props_b)
    kids = b""
    for child in children:
        kids += child(body + len(kids))
    if children:
        kids += b"\x00" * 13          # the NULL record ending the children
    return (struct.pack("<III", body + len(kids), len(props), len(props_b))
            + bytes([len(name_b)]) + name_b + props_b + kids)


def write_fbx(path: str, vertices, polygons, translation=(0.0, 0.0, 0.0),
              rotation=(0.0, 0.0, 0.0), scaling=(1.0, 1.0, 1.0),
              compress: bool = True) -> None:
    """One Geometry (float64 Vertices, PolygonVertexIndex with each
    polygon's last index stored as ~index) under one Model with Lcl
    Translation / Rotation (XYZ Euler, degrees) / Scaling, connected
    geometry -> model -> root. `polygons`: a [T, 3] array or a list of
    index lists (n-gons)."""
    poly_idx = []
    for poly in np.asarray(polygons).tolist() if isinstance(
            polygons, np.ndarray) else polygons:
        poly_idx.extend(int(i) for i in poly[:-1])
        poly_idx.append(~int(poly[-1]))
    verts = np.asarray(vertices, np.float64).reshape(-1)

    def p70(name, vals):
        return lambda off: _node("P", [
            _string(name), _string(name), _string(""), _string("A"),
            *(_double(float(x)) for x in vals)], offset=off)

    geometry = lambda off: _node(  # noqa: E731
        "Geometry", [_long(100), _string("geo"), _string("Mesh")],
        [lambda o: _node("Vertices", [_array(b"d", "<f8", verts, compress)],
                         offset=o),
         lambda o: _node("PolygonVertexIndex",
                         [_array(b"i", "<i4", poly_idx, compress)],
                         offset=o)], offset=off)
    model = lambda off: _node(  # noqa: E731
        "Model", [_long(200), _string("model"), _string("Mesh")],
        [lambda o: _node("Properties70", [], [
            p70("Lcl Translation", translation),
            p70("Lcl Rotation", rotation),
            p70("Lcl Scaling", scaling)], offset=o)], offset=off)
    objects = lambda off: _node("Objects", [], [geometry, model],  # noqa
                                offset=off)
    connections = lambda off: _node("Connections", [], [  # noqa: E731
        lambda o: _node("C", [_string("OO"), _long(100), _long(200)],
                        offset=o),
        lambda o: _node("C", [_string("OO"), _long(200), _long(0)],
                        offset=o)], offset=off)
    blob = b"Kaydara FBX Binary  \x00\x1a\x00" + struct.pack("<I", 7400)
    for top in (objects, connections):
        blob += top(len(blob))
    blob += b"\x00" * 13
    with open(path, "wb") as f:
        f.write(blob)
