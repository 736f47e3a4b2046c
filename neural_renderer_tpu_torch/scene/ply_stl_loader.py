"""PLY and STL geometry parsers.

Port (a copy: the module imports nothing of JAX) of
`neural_renderer_tpu/scene/ply_stl_loader.py`. The reference renderer reads
every non-glTF format through Assimp with triangulate + pretransform +
smooth normals and one global material; these parsers give the same
geometry-only result:

  * PLY: ascii, binary_little_endian and binary_big_endian; vertex
    x/y/z (+ optional nx/ny/nz), arbitrary extra properties skipped;
    polygon faces triangulated as fans.
  * STL: binary (count-prefixed 50-byte records) and ascii ("solid");
    exact-duplicate vertices are welded so the smooth-normal generation
    (mesh_loader._smooth_normals, Assimp GenNormals equivalent) produces
    shared-vertex normals rather than per-facet copies.
"""

from __future__ import annotations

import struct

import numpy as np


class GeometryParseError(ValueError):
    pass


# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def _ply_header(data: bytes):
    """Parse the header; returns (fmt, elements, body_offset).

    elements: list of (name, count, properties) where properties is a list of
    ("scalar", name, dtype) or ("list", name, count_dtype, item_dtype)."""
    end = data.find(b"end_header")
    if not data.startswith(b"ply") or end < 0:
        raise GeometryParseError("not a PLY file")
    end = data.index(b"\n", end) + 1
    header = data[:end].decode("ascii", errors="replace")

    fmt = None
    elements = []
    for line in header.splitlines():
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if not elements:
                raise GeometryParseError("PLY property before element")
            props = elements[-1][2]
            if parts[1] == "list":
                props.append(("list", parts[4],
                              _PLY_TYPES[parts[2]], _PLY_TYPES[parts[3]]))
            else:
                props.append(("scalar", parts[2], _PLY_TYPES[parts[1]]))
    if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
        raise GeometryParseError(f"unsupported PLY format '{fmt}'")
    return fmt, elements, end


def _ply_ascii_body(data: bytes, elements):
    tokens = data.split()
    pos = 0
    out = {}
    for name, count, props in elements:
        rows = []
        for _ in range(count):
            row = {}
            for kind, pname, *dts in props:
                if kind == "list":
                    n = int(tokens[pos]); pos += 1
                    row[pname] = [float(tokens[pos + i]) for i in range(n)]
                    pos += n
                else:
                    row[pname] = float(tokens[pos]); pos += 1
            rows.append(row)
        out[name] = rows
    return out


def _ply_binary_body(data: bytes, elements, big_endian: bool):
    bo = ">" if big_endian else "<"
    pos = 0
    out = {}
    for name, count, props in elements:
        all_scalar = all(k == "scalar" for k, *_ in props)
        if all_scalar:
            dt = np.dtype([(p[1], bo + p[2]) for p in props])
            arr = np.frombuffer(data, dt, count=count, offset=pos)
            pos += dt.itemsize * count
            out[name] = arr
            continue
        rows = []
        for _ in range(count):
            row = {}
            for kind, pname, *dts in props:
                if kind == "list":
                    cdt = np.dtype(bo + dts[0])
                    n = int(np.frombuffer(data, cdt, 1, pos)[0])
                    pos += cdt.itemsize
                    idt = np.dtype(bo + dts[1])
                    row[pname] = np.frombuffer(data, idt, n, pos)
                    pos += idt.itemsize * n
                else:
                    sdt = np.dtype(bo + dts[0])
                    row[pname] = float(np.frombuffer(data, sdt, 1, pos)[0])
                    pos += sdt.itemsize
            rows.append(row)
        out[name] = rows
    return out


def _fan_triangulate(faces) -> np.ndarray:
    tris = []
    for f in faces:
        f = list(f)
        for i in range(1, len(f) - 1):
            tris.append((f[0], f[i], f[i + 1]))
    if not tris:
        raise GeometryParseError("PLY has no faces")
    return np.asarray(tris, np.uint32)


def load_ply_geometry(path: str):
    """-> (vertices [N,3] f32, indices [M,3] u32, normals [N,3] f32 or None)."""
    with open(path, "rb") as f:
        data = f.read()
    fmt, elements, off = _ply_header(data)
    body = data[off:]
    if fmt == "ascii":
        parsed = _ply_ascii_body(body, elements)
    else:
        parsed = _ply_binary_body(body, elements,
                                  big_endian=fmt == "binary_big_endian")

    if "vertex" not in parsed or "face" not in parsed:
        raise GeometryParseError("PLY missing vertex or face element")
    vert = parsed["vertex"]
    if isinstance(vert, np.ndarray):   # structured (binary all-scalar)
        names = vert.dtype.names
        vertices = np.stack([vert["x"], vert["y"], vert["z"]],
                            axis=1).astype(np.float32)
        normals = None
        if all(n in names for n in ("nx", "ny", "nz")):
            normals = np.stack([vert["nx"], vert["ny"], vert["nz"]],
                               axis=1).astype(np.float32)
    else:
        vertices = np.asarray([[r["x"], r["y"], r["z"]] for r in vert],
                              np.float32)
        normals = None
        if vert and all(k in vert[0] for k in ("nx", "ny", "nz")):
            normals = np.asarray([[r["nx"], r["ny"], r["nz"]] for r in vert],
                                 np.float32)

    face_rows = parsed["face"]
    key = None
    probe = face_rows[0] if len(face_rows) else {}
    for cand in ("vertex_indices", "vertex_index"):
        if cand in probe:
            key = cand
            break
    if key is None:
        raise GeometryParseError("PLY face element lacks vertex_indices")
    indices = _fan_triangulate([r[key] for r in face_rows])
    if indices.max(initial=0) >= len(vertices):
        raise GeometryParseError("PLY face index out of range")
    return vertices, indices, normals


# ---------------------------------------------------------------------------
# STL
# ---------------------------------------------------------------------------

def _weld(tri_verts: np.ndarray):
    """Weld exact-duplicate vertices: [M,3,3] facet soup -> indexed mesh."""
    flat = tri_verts.reshape(-1, 3)
    uniq, inv = np.unique(flat, axis=0, return_inverse=True)
    return uniq.astype(np.float32), inv.reshape(-1, 3).astype(np.uint32)


def load_stl_geometry(path: str):
    """-> (vertices [N,3] f32, indices [M,3] u32, normals=None).

    Facet normals in the file are ignored — like the Assimp+GenNormals path,
    normals are regenerated from geometry by the caller."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 15:
        raise GeometryParseError("not an STL file")

    # Binary detection: the 84-byte header's triangle count must match the
    # file size ("solid" prefix alone is unreliable — binary exporters use it).
    is_binary = False
    if len(data) >= 84:
        (n_tri,) = struct.unpack_from("<I", data, 80)
        if 84 + 50 * n_tri == len(data):
            is_binary = True

    if is_binary:
        rec = np.dtype([("normal", "<f4", 3), ("verts", "<f4", (3, 3)),
                        ("attr", "<u2")])
        tris = np.frombuffer(data, rec, count=n_tri, offset=84)
        tri_verts = np.ascontiguousarray(tris["verts"])
    else:
        text = data.decode("ascii", errors="replace")
        coords = []
        for line in text.splitlines():
            parts = line.split()
            if parts and parts[0] == "vertex":
                if len(parts) != 4:
                    raise GeometryParseError("malformed STL vertex line")
                coords.append([float(parts[1]), float(parts[2]),
                               float(parts[3])])
        if not coords or len(coords) % 3 != 0:
            raise GeometryParseError("ascii STL vertex count not a "
                                     "multiple of 3")
        tri_verts = np.asarray(coords, np.float32).reshape(-1, 3, 3)

    if tri_verts.size == 0:
        raise GeometryParseError("STL has no facets")
    vertices, indices = _weld(tri_verts)
    return vertices, indices, None
