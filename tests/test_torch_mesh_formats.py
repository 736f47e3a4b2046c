"""The port's PLY, STL and FBX loaders and `normalize` against the JAX
package's, on the CPU.

`scene/ply_stl_loader.py` and `scene/fbx_loader.py` are copies of the JAX
modules (numpy only); `scene/mesh_loader.py::load_ply_stl`, `load_fbx`,
`load_mesh_from_file` and the `normalize` argument are ports. On the JAX
tests' cases (tests/test_ply_stl.py, tests/test_fbx.py: ASCII and binary
PLY with quads, extra properties and normals, ASCII and binary STL, the FBX
cube and its pretransform), written here, and on files written by
scripts/mesh_writers.py, `load_mesh_auto` gives the JAX loader's vertices,
indices, normals and material ranges exactly, with and without
`normalize`; malformed files raise MeshLoadError in both. The knot-tube
OBJ / PLY / STL set equality of tests/test_cross_format.py holds in the
port. The knot scene's meshes written as PLY / STL / FBX (chip_smoke.py
phase 23) load to the OBJ loader's arrays (PLY) and triangles (STL, FBX),
and a ground-truth frame of a PLY-loaded mesh equals the OBJ-loaded one
bit for bit.
"""

import os
import sys

import numpy as np
import pytest
import torch

from neural_renderer_tpu.scene import mesh_loader as jml

from test_fbx import _cube, _write_fbx
from test_ply_stl import TET_F, TET_V

from neural_renderer_tpu_torch.scene import mesh_loader as tml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from make_knot_scene import knot_centerline, tube_mesh  # noqa: E402
from mesh_writers import write_fbx, write_ply, write_stl  # noqa: E402

# One intra-op thread: the suite runs several pytest workers side by side,
# and PyTorch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)


def _ascii_ply(path, vertices, faces, extra=""):
    lines = ["ply", "format ascii 1.0", f"element vertex {len(vertices)}",
             "property float x", "property float y", "property float z"]
    if extra:
        lines.append("property uchar red")
    lines += [f"element face {len(faces)}",
              "property list uchar int vertex_indices", "end_header"]
    lines += [" ".join(f"{c:.1f}" for c in v) + (" 255" if extra else "")
              for v in vertices]
    lines += [f"{len(f)} " + " ".join(map(str, f)) for f in faces]
    open(path, "w").write("\n".join(lines) + "\n")


def _ascii_stl(path, vertices, faces):
    out = ["solid tet"]
    for f in faces:
        out += [" facet normal 0 0 1", "  outer loop"]
        out += [f"   vertex {v[0]} {v[1]} {v[2]}" for v in vertices[f]]
        out += ["  endloop", " endfacet"]
    open(path, "w").write("\n".join(out + ["endsolid tet"]) + "\n")


def _tet_normals():
    n = TET_V / np.maximum(np.linalg.norm(TET_V, axis=1, keepdims=True), 1)
    n[0] = [0, 1, 0]
    return n


QUAD_V = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
CUBE_V, CUBE_QUADS = _cube()


def _write_case(tmp_path, case):
    """Write one fixture; returns its path."""
    if case == "ascii_ply":
        p = tmp_path / "tet.ply"
        _ascii_ply(p, TET_V, TET_F)
    elif case == "ascii_ply_quad_extra":
        p = tmp_path / "quad.ply"
        _ascii_ply(p, QUAD_V, [[0, 1, 2, 3]], extra="red")
    elif case == "binary_ply_normals":
        p = tmp_path / "tet_bin.ply"
        write_ply(p, TET_V, TET_F, _tet_normals())
    elif case == "binary_stl":
        p = tmp_path / "tet.stl"
        write_stl(p, TET_V, TET_F)
    elif case == "ascii_stl":
        p = tmp_path / "tet_ascii.stl"
        _ascii_stl(p, TET_V, TET_F)
    elif case == "fbx_cube":
        p = tmp_path / "cube.fbx"
        _write_fbx(str(p), CUBE_V, CUBE_QUADS)
    elif case == "fbx_pretransform":
        p = tmp_path / "moved.fbx"
        _write_fbx(str(p), CUBE_V, CUBE_QUADS, translation=(10, -2, 3),
                   rotation=(0, 90, 0), scaling=(2, 2, 2))
    elif case == "fbx_zlib_mirrored":
        # Compressed arrays, a mirroring scale (winding flips back).
        p = tmp_path / "mirror.fbx"
        write_fbx(str(p), CUBE_V, CUBE_QUADS, rotation=(30, 0, 45),
                  scaling=(-1, 2, 1))
    return str(p)


CASES = ["ascii_ply", "ascii_ply_quad_extra", "binary_ply_normals",
         "binary_stl", "ascii_stl", "fbx_cube", "fbx_pretransform",
         "fbx_zlib_mirrored"]


def _same(got, want):
    for name in ("vertices", "indices", "normals", "material_map",
                 "material_ids"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.has_mesh_materials == want.has_mesh_materials is False


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_load_mesh_auto_equals_jax(tmp_path, case, normalize):
    path = _write_case(tmp_path, case)
    got = tml.load_mesh_auto(path, normalize=normalize, scale=0.5)
    want = jml.load_mesh_auto(path, normalize=normalize, scale=0.5)
    _same(got, want)
    assert got.num_triangles == {"ascii_ply_quad_extra": 2}.get(
        case, 12 if case.startswith("fbx") else 4)
    labeled = tml.load_mesh_labeled(path, "original", normalize=normalize,
                                    nearest_tex=True, scale=0.5)
    _same(labeled, want)
    assert labeled.texture_nearest


@pytest.mark.parametrize("path", [
    os.path.join(ROOT, "configs", "studio", "extra.obj"),
    os.path.join(ROOT, "configs", "studio", "torus.glb")],
    ids=["obj", "glb"])
def test_normalize_equals_jax(path):
    got = tml.load_mesh_auto(path, normalize=True, scale=2.0)
    want = jml.load_mesh_auto(path, normalize=True, scale=2.0)
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.indices, want.indices)
    extent = got.vertices.max(axis=0) - got.vertices.min(axis=0)
    assert extent.max() == pytest.approx(20.0, rel=1e-6)
    flat = tml.HostMesh(vertices=np.ones((3, 3), np.float32))
    flat.normalize()                       # zero extent: left as it is
    np.testing.assert_array_equal(flat.vertices, np.ones((3, 3)))


def test_malformed_files_raise(tmp_path):
    p = tmp_path / "bad.ply"
    p.write_text("ply\nformat ascii 1.0\nelement vertex 1\n"
                 "property float x\nproperty float y\nproperty float z\n"
                 "element face 1\nproperty list uchar int vertex_indices\n"
                 "end_header\n0 0 0\n3 0 1 2\n")  # index out of range
    q = tmp_path / "fmt.ply"
    q.write_text("ply\nformat binary_middle_endian 1.0\nend_header\n")
    r = tmp_path / "tiny.stl"
    r.write_bytes(b"solid x\n")
    s = tmp_path / "ascii.fbx"
    s.write_text("; FBX 7.4.0 project file\nFBXHeaderExtension: {}\n")
    t = tmp_path / "empty.fbx"
    write_fbx(str(t), CUBE_V, [])
    for path, what in ((p, None), (q, "unsupported PLY format"),
                       (r, "not an STL file"), (s, "ASCII FBX"),
                       (t, "no polygon geometry")):
        with pytest.raises(tml.MeshLoadError, match=what):
            tml.load_mesh_auto(str(path))
        with pytest.raises(jml.MeshLoadError, match=what):
            jml.load_mesh_auto(str(path))
        assert tml.load_mesh_labeled(str(path), "original") is None


def _canonical_tris(mesh):
    """The triangles as a sorted list of coordinate tuples, each rotated to
    start at its smallest corner (winding kept)."""
    out = []
    for tri in mesh.vertices[mesh.indices.astype(int)]:
        k = min(range(3), key=lambda i: tuple(tri[i]))
        out.append(tuple(map(tuple, np.roll(tri, -k, axis=0))))
    return sorted(out)


def test_knot_tube_obj_ply_stl_identical(tmp_path):
    """tests/test_cross_format.py's check through the port's loaders."""
    v, n, idx = tube_mesh(knot_centerline(64), 0.3, 8)
    v, n, idx = (v.astype(np.float32), n.astype(np.float32),
                 idx.astype(np.uint32))
    obj = tmp_path / "k.obj"
    with open(obj, "w") as f:
        for p in v:
            f.write(f"v {p[0]:.9g} {p[1]:.9g} {p[2]:.9g}\n")
        for p in n:
            f.write(f"vn {p[0]:.9g} {p[1]:.9g} {p[2]:.9g}\n")
        for a, b, c in idx.astype(int) + 1:
            f.write(f"f {a}//{a} {b}//{b} {c}//{c}\n")
    write_ply(tmp_path / "k.ply", v, idx, n)
    write_stl(tmp_path / "k.stl", v, idx)
    m_obj = tml.load_mesh_auto(str(obj))
    m_ply = tml.load_mesh_auto(str(tmp_path / "k.ply"))
    m_stl = tml.load_mesh_auto(str(tmp_path / "k.stl"))
    assert m_obj.num_triangles == m_ply.num_triangles == \
        m_stl.num_triangles == len(idx)
    assert m_stl.vertices.shape[0] == len(v)     # the weld finds them all
    s_obj = _canonical_tris(m_obj)
    assert s_obj == _canonical_tris(m_ply) == _canonical_tris(m_stl)
    np.testing.assert_array_equal(m_ply.normals, n)
    _same(m_stl, jml.load_mesh_auto(str(tmp_path / "k.stl")))


def test_knot_scene_formats_keep_the_obj_triangles(tmp_path):
    """chip_smoke.py phase 23's files: the knot's original mesh as binary
    PLY with the OBJ loader's own arrays, the outer shell as binary STL,
    the inner shell as binary FBX. PLY gives the OBJ arrays exactly; STL
    and FBX the same triangles in the same order with equal positions
    (FBX's float64 pretransform turns the inner shell's two -0.0
    coordinates into +0.0)."""
    base = os.path.join(ROOT, "configs", "knot")
    objs = {k: tml.load_mesh_auto(os.path.join(base, f"{k}.obj"))
            for k in ("original", "outer", "inner")}
    o = objs["original"]
    write_ply(tmp_path / "original.ply", o.vertices, o.indices, o.normals)
    write_stl(tmp_path / "outer.stl", objs["outer"].vertices,
              objs["outer"].indices)
    write_fbx(str(tmp_path / "inner.fbx"), objs["inner"].vertices,
              objs["inner"].indices)
    ply = tml.load_mesh_auto(str(tmp_path / "original.ply"))
    for name in ("vertices", "indices", "normals"):
        a, b = getattr(ply, name), getattr(o, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    assert ply.num_triangles == 65536
    for key, ext in (("outer", "stl"), ("inner", "fbx")):
        got = tml.load_mesh_auto(str(tmp_path / f"{key}.{ext}"))
        a = got.vertices[got.indices.astype(np.int64)]
        b = objs[key].vertices[objs[key].indices.astype(np.int64)]
        assert a.shape == b.shape == (9216, 3, 3)
        np.testing.assert_array_equal(a, b)
        differ = a.view(np.uint32) != b.view(np.uint32)
        assert differ.sum() == (0 if ext == "stl" else 12)  # 2 vertices x 6
        assert (b[differ] == 0).all() and np.signbit(b[differ]).all()


def test_gt_frame_of_ply_equals_obj(tmp_path):
    """render_gt_frame at 32x24, 2 bounces, on configs/sphere/original.obj
    (9,216 triangles) loaded from the OBJ and from a PLY of its arrays:
    torch.equal."""
    from neural_renderer_tpu_torch.render.params import RenderParams
    from neural_renderer_tpu_torch.render.pathtrace import render_gt_frame
    from neural_renderer_tpu_torch.scene.envmap import EnvironmentTensors
    from neural_renderer_tpu_torch.scene.materials import Material

    obj = tml.load_mesh_auto(os.path.join(ROOT, "configs", "sphere",
                                          "original.obj"))
    write_ply(tmp_path / "s.ply", obj.vertices, obj.indices, obj.normals)
    ply = tml.load_mesh_auto(str(tmp_path / "s.ply"))
    w, h = 32, 24
    p = RenderParams.make(
        width=w, height=h, samples_per_pixel=1, max_bounces=2,
        material=Material.default(), scene_scale=2.0, device="cpu",
        cam_pos=[0.3, 0.2, 3.0], cam_forward=[0.0, 0.0, -1.0],
        cam_right=[1.0, 0.0, 0.0], cam_up=[0.0, 1.0, 0.0], fov_y=0.8)
    env = EnvironmentTensors.from_numpy(None, device="cpu")
    frames = [render_gt_frame(m.to_tensors("cpu"), env, p,
                              torch.zeros((3, w * h)))
              for m in (obj, ply)]
    assert torch.equal(frames[0][0], frames[1][0])
    assert torch.equal(frames[0][1], frames[1][1])
    assert frames[0][0].float().std() > 1.0
