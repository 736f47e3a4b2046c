"""The port's glTF loader, texture atlas and textured shading against the
JAX package's, on the CPU.

Loader (`scene/mesh_loader.py::load_gltf_with_materials`): on the shipped
`configs/studio/torus.glb` (two primitives, 2,304 triangles, a `checker`
material with an embedded 256x256 base-colour PNG and a normal-map PNG, a
constant `red` material) the port's vertices, normals, uvs, indices,
material ranges, materials and textures equal the JAX loader's exactly
(the JAX loader decodes the PNGs with imageio, the port with
`metrics/image_io.decode_png`, which also matches imageio's dtype and
channels on every PNG bit depth and colour type). The JAX tests' data-URI
and sparse-accessor files load alike. The atlas and material tables
(`MaterialTable.build`, `HostMesh.to_tensors`) equal JAX's `to_arrays`.

Shading (`ops/intersect.py`): `sample_texture` (nearest and bilinear, uv
wrapped from outside [0, 1]), the normal-mapped `compute_hit_data` and the
textured `resolve_material`, run on seeded torus hits against JAX under
`jax.disable_jit()` (op by op, as the port rounds). Measured: the normals
within 6e-8 (one f32 ulp: torch's CPU sqrt is not correctly rounded,
XLA:CPU's is), every other output equal bit for bit; held to 1e-6 absolute
(values of magnitude <= 1), material ids and validity exactly. `pathtrace.select_closest_hits`
is held exactly, ties to the first set included, but for its distance
(1 ulp: torch's CPU sqrt is not correctly rounded).
"""

import base64
import dataclasses
import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import imageio.v3 as iio

from neural_renderer_tpu.ops import intersect as jint
from neural_renderer_tpu.render import pathtrace as jpt
from neural_renderer_tpu.scene import mesh_loader as jml

from test_gltf import _binary_payload, _build_gltf_dict, _write_glb

from neural_renderer_tpu_torch.metrics.image_io import decode_png
from neural_renderer_tpu_torch.ops import intersect as tint
from neural_renderer_tpu_torch.render import pathtrace as tpt
from neural_renderer_tpu_torch.scene import mesh_loader as tml

# One intra-op thread: the suite runs several pytest workers side by side,
# and PyTorch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORUS = os.path.join(ROOT, "configs", "studio", "torus.glb")
ATOL = 1e-6


def _same_mesh(got, want):
    for name in ("vertices", "normals", "texcoords", "indices",
                 "material_map", "material_ids"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.has_mesh_materials == want.has_mesh_materials
    assert len(got.materials) == len(want.materials)
    for mg, mw in zip(got.materials, want.materials):
        np.testing.assert_array_equal(mg.scalar_row(), mw.scalar_row())
        for a, b in zip(mg.tex_rows(), mw.tex_rows()):
            np.testing.assert_array_equal(a, b)
        assert mg.has_any_texture() == mw.has_any_texture()
    assert len(got.textures) == len(want.textures)
    for tg, tw in zip(got.textures, want.textures):
        assert tg.dtype == tw.dtype and tg.shape == tw.shape
        np.testing.assert_array_equal(tg, tw)


@pytest.fixture(scope="module")
def torus():
    """(JAX mesh, port mesh) of torus.glb, nearest filtering as the scene
    loads the original mesh."""
    jm = jml.load_mesh_labeled(TORUS, "original", nearest_tex=True)
    tm = tml.load_mesh_labeled(TORUS, "original", nearest_tex=True)
    return jm, tm


def test_torus_glb_equals_jax(torus):
    jm, tm = torus
    assert tm.num_triangles == 2304 and len(tm.materials) == 2
    assert [t.shape for t in tm.textures] == [(256, 256, 3)] * 2
    m0, m1 = tm.materials
    assert m0.base_color.textured and m0.normal.textured
    assert not m1.has_any_texture()
    _same_mesh(tm, jm)


def test_data_uri_and_glb_files_equal_jax(tmp_path):
    """The JAX tests' two-node GLB (translation, then a child scale) and
    its .gltf twin with the buffer in a data URI."""
    glb = str(tmp_path / "tri.glb")
    _write_glb(glb)
    payload = _binary_payload()
    uri = ("data:application/octet-stream;base64,"
           + base64.b64encode(payload).decode())
    gltf = tmp_path / "tri.gltf"
    gltf.write_text(json.dumps(_build_gltf_dict(len(payload), use_uri=uri)))
    for path in (glb, str(gltf)):
        got = tml.load_gltf_with_materials(path)
        _same_mesh(got, jml.load_gltf_with_materials(path))
        assert got.num_triangles == 2
        np.testing.assert_allclose(got.vertices[0], [1, 2, 3], atol=1e-6)
        np.testing.assert_allclose(got.vertices[4], [3, 2, 3], atol=1e-6)
        mat = got.materials[0]
        assert (mat.ior, mat.specular_transmission, mat.emission_scale) \
            == pytest.approx((1.33, 0.25, 4.0))


def _glb(path, gltf, payload):
    js = json.dumps(gltf).encode()
    js += b" " * (-len(js) % 4)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2,
                            28 + len(js) + len(payload)))
        f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
        f.write(struct.pack("<II", len(payload), 0x004E4942) + payload)


def test_sparse_accessors_equal_jax(tmp_path):
    """A sparse POSITION accessor over a base bufferView, and the
    zero-base form with no bufferView."""
    base = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [9, 9, 9]], np.float32)
    payload = (base.tobytes() + np.array([[5, 5, 5]], np.float32).tobytes()
               + np.array([3], np.uint16).tobytes()
               + np.array([0, 1, 2, 1, 3, 2], np.uint16).tobytes())
    payload += b"\x00" * (-len(payload) % 4)
    sparse = {"count": 1,
              "indices": {"bufferView": 2, "componentType": 5123},
              "values": {"bufferView": 1}}
    gltf = {
        "asset": {"version": "2.0"}, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0},
                                    "indices": 1}]}],
        "buffers": [{"byteLength": len(payload)}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 48},
            {"buffer": 0, "byteOffset": 48, "byteLength": 12},
            {"buffer": 0, "byteOffset": 60, "byteLength": 2},
            {"buffer": 0, "byteOffset": 62, "byteLength": 12}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4,
             "type": "VEC3", "sparse": sparse},
            {"bufferView": 3, "componentType": 5123, "count": 6,
             "type": "SCALAR"}]}
    for zero_base in (False, True):
        if zero_base:
            del gltf["accessors"][0]["bufferView"]
        path = str(tmp_path / f"sparse{int(zero_base)}.glb")
        _glb(path, gltf, payload)
        got = tml.load_gltf_with_materials(path)
        _same_mesh(got, jml.load_gltf_with_materials(path))
        rows = {tuple(v) for v in got.vertices.round(3)}
        assert (5.0, 5.0, 5.0) in rows and (9.0, 9.0, 9.0) not in rows


def _png_bytes(w, h, depth, ctype, rows, palette=None):
    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))
    out = b"\x89PNG\r\n\x1a\n" + chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
    if palette is not None:
        out += chunk(b"PLTE", palette)
    return out + chunk(b"IDAT", zlib.compress(b"".join(rows))) \
        + chunk(b"IEND", b"")


def test_decode_png_matches_imageio():
    """Every bit depth of every colour type, each row under another of the
    five filters: the dtype, shape and values imageio returns."""
    rng = np.random.default_rng(5)
    w, h = 7, 5
    for depth, ctype, c in [(1, 0, 1), (2, 0, 1), (4, 0, 1), (8, 0, 1),
                            (16, 0, 1), (1, 3, 1), (2, 3, 1), (4, 3, 1),
                            (8, 3, 1), (8, 2, 3), (16, 2, 3), (8, 4, 2),
                            (16, 4, 2), (8, 6, 4), (16, 6, 4)]:
        stride = (w * c * depth + 7) // 8
        rows = [bytes([y % 5]) + bytes(rng.integers(0, 256, stride,
                                                    dtype=np.uint8))
                for y in range(h)]
        palette = (bytes(rng.integers(0, 256, 3 << depth, dtype=np.uint8))
                   if ctype == 3 else None)
        data = _png_bytes(w, h, depth, ctype, rows, palette)
        want = np.asarray(iio.imread(data))
        got = decode_png(data, rgb=False)
        assert (got.dtype, got.shape) == (want.dtype, want.shape), \
            (depth, ctype)
        np.testing.assert_array_equal(got, want, err_msg=f"{depth} {ctype}")


def test_atlas_and_tables_equal_jax(torus):
    """The device tables of both packages: atlas [3, P], texture offsets
    and sizes, material scalars, texture slots and channels, the flags."""
    jm, tm = torus
    ja = jm.to_arrays()
    ta = tm.to_tensors("cpu")
    for name in ("atlas", "mat_scalars", "vertices", "normals", "uvs"):
        np.testing.assert_array_equal(getattr(ta, name).numpy(),
                                      np.asarray(getattr(ja, name)), name)
    for name in ("tex_offset", "tex_width", "tex_height", "mat_tex_ids",
                 "mat_tex_chans", "indices", "tri_material"):
        got = getattr(ta, name)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(ja, name)), name)
    for flag in ("has_textures", "has_normal_maps", "texture_nearest",
                 "has_materials", "has_uvs", "has_normals"):
        assert getattr(ta, flag) == getattr(ja, flag) is True, flag
    assert ta.atlas.shape == (3, 2 * 256 * 256)


def _hits(mesh_tensors, n, seed):
    """Seeded hits on the torus: triangle ids, barycentrics inside the
    triangle, rays, t."""
    r = np.random.default_rng(seed)
    tri = r.integers(0, mesh_tensors.num_triangles, n)
    u = r.uniform(0, 1, n).astype(np.float32)
    v = (r.uniform(0, 1, n) * (1 - u)).astype(np.float32)
    o = r.normal(size=(3, n)).astype(np.float32) * 3
    d = r.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    t = r.uniform(0.5, 5, n).astype(np.float32)
    return tri, u, v, o, d, t


@pytest.mark.parametrize("nearest", [True, False])
def test_shading_equals_jax(torus, nearest):
    """sample_texture on uvs from -2 to 3 (the fract wrap) and on the hits'
    own uvs, the normal-mapped hit data and the textured materials, with
    material ids -1 (the global row), 0 (textured) and 1 (constant)."""
    jm, tm = torus
    ja = dataclasses.replace(jm.to_arrays(), texture_nearest=nearest)
    ta = dataclasses.replace(tm.to_tensors("cpu"), texture_nearest=nearest)
    n = 3000
    tri, u, v, o, d, t = _hits(ta, n, 3 + nearest)
    r = np.random.default_rng(9)
    uu, vv = (r.uniform(-2, 3, (2, n)).astype(np.float32))
    tex = r.integers(-1, 2, n)
    glob = r.uniform(0, 1, 18).astype(np.float32)
    T = torch.as_tensor
    with jax.disable_jit():
        jrgb, jvalid = jint.sample_texture(ja, jnp.asarray(tex, jnp.int32),
                                           jnp.asarray(uu), jnp.asarray(vv))
        jhd = jint.compute_hit_data(
            ja, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tri, jnp.int32),
            jnp.asarray(u), jnp.asarray(v), jnp.asarray(t))
        mid = np.where(r.uniform(size=n) < 0.2, -1, np.asarray(
            jhd.material_id))
        jrm = jint.resolve_material(ja, jnp.asarray(mid, jnp.int32),
                                    jhd.uv, jnp.asarray(glob))
    rgb, valid = tint.sample_texture(ta, T(tex), T(uu), T(vv))
    hd = tint.compute_hit_data(ta, T(o), T(d), T(tri), T(u), T(v), T(t))
    rm = tint.resolve_material(ta, T(mid), hd.uv, T(glob))

    def same(a, b, what):
        b = np.asarray(b)
        err = np.abs(a.numpy().astype(np.float64) - b).max()
        print(f"{what}: max |port - JAX| {err!r}")
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=ATOL,
                                   err_msg=what)

    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    same(rgb, jrgb, "sample_texture")
    for name in ("position", "shading_normal", "geometric_normal", "uv",
                 "t"):
        same(getattr(hd, name), getattr(jhd, name), name)
    np.testing.assert_array_equal(hd.material_id.numpy(),
                                  np.asarray(jhd.material_id))
    # The normal map moved the shading normal of the textured material's
    # hits off the interpolated one.
    assert (np.asarray(jhd.material_id) == 0).any()
    for name in jint.ResolvedMaterial._fields:
        same(getattr(rm, name), getattr(jrm, name), name)


def test_select_closest_hits_exact():
    """Both hit, one hits, none; equal distances keep the first set."""
    r = np.random.default_rng(4)
    n = 4000
    o = r.normal(size=(3, n)).astype(np.float32)

    def hits(seed):
        g = np.random.default_rng(seed)
        return dict(position=g.normal(size=(3, n)).astype(np.float32),
                    normal=g.normal(size=(3, n)).astype(np.float32),
                    albedo=g.uniform(size=(3, n)).astype(np.float32),
                    material_params=g.uniform(size=(3, n)).astype(
                        np.float32),
                    hit=g.uniform(size=n) < 0.6,
                    distance=g.uniform(size=n).astype(np.float32))
    a, b = hits(1), hits(2)
    tie = r.uniform(size=n) < 0.2
    b["position"][:, tie] = a["position"][:, tie]
    want = jpt.select_closest_hits(
        None, jpt.HitState(**{k: jnp.asarray(x) for k, x in a.items()}),
        jpt.HitState(**{k: jnp.asarray(x) for k, x in b.items()}),
        jnp.asarray(o))
    got = tpt.select_closest_hits(
        None, tpt.HitState(**{k: torch.as_tensor(x) for k, x in a.items()}),
        tpt.HitState(**{k: torch.as_tensor(x) for k, x in b.items()}),
        torch.as_tensor(o))
    for name in tpt.HitState._fields:
        if name != "distance":
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)),
                                          name)
    # The merged distance is sqrt(|p - o|^2): XLA:CPU's sqrt is correctly
    # rounded, torch's CPU sqrt is not on every value (1 ulp off on ~0.2%
    # of these rays; the card's sqrtf is IEEE): held to 1 ulp.
    np.testing.assert_array_max_ulp(got.distance.numpy(),
                                    np.asarray(want.distance), maxulp=1)
    both_tie = tie & a["hit"] & b["hit"]
    assert both_tie.any()
    np.testing.assert_array_equal(got.albedo.numpy()[:, both_tie],
                                  a["albedo"][:, both_tie])


def test_unported_image_and_formats_raise(tmp_path):
    """An image that does not decode (a JPEG cut short, a PNG cut short)
    becomes one black texel with a warning, as in the reference; FBX / PLY /
    STL files load, so a missing one raises OSError as in the JAX loader,
    and an unknown extension raises MeshLoadError."""
    payload = _binary_payload()
    gltf = _build_gltf_dict(len(payload))
    jpeg = b"\xff\xd8\xff\xe0" + bytes(16)
    gltf["images"] = [{"bufferView": 4, "mimeType": "image/jpeg"}]
    gltf["bufferViews"].append({"buffer": 0, "byteOffset": len(payload),
                                "byteLength": len(jpeg)})
    gltf["buffers"][0]["byteLength"] = len(payload) + len(jpeg)
    path = str(tmp_path / "jpeg.glb")
    _glb(path, gltf, payload + jpeg)
    mesh = tml.load_gltf_with_materials(path)
    assert len(mesh.textures) == 1 and mesh.textures[0].shape == (1, 1, 3)
    bad_png = b"\x89PNG\r\n\x1a\n" + bytes(16)
    gltf["bufferViews"][4]["byteLength"] = len(bad_png)
    _glb(path, gltf, payload + bad_png)
    mesh = tml.load_gltf_with_materials(path)
    assert len(mesh.textures) == 1 and mesh.textures[0].shape == (1, 1, 3)
    for ext in (".fbx", ".ply", ".stl"):
        with pytest.raises(OSError):
            tml.load_mesh_auto(str(tmp_path / f"m{ext}"))
        with pytest.raises(OSError):
            jml.load_mesh_auto(str(tmp_path / f"m{ext}"))
    with pytest.raises(tml.MeshLoadError, match="Unsupported mesh format"):
        tml.load_mesh_auto(str(tmp_path / "m.3ds"))
