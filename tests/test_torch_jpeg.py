"""The port's JPEG decoder against Pillow (through imageio), on the CPU.

`metrics/jpeg.py::decode_jpeg` must give what imageio gives the JAX
package (Pillow over libjpeg-turbo) byte for byte: uint8 [H, W] for grey,
[H, W, 3] for colour. Every case runs twice, through the native entropy
decoder (`csrc/jpeg_decode.cpp`, built with the host compiler) and through
the Python one. Images come from numpy seeds (smooth and noisy, odd sizes),
encoded here by Pillow at qualities 50, 90 and 100 with 4:4:4, 4:2:2 and
4:2:0 sampling, grey, progressive, with restart intervals, optimised
Huffman tables, Adobe RGB (no colour transform), an EXIF segment, and
4:4:0 (a 4:2:2 file whose frame header is rewritten to transpose the
luma sampling: the same entropy data, a valid 4:4:0 file). The committed
fixtures (scripts/make_jpeg_fixture.py) equal their committed Pillow
decodes. Arithmetic-coded, lossless, 12-bit, CMYK and incompletely refined
progressive files raise JpegError naming the variant.

Callers: a JPEG sky equals the JAX `EnvironmentMap`'s pixels exactly;
glTF files with a JPEG texture, in a data URI and in a bufferView, give the
JAX loader's textures and atlas exactly; `load_image` equals JAX's.
"""

import base64
import io
import json
import os
import struct

import numpy as np
import pytest
import torch

import imageio.v3 as iio
from PIL import Image

from neural_renderer_tpu.metrics import image_io as jimage_io
from neural_renderer_tpu.scene import envmap as jenv
from neural_renderer_tpu.scene import mesh_loader as jml

from test_gltf import _binary_payload, _build_gltf_dict

from neural_renderer_tpu_torch.metrics import image_io as timage_io
from neural_renderer_tpu_torch.metrics import jpeg
from neural_renderer_tpu_torch.scene import envmap as tenv
from neural_renderer_tpu_torch.scene import mesh_loader as tml

# One intra-op thread: the suite runs several pytest workers side by side,
# and PyTorch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
FIXTURES = ["studio_sky_baseline", "studio_sky_progressive", "grey_restart"]


def _image(h, w, kind, seed=0):
    if kind == "noisy":
        return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                    dtype=np.uint8)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    rgb = [128 + 120 * np.sin(x / 7.0 + c) * np.cos(y / 5.0 - c)
           for c in range(3)]
    return np.clip(np.stack(rgb, axis=-1), 0, 255).astype(np.uint8)


def _encode(pixels, **options):
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, "JPEG", **options)
    return buf.getvalue()


def _both_paths_equal_pillow(data):
    """Both entropy paths give imageio's array: dtype, shape and bytes."""
    want = np.asarray(iio.imread(data))
    for native in (True, False):
        got = jpeg.decode_jpeg(data, native=native)
        assert got.dtype == want.dtype == np.uint8
        assert got.shape == want.shape, native
        np.testing.assert_array_equal(got, want, err_msg=f"native={native}")
    return want


@pytest.mark.parametrize("subsampling", [0, 1, 2],
                         ids=["444", "422", "420"])
@pytest.mark.parametrize("quality", [50, 90, 100])
@pytest.mark.parametrize("kind", ["smooth", "noisy"])
@pytest.mark.parametrize("size", [(23, 37), (48, 64)],
                         ids=["37x23", "64x48"])
def test_baseline_equals_pillow(size, kind, quality, subsampling):
    data = _encode(_image(*size, kind), quality=quality,
                   subsampling=subsampling)
    assert _both_paths_equal_pillow(data).shape == (*size, 3)


@pytest.mark.parametrize("quality", [50, 90, 100])
@pytest.mark.parametrize("size", [(23, 37), (9, 17), (1, 1)],
                         ids=["37x23", "17x9", "1x1"])
def test_grey_equals_pillow(size, quality):
    grey = _image(*size, "noisy", seed=quality)[..., 0]
    assert _both_paths_equal_pillow(_encode(grey, quality=quality)).shape \
        == size


@pytest.mark.parametrize("case", [
    dict(quality=85, progressive=True),
    dict(quality=95, progressive=True, subsampling=0),
    dict(quality=75, progressive=True, subsampling=1),
    dict(quality=80, restart_marker_blocks=2),
    dict(quality=60, restart_marker_rows=1, subsampling=1),
    dict(quality=80, optimize=True),
    dict(quality=80, keep_rgb=True, subsampling=0),
    dict(quality=70, exif=b"Exif\0\0MM\0*\0\0\0\x08\0\0\0\0\0\0"),
], ids=["progressive420", "progressive444", "progressive422",
        "restart_blocks", "restart_rows", "optimized", "adobe_rgb", "exif"])
@pytest.mark.parametrize("kind", ["smooth", "noisy"])
def test_variants_equal_pillow(case, kind):
    rgb = _image(35, 50, kind, seed=5)
    _both_paths_equal_pillow(_encode(rgb, **case))
    _both_paths_equal_pillow(_encode(rgb[..., 1], **case))


@pytest.mark.parametrize("size", [(8, 16), (24, 48), (40, 32)])
def test_440_equals_pillow(size):
    h, w = size
    data = bytearray(_encode(_image(h, w, "noisy", seed=h), quality=90,
                             subsampling=1))
    sof = data.index(b"\xff\xc0")
    assert data[sof + 11] == 0x21                    # luma 2x1
    struct.pack_into(">HH", data, sof + 5, 2 * h, w // 2)
    data[sof + 11] = 0x12                            # luma 1x2: 4:4:0
    assert _both_paths_equal_pillow(bytes(data)).shape == (2 * h, w // 2, 3)


@pytest.mark.parametrize("name", FIXTURES)
def test_committed_fixtures_equal_their_pillow_decodes(name):
    data = open(os.path.join(GOLDEN, f"{name}.jpg"), "rb").read()
    want = np.load(os.path.join(GOLDEN, f"{name}_decode.npy"))
    np.testing.assert_array_equal(np.asarray(iio.imread(data)), want)
    for native in (True, False):
        got = jpeg.decode_jpeg(data, native=native)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _sof(marker, precision=8, ncomp=1):
    comps = b"".join(bytes([i + 1, 0x11, 0]) for i in range(ncomp))
    body = struct.pack(">BHHB", precision, 8, 8, ncomp) + comps
    return (b"\xff\xd8" + bytes([0xFF, marker])
            + struct.pack(">H", len(body) + 2) + body + b"\xff\xd9")


def test_unsupported_variants_raise():
    for data, what in ((_sof(0xC9), "arithmetic-coded"),
                       (_sof(0xCA), "arithmetic-coded"),
                       (_sof(0xC3), "lossless"),
                       (_sof(0xC1, precision=12), "12-bit"),
                       (_sof(0xC0, ncomp=4), "CMYK")):
        with pytest.raises(jpeg.JpegError, match=what):
            jpeg.decode_jpeg(data)
    buf = io.BytesIO()
    Image.fromarray(_image(16, 16, "smooth")).convert("CMYK").save(buf,
                                                                  "JPEG")
    assert np.asarray(iio.imread(buf.getvalue())).shape == (16, 16, 4)
    with pytest.raises(jpeg.JpegError, match="CMYK"):
        jpeg.decode_jpeg(buf.getvalue())
    # A progressive file cut after its third scan: libjpeg would smooth
    # the blocks whose AC coefficients are still coarse.
    prog = _encode(_image(32, 32, "noisy"), quality=90, progressive=True)
    sos = [i for i in range(len(prog) - 1) if prog[i:i + 2] == b"\xff\xda"]
    cut = prog[:sos[3]] + b"\xff\xd9"
    for native in (True, False):
        with pytest.raises(jpeg.JpegError, match="block smoothing"):
            jpeg.decode_jpeg(cut, native=native)
    with pytest.raises(jpeg.JpegError, match="SOI"):
        jpeg.decode_jpeg(b"\x89PNG\r\n\x1a\n")
    with pytest.raises(jpeg.JpegError):
        jpeg.decode_jpeg(b"\xff\xd8\xff\xe0" + bytes(16))


def test_corrupt_files_raise_jpeg_error():
    """Seeded corruptions (three bytes changed, the file cut short) of a
    small 4:2:0 file, and a header claiming 65535x65535 pixels: the
    decoder returns an image or raises JpegError, on both paths."""
    data = _encode(_image(16, 24, "noisy"), quality=80)
    rng = np.random.default_rng(9)
    raised = 0
    for _ in range(100):
        bad = bytearray(data)
        for i in rng.integers(2, len(bad), 3):
            bad[i] = rng.integers(0, 256)
        bad = bytes(bad[:rng.integers(2, len(bad) + 1)])
        for native in (True, False):
            try:
                jpeg.decode_jpeg(bad, native=native)
            except jpeg.JpegError:
                raised += 1
    assert raised > 100
    huge = bytearray(data)
    struct.pack_into(">HH", huge, huge.index(b"\xff\xc0") + 5, 65535,
                     65535)
    with pytest.raises(jpeg.JpegError, match="pixel limit"):
        jpeg.decode_jpeg(bytes(huge))


def test_jpeg_sky_equals_jax(tmp_path):
    """The committed studio sky (colour, 4:2:0) and a grey sky."""
    paths = [os.path.join(GOLDEN, "studio_sky_baseline.jpg"),
             os.path.join(GOLDEN, "studio_sky_progressive.jpg")]
    grey = str(tmp_path / "grey.jpeg")
    open(grey, "wb").write(_encode(_image(20, 40, "smooth")[..., 2]))
    for path in paths + [grey]:
        want = jenv.EnvironmentMap()
        want.load_from_file(path)
        got = tenv.EnvironmentMap()
        got.load_from_file(path)
        assert got.pixels.dtype == want.pixels.dtype == np.float32
        np.testing.assert_array_equal(got.pixels, want.pixels)
    assert got.pixels.shape == (20, 40, 3)


def _gltf_with_jpeg(tmp_path, embed):
    """The JAX tests' one-triangle glTF with a base-colour texture: a
    4:2:0 colour JPEG in a GLB bufferView, or a grey JPEG in a data URI of
    a .gltf file."""
    payload = _binary_payload()
    if embed == "bufferView":
        image = _encode(_image(24, 40, "smooth"), quality=85)
    else:
        image = _encode(_image(13, 21, "noisy")[..., 0], quality=70)
    gltf = _build_gltf_dict(len(payload))
    gltf["materials"][0]["pbrMetallicRoughness"]["baseColorTexture"] = {
        "index": 0}
    gltf["textures"] = [{"source": 0}]
    if embed == "bufferView":
        gltf["images"] = [{"bufferView": len(gltf["bufferViews"]),
                           "mimeType": "image/jpeg"}]
        gltf["bufferViews"].append({"buffer": 0, "byteOffset": len(payload),
                                    "byteLength": len(image)})
        blob = payload + image + b"\0" * (-len(image) % 4)
        gltf["buffers"][0]["byteLength"] = len(blob)
        js = json.dumps(gltf).encode()
        js += b" " * (-len(js) % 4)
        path = str(tmp_path / "tex.glb")
        with open(path, "wb") as f:
            f.write(struct.pack("<III", 0x46546C67, 2,
                                28 + len(js) + len(blob)))
            f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
            f.write(struct.pack("<II", len(blob), 0x004E4942) + blob)
    else:
        gltf["buffers"][0]["uri"] = (
            "data:application/octet-stream;base64,"
            + base64.b64encode(payload).decode())
        gltf["images"] = [{"uri": "data:image/jpeg;base64,"
                           + base64.b64encode(image).decode()}]
        path = str(tmp_path / "tex.gltf")
        with open(path, "w") as f:
            json.dump(gltf, f)
    return path


@pytest.mark.parametrize("embed", ["bufferView", "data_uri"])
def test_gltf_jpeg_texture_equals_jax(tmp_path, embed):
    path = _gltf_with_jpeg(tmp_path, embed)
    jm = jml.load_mesh_labeled(path, "original", nearest_tex=True)
    tm = tml.load_mesh_labeled(path, "original", nearest_tex=True)
    assert len(tm.textures) == len(jm.textures) == 1
    assert tm.textures[0].dtype == jm.textures[0].dtype == np.uint8
    assert tm.textures[0].shape == jm.textures[0].shape == (
        (24, 40, 3) if embed == "bufferView" else (13, 21))
    np.testing.assert_array_equal(tm.textures[0], jm.textures[0])
    ja = jm.to_arrays()
    ta = tm.to_tensors("cpu")
    assert ta.has_textures and ja.has_textures
    np.testing.assert_array_equal(ta.atlas.numpy(), np.asarray(ja.atlas))
    for name in ("tex_offset", "tex_width", "tex_height", "mat_tex_ids",
                 "mat_tex_chans"):
        np.testing.assert_array_equal(getattr(ta, name).numpy(),
                                      np.asarray(getattr(ja, name)), name)


def test_load_image_equals_jax(tmp_path):
    """PNG and JPEG, colour and grey, as uint8 [H, W, 3]."""
    rgb = _image(19, 31, "noisy", seed=3)
    files = {"c.jpg": _encode(rgb, quality=88),
             "g.jpg": _encode(rgb[..., 0], quality=88)}
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
    timage_io.save_png(str(tmp_path / "c.png"), rgb)
    for name in ("c.jpg", "g.jpg", "c.png"):
        p = str(tmp_path / name)
        want = jimage_io.load_image(p)
        got = timage_io.load_image(p)
        assert got.shape == want.shape == (19, 31, 3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(23, 37, 3), (48, 64, 3), (9, 17)],
                         ids=["37x23", "64x48", "grey17x9"])
@pytest.mark.parametrize("quality", [50, 95])
def test_numpy_writer_decodes_as_pillow(shape, quality):
    """scripts/jpeg_writer.py (what chip_smoke.py phase 23 encodes with):
    its files decode in Pillow and in both entropy paths to the same bytes,
    within 28 dB of the source (held at 50, measured 33-38 dB)."""
    import sys
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from jpeg_writer import encode_jpeg
    from neural_renderer_tpu_torch.metrics.psnr import compute_psnr
    rgb = _image(shape[0], shape[1], "smooth", seed=quality)
    src = rgb if len(shape) == 3 else rgb[..., 0]
    got = _both_paths_equal_pillow(encode_jpeg(src, quality=quality))
    assert got.shape == src.shape
    wide = (lambda a: a if a.ndim == 3 else np.repeat(a[..., None], 3, -1))
    assert compute_psnr(wide(src), wide(got)) > 28.0


def test_formats_load_without_pillow_or_jax(tmp_path):
    """With JAX, the JAX package, imageio, Pillow and matplotlib made
    unimportable: the JPEG fixture decodes, the DWAB sky loads, a JPEG
    sky and a PLY load through the studio config, and compare_images runs
    on the CPU."""
    import subprocess
    import sys
    code = (
        "import sys, json, os\n"
        "for name in ('jax', 'neural_renderer_tpu', 'imageio', 'PIL',"
        " 'matplotlib'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        "from neural_renderer_tpu_torch.metrics.jpeg import decode_jpeg\n"
        "from neural_renderer_tpu_torch.scene.exr import read_exr\n"
        "from neural_renderer_tpu_torch.scene.mesh_loader import "
        "load_mesh_auto\n"
        "from neural_renderer_tpu_torch.config import load_config\n"
        "from neural_renderer_tpu_torch.scene.scene import Scene\n"
        "from neural_renderer_tpu_torch.cli import compare_images\n"
        "g = 'tests/golden/'\n"
        "d = decode_jpeg(open(g + 'studio_sky_progressive.jpg', 'rb').read())\n"
        "assert (d == np.load(g + 'studio_sky_progressive_decode.npy')).all()\n"
        "assert read_exr(g + 'dwab_reference.exr').shape == (300, 64, 3)\n"
        "cfg = json.load(open('configs/studio/studio_lane.json'))\n"
        "base = os.path.abspath('configs/studio')\n"
        "for k in ('original_mesh', 'inner_shell', 'outer_shell',"
        " 'additional_mesh'):\n"
        "    cfg['scene'][k]['path'] = os.path.join(base,"
        " cfg['scene'][k]['path'])\n"
        "cfg['environment']['hdri_path'] = os.path.abspath("
        "g + 'studio_sky_baseline.jpg')\n"
        f"tmp = {str(tmp_path)!r}\n"
        "json.dump(cfg, open(tmp + '/s.json', 'w'))\n"
        "s = Scene.from_config(load_config(tmp + '/s.json'))\n"
        "assert s.environment_error is None and s.environment.width == 256\n"
        "open(tmp + '/t.ply', 'w').write('ply\\nformat ascii 1.0\\n"
        "element vertex 3\\nproperty float x\\nproperty float y\\n"
        "property float z\\nelement face 1\\n"
        "property list uchar int vertex_indices\\nend_header\\n"
        "0 0 0\\n1 0 0\\n0 1 0\\n3 0 1 2\\n')\n"
        "assert load_mesh_auto(tmp + '/t.ply').num_triangles == 1\n"
        "from neural_renderer_tpu_torch.metrics.image_io import save_png\n"
        "save_png(tmp + '/a.png', d)\n"
        "assert compare_images.main([tmp + '/a.png',"
        " g + 'studio_sky_progressive.jpg', '--device', 'cpu']) == 0\n"
        "print('formats ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "formats ok"
    assert "PSNR: 100.00 dB" in out.stdout
