"""The port's environment loaders against the JAX package's, on the CPU.

EXR (`scene/exr.py`, `exr_piz.py`, `exr_b44.py`, `exr_write.py`): the
port's reader equals the JAX reader bit for bit on the shipped PIZ sky and
the PIZ / PXR24 / B44 / B44A golden files; files the port's writer makes
(NONE / ZIPS / ZIP / PIZ, HALF and FLOAT, RGB and luminance) and those of
the JAX tests' own writer (RLE, UINT) read back the same in both readers;
corrupt files raise ExrError (DWAA / DWAB: tests/test_torch_dwa.py).
HDR: the native decoder (`csrc/hdr_rle.cpp`) and the Python one equal the
JAX `load_hdr` on RLE and flat files. PNG environment maps equal the JAX
`_load_ldr` (imageio) for 8- and 16-bit, grey and RGB(A); a JPEG that
does not decode raises JpegError (JPEG skies: tests/test_torch_jpeg.py).
The loaders are numpy code; nothing here runs on a device.
"""

import os
import struct

import numpy as np
import pytest
import torch

from neural_renderer_tpu.scene import envmap as jenv
from neural_renderer_tpu.scene import exr as jexr

from test_envmap import _rgbe_image, _write_hdr_flat, _write_hdr_rle
from test_exr import write_exr as jax_test_writer

from neural_renderer_tpu_torch.metrics import image_io
from neural_renderer_tpu_torch.scene import envmap as tenv
from neural_renderer_tpu_torch.scene import exr as texr
from neural_renderer_tpu_torch.scene.exr_write import write_exr

# One intra-op thread: the suite runs several pytest workers side by side,
# and PyTorch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = [os.path.join(ROOT, "configs", "studio", "sky.exr")] + [
    os.path.join(ROOT, "tests", "golden", f"{n}_reference.exr")
    for n in ("piz", "pxr24", "b44", "b44a")]


def _compression(path):
    data = open(path, "rb").read()
    key = b"compression\0compression\0"
    return data[data.index(key) + len(key) + 4]


@pytest.mark.parametrize("path", FILES, ids=os.path.basename)
def test_reader_equals_jax_on_shipped_files(path):
    """sky.exr is PIZ (compression byte 4), as are piz_reference.exr; the
    others are PXR24 (5), B44 (6), B44A (7)."""
    want = jexr.read_exr(path)
    got = texr.read_exr(path)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if path.endswith("sky.exr"):
        assert _compression(path) == 4 and got.shape == (128, 256, 3)


@pytest.mark.parametrize("compression", ["none", "zips", "zip", "piz"])
@pytest.mark.parametrize("half", [True, False])
@pytest.mark.parametrize("luminance", [False, True])
def test_port_writer_read_by_jax(tmp_path, compression, half, luminance):
    """A 45 x 37 image (several ZIP and PIZ blocks, a short last one)
    written by the port's writer reads back the same through both readers,
    equal to the image as stored."""
    rng = np.random.default_rng(7)
    shape = (45, 37) if luminance else (45, 37, 3)
    img = (rng.random(shape) * 5.0).astype(np.float32)
    img[:9] = 1.5          # flat rows: PIZ's runs and ZIP's repeats
    stored = img.astype(np.float16).astype(np.float32) if half else img
    p = str(tmp_path / "w.exr")
    write_exr(p, img, compression=compression, half=half)
    want = jexr.read_exr(p)
    np.testing.assert_array_equal(texr.read_exr(p), want)
    expect = stored[..., None].repeat(3, axis=-1) if luminance else stored
    np.testing.assert_array_equal(want, expect)


@pytest.mark.parametrize("comp,ptype", [(1, 1), (1, 2), (1, 0), (3, 0)])
def test_rle_and_uint_files_equal_jax(tmp_path, comp, ptype):
    """RLE and UINT, which the port's writer does not make, through the
    JAX tests' writer."""
    rng = np.random.default_rng(comp * 10 + ptype)
    img = (rng.random((21, 19, 3)) * 7.0).astype(np.float32)
    if ptype == 0:
        img = np.floor(img * 1000.0)
    p = str(tmp_path / "t.exr")
    jax_test_writer(p, img, ptype=ptype, comp=comp)
    np.testing.assert_array_equal(texr.read_exr(p), jexr.read_exr(p))


def test_corrupt_and_unported_files_raise(tmp_path):
    """Truncation, garbage, a negative attribute size and an unknown
    compression byte raise ExrError in the port, as in the JAX reader, with
    no fallback decoder behind the reader (a DWA block cut short:
    tests/test_torch_dwa.py)."""
    p = str(tmp_path / "bad.exr")
    write_exr(p, np.ones((20, 8, 3), np.float32), compression="zip",
              half=False)
    data = open(p, "rb").read()
    for cut in (40, 12, len(data) - 5):
        open(p, "wb").write(data[:cut])
        with pytest.raises(texr.ExrError):
            texr.read_exr(p)
    raw = bytearray(data)
    key = b"dataWindow\0box2i\0"
    i = raw.index(key) + len(key)
    raw[i:i + 4] = (-8).to_bytes(4, "little", signed=True)
    open(p, "wb").write(bytes(raw))
    with pytest.raises(texr.ExrError):
        texr.read_exr(p)
    open(p, "wb").write(b"NOTEXR" + bytes(64))
    with pytest.raises(texr.ExrError, match="magic"):
        texr.read_exr(p)
    dwa = open(os.path.join(ROOT, "tests", "golden", "dwaa_reference.exr"),
               "rb").read()
    key = b"compression\0compression\0"
    i = dwa.index(key) + len(key) + 4
    assert dwa[i] == 8
    open(p, "wb").write(dwa[:i] + bytes([10]) + dwa[i + 1:])
    with pytest.raises(texr.ExrError, match="compression"):
        texr.read_exr(p)
    with pytest.raises(jexr.ExrError, match="compression"):
        jexr.read_exr(p)
    env = tenv.EnvironmentMap()
    with pytest.raises(texr.ExrError):
        env.load_from_file(p)       # no fallback decoder behind the reader


@pytest.mark.parametrize("flat", [False, True])
def test_hdr_native_and_python_equal_jax(tmp_path, flat, monkeypatch):
    rgbe = _rgbe_image(np.random.default_rng(11), 7, 40)
    p = tmp_path / "e.hdr"
    (_write_hdr_flat if flat else _write_hdr_rle)(p, rgbe)
    assert tenv._load_rle_native() is not None
    want = jenv.load_hdr(str(p))
    np.testing.assert_array_equal(tenv.load_hdr(str(p)), want)
    monkeypatch.setitem(tenv._RLE, "lib", None)    # the Python decoder
    np.testing.assert_array_equal(tenv.load_hdr(str(p)), want)
    monkeypatch.undo()
    env = tenv.EnvironmentMap(rotation=30.0, strength=2.0)
    env.load_from_file(str(p))
    t = env.to_tensors(device="cpu")
    assert (t.width, t.height, t.is_valid) == (40, 7, True)
    assert (t.rotation, t.strength) == (30.0, 2.0)
    np.testing.assert_array_equal(t.pixels.numpy(),
                                  want.reshape(-1, 3).T)


def test_hdr_errors_match_jax(tmp_path):
    p = tmp_path / "t.hdr"
    _write_hdr_rle(p, _rgbe_image(np.random.default_rng(2), 3, 16))
    data = p.read_bytes()
    for bad in (data[:-20], data.replace(b"32-bit_rle_rgbe", b"32-bit_xyz")):
        p.write_bytes(bad)
        with pytest.raises(jenv.EnvmapLoadError):
            jenv.load_hdr(str(p))
        with pytest.raises(tenv.EnvmapLoadError):
            tenv.load_hdr(str(p))


def _png(w, h, depth, ctype, samples):
    """An uncompressed-filter PNG of `samples` [h, w*c] (16-bit big
    endian)."""
    import zlib

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))
    raw = samples.astype(">u2" if depth == 16 else np.uint8).tobytes()
    stride = len(raw) // h
    rows = b"".join(b"\0" + raw[y * stride:(y + 1) * stride]
                    for y in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                         0, 0))
            + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("depth,ctype", [(8, 2), (8, 6), (8, 0), (16, 2),
                                         (16, 0)])
def test_png_environment_equals_jax(tmp_path, depth, ctype):
    """uint8 / 255, uint16 / 65535 (16-bit grey), grey replicated, alpha
    dropped: the JAX `_load_ldr` through imageio, the port through
    `decode_png`."""
    c = {0: 1, 2: 3, 6: 4}[ctype]
    w, h = 9, 5
    hi = 65536 if depth == 16 else 256
    samples = np.random.default_rng(depth + ctype).integers(
        0, hi, (h, w * c))
    p = str(tmp_path / "env.png")
    with open(p, "wb") as f:
        f.write(_png(w, h, depth, ctype, samples))
    want = jenv._load_ldr(p)
    got = tenv._load_ldr(p)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    env = tenv.EnvironmentMap()
    env.load_from_file(p)
    np.testing.assert_array_equal(env.pixels, want)


def test_jpeg_environment_raises(tmp_path):
    """A .jpg sky that is not a decodable JPEG raises; it does not turn
    into the procedural sky."""
    from neural_renderer_tpu_torch.metrics.jpeg import JpegError
    p = str(tmp_path / "env.jpg")
    with open(p, "wb") as f:
        f.write(b"\xff\xd8\xff\xe0" + bytes(32))
    with pytest.raises(JpegError):
        tenv.EnvironmentMap().load_from_file(p)


def test_png_writer_round_trip_through_decoder():
    """`decode_png` (rgb=True, the default) still gives `encode_png`'s
    pixels back."""
    img = np.random.default_rng(3).integers(0, 256, (6, 11, 3),
                                            dtype=np.uint8)
    np.testing.assert_array_equal(
        image_io.decode_png(image_io.encode_png(img)), img)
