"""The port's DWAA / DWAB EXR decoder against the JAX package's, on the CPU.

`scene/exr_dwa.py` is a copy of the JAX module (numpy + zlib, nothing of
JAX), reading `_interleave`, `_reconstruct`, `_rle_decode` from the port's
`scene/exr.py` and `huf_uncompress` from its `scene/exr_piz.py`. On the two
fixtures OpenEXR 3.1 wrote (scripts/make_dwa_fixture.py) the port's
`read_exr` and every `dwa_uncompress_block` output equal the JAX package's
bit for bit, and the decode holds the JAX tests' bar against OpenEXR's own
decode (tests/test_exr.py::test_dwa_reference_fixture): at least 99.9% of
the lossy-DCT halfs identical and none more than 4 half-ulps apart, the RLE
(alpha) and UNKNOWN (float Z) channels bit-exact. A block cut short raises
DwaError, which `read_exr` turns into ExrError.
"""

import os
import struct

import numpy as np
import pytest
import torch

from neural_renderer_tpu.scene import exr as jexr
from neural_renderer_tpu.scene import exr_dwa as jdwa

from test_exr import _exr_chunks

from neural_renderer_tpu_torch.scene import exr as texr
from neural_renderer_tpu_torch.scene import exr_dwa as tdwa
from neural_renderer_tpu_torch.scene.envmap import EnvironmentMap

# One intra-op thread: the suite runs several pytest workers side by side,
# and PyTorch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
NAMES = ["dwaa", "dwab"]


def _path(name):
    return os.path.join(GOLDEN, f"{name}_reference.exr")


@pytest.mark.parametrize("name", NAMES)
def test_read_exr_equals_jax(name):
    """Compression byte 8 (DWAA, 32-line blocks) and 9 (DWAB, 256)."""
    want = jexr.read_exr(_path(name))
    got = texr.read_exr(_path(name))
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == {"dwaa": (48, 64, 3),
                                       "dwab": (300, 64, 3)}[name]
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    env = EnvironmentMap()
    env.load_from_file(_path(name))
    np.testing.assert_array_equal(env.pixels, want)


@pytest.mark.parametrize("name", NAMES)
def test_blocks_equal_jax(name):
    """Every block's decoded bytes, all channels (alpha and Z too)."""
    blocks = 0
    for raw, chans, width, ny in _exr_chunks(_path(name)):
        got = tdwa.dwa_uncompress_block(raw, chans, width, ny)
        assert got == jdwa.dwa_uncompress_block(raw, chans, width, ny)
        blocks += 1
    assert blocks == {"dwaa": 2, "dwab": 2}[name]


@pytest.mark.parametrize("name", NAMES)
def test_decode_holds_openexr_bar(name):
    want = np.load(os.path.join(GOLDEN, f"{name}_reference_decode.npy"))
    got = texr.read_exr(_path(name))
    gb = got.astype(np.float16).view(np.uint16).astype(int)
    wb = want[:, :, :3].astype(np.float16).view(np.uint16).astype(int)
    ulp = np.abs(gb - wb)
    assert (ulp == 0).mean() >= 0.999
    assert ulp.max() <= 4
    # The lossless fourth channel: dwaa's A takes the RLE scheme, dwab's
    # float Z the UNKNOWN (deflate) scheme.
    rows = []
    for raw, chans, width, ny in _exr_chunks(_path(name)):
        out = tdwa.dwa_uncompress_block(raw, chans, width, ny)
        sizes = [width * (4 if t == 2 else 2) for _, t in chans]
        row_bytes = sum(sizes)
        k = [c for c, _ in chans].index("A" if name == "dwaa" else "Z")
        start = sum(sizes[:k])
        for r in range(ny):
            seg = out[r * row_bytes + start:r * row_bytes + start + sizes[k]]
            rows.append(np.frombuffer(
                seg, np.float16 if name == "dwaa" else np.float32))
    fourth = np.stack(rows).astype(np.float32)
    np.testing.assert_array_equal(fourth, want[:, :, 3])


def test_truncated_block_raises(tmp_path):
    raw, chans, width, ny = next(_exr_chunks(_path("dwab")))
    for cut in (10, 100, len(raw) - 50):
        with pytest.raises(tdwa.DwaError):
            tdwa.dwa_uncompress_block(raw[:cut], chans, width, ny)
        with pytest.raises(jdwa.DwaError):
            jdwa.dwa_uncompress_block(raw[:cut], chans, width, ny)
    # The same cut inside a file: read_exr raises ExrError, as JAX's does.
    data = bytearray(open(_path("dwab"), "rb").read())
    first = data.index(raw) - 8
    size = struct.unpack_from("<i", data, first + 4)[0]
    struct.pack_into("<i", data, first + 4, size - 50)
    p = str(tmp_path / "cut.exr")
    open(p, "wb").write(bytes(data))
    with pytest.raises(texr.ExrError, match="DWA block"):
        texr.read_exr(p)
    with pytest.raises(jexr.ExrError, match="DWA block"):
        jexr.read_exr(p)
