"""Minimal OpenEXR scanline reader.

Port of `neural_renderer_tpu/scene/exr.py` (`read_exr`, `ExrError`), a copy.
Scope: single-part scanline files, NONE / RLE / ZIPS / ZIP / PIZ / PXR24 /
B44 / B44A / DWAA / DWAB compression, HALF / FLOAT / UINT channels, no
subsampling. PIZ and PXR24 live in exr_piz.py, B44/B44A in exr_b44.py,
DWAA/DWAB in exr_dwa.py.
Unlike the reference's environment loader, nothing falls back to another
decoder: a file this reader refuses raises ExrError.
Layout reference: the OpenEXR file-format notes (openexr.com,
"Reading and Writing Image Files" + ImfZip.cpp predictor/interleave scheme).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = 20000630
_PIX_DTYPE = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}
# NONE, RLE, ZIPS, ZIP, PIZ, PXR24, B44, B44A, DWAA, DWAB
_LINES_PER_BLOCK = {0: 1, 1: 1, 2: 1, 3: 16, 4: 32, 5: 16, 6: 32, 7: 32,
                    8: 32, 9: 256}
_COMP_NAMES = {6: "B44", 7: "B44A", 8: "DWAA", 9: "DWAB"}


class ExrError(ValueError):
    pass


def _cstr(buf: bytes, pos: int) -> tuple[str, int]:
    end = buf.index(b"\0", pos)
    return buf[pos:end].decode("latin-1"), end + 1


def _reconstruct(d: bytes) -> np.ndarray:
    """ImfZip 'predictor' inverse: t[i] = t[i-1] + t[i] - 128 (mod 256)."""
    a = np.frombuffer(d, np.uint8).astype(np.int64)
    a[1:] -= 128
    return (np.cumsum(a) & 0xFF).astype(np.uint8)


def _interleave(d: np.ndarray) -> bytes:
    """ImfZip reorder inverse: merge the two planar halves byte-wise."""
    n = d.size
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = d[:half]
    out[1::2] = d[half:]
    return out.tobytes()


def _rle_decode(raw: bytes, expect: int) -> bytes:
    out = bytearray()
    i, n = 0, len(raw)
    while i < n and len(out) < expect:
        count = struct.unpack_from("<b", raw, i)[0]
        i += 1
        if count < 0:
            out += raw[i:i - count]
            i -= count
        else:
            out += raw[i:i + 1] * (count + 1)
            i += 1
    if len(out) != expect:
        raise ExrError(f"RLE block decoded to {len(out)}, expected {expect}")
    return bytes(out)


def read_exr(path: str) -> np.ndarray:
    """Read an EXR image to float32 [H, W, 3] (R,G,B; a luminance-only 'Y'
    image is replicated across channels). Raises ExrError for anything this
    reader can't handle — including corrupt/truncated files — so callers'
    fallbacks actually fire."""
    try:
        return _read_exr(path)
    except ExrError:
        raise
    except (ValueError, IndexError, struct.error, zlib.error, EOFError,
            OverflowError, MemoryError) as e:
        # bytes.index misses, short struct reads, bogus deflate streams,
        # absurd sizes from corrupt headers — all "not a readable EXR".
        raise ExrError(f"corrupt EXR: {type(e).__name__}: {e}") from e


def _read_exr(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 8:
        raise ExrError("truncated EXR")
    magic, version = struct.unpack_from("<ii", data, 0)
    if magic != MAGIC:
        raise ExrError("not an EXR file (bad magic)")
    if version & 0x200:
        raise ExrError("tiled EXR unsupported")
    if version & (0x800 | 0x1000):
        raise ExrError("deep/multi-part EXR unsupported")

    pos = 8
    attrs: dict[str, tuple[str, bytes]] = {}
    while data[pos] != 0:
        name, pos = _cstr(data, pos)
        typ, pos = _cstr(data, pos)
        size = struct.unpack_from("<i", data, pos)[0]
        pos += 4
        if size < 0 or pos + size > len(data):
            raise ExrError(f"attribute '{name}' has bad size {size}")
        attrs[name] = (typ, data[pos:pos + size])
        pos += size
    pos += 1  # header terminator

    for req in ("channels", "compression", "dataWindow"):
        if req not in attrs:
            raise ExrError(f"missing required attribute '{req}'")

    chans: list[tuple[str, int]] = []
    cbuf = attrs["channels"][1]
    cp = 0
    while cbuf[cp] != 0:
        cname, cp = _cstr(cbuf, cp)
        ptype = struct.unpack_from("<i", cbuf, cp)[0]
        xs, ys = struct.unpack_from("<ii", cbuf, cp + 8)
        cp += 16
        if ptype not in _PIX_DTYPE:
            raise ExrError(f"channel '{cname}' has unknown pixel type {ptype}")
        if xs != 1 or ys != 1:
            raise ExrError("subsampled channels unsupported")
        chans.append((cname, ptype))

    comp = attrs["compression"][1][0]
    if comp not in _LINES_PER_BLOCK:
        raise ExrError(f"{_COMP_NAMES.get(comp, comp)} compression "
                       "unsupported (NONE/RLE/ZIPS/ZIP/PIZ/PXR24/B44/B44A/"
                       "DWAA/DWAB only)")
    lines_per = _LINES_PER_BLOCK[comp]

    xmin, ymin, xmax, ymax = struct.unpack_from("<iiii",
                                                attrs["dataWindow"][1])
    width, height = xmax - xmin + 1, ymax - ymin + 1
    if width <= 0 or height <= 0:
        raise ExrError("empty data window")

    nchunks = (height + lines_per - 1) // lines_per
    offsets = struct.unpack_from(f"<{nchunks}Q", data, pos)

    row_bytes = sum(width * _PIX_DTYPE[t].itemsize for _, t in chans)
    planes = {name: np.zeros((height, width), _PIX_DTYPE[t])
              for name, t in chans}

    for off in offsets:
        y, size = struct.unpack_from("<ii", data, off)
        if y < ymin or y > ymax:
            raise ExrError(f"chunk scanline y={y} outside data window")
        if size < 0 or off + 8 + size > len(data):
            # A negative size would turn the slice stop into a negative
            # index and silently decode garbage.
            raise ExrError(f"chunk at {off} has bad size {size}")
        raw = data[off + 8:off + 8 + size]
        ny = min(lines_per, ymax - y + 1)
        expect = ny * row_bytes
        if comp in (2, 3):  # ZIPS / ZIP
            # Writers store blocks raw when deflate does not shrink them.
            if size < expect:
                raw = _interleave(_reconstruct(zlib.decompress(raw)))
        elif comp == 1:  # RLE: same predictor/reorder around the run coding
            if size < expect:
                raw = _interleave(_reconstruct(_rle_decode(raw, expect)))
        elif comp == 4:  # PIZ (wavelet + Huffman; exr_piz.py)
            if size < expect:
                from .exr_piz import PizError, piz_uncompress_block
                try:
                    raw = piz_uncompress_block(raw, chans, width, ny)
                except PizError as e:
                    raise ExrError(f"PIZ block: {e}") from e
        elif comp == 5:  # PXR24 (zlib over delta byte planes; lossy floats)
            if size < expect:
                from .exr_piz import PizError, pxr24_uncompress_block
                try:
                    raw = pxr24_uncompress_block(raw, chans, width, ny)
                except PizError as e:
                    raise ExrError(f"PXR24 block: {e}") from e
        elif comp in (6, 7):  # B44 / B44A (4x4 half blocks; exr_b44.py)
            # All-FLOAT/UINT chunks code to exactly raw size, and the
            # writer then stores them raw (generic EXR fallback rule).
            if size < expect:
                from .exr_b44 import B44Error, b44_uncompress_block
                try:
                    raw = b44_uncompress_block(raw, chans, width, ny)
                except B44Error as e:
                    raise ExrError(f"B44 block: {e}") from e
        elif comp in (8, 9):  # DWAA / DWAB (lossy DCT; exr_dwa.py)
            if size < expect:
                from .exr_dwa import DwaError, dwa_uncompress_block
                try:
                    raw = dwa_uncompress_block(raw, chans, width, ny)
                except DwaError as e:
                    raise ExrError(f"DWA block: {e}") from e
        if len(raw) < expect:
            raise ExrError("truncated scanline block")
        bp = 0
        for line in range(ny):
            row = y - ymin + line
            for cname, ptype in chans:
                w = width * _PIX_DTYPE[ptype].itemsize
                planes[cname][row] = np.frombuffer(raw, _PIX_DTYPE[ptype],
                                                   count=width, offset=bp)
                bp += w

    def as_f32(p: np.ndarray) -> np.ndarray:
        return p.astype(np.float32)

    if all(c in planes for c in "RGB"):
        img = np.stack([as_f32(planes["R"]), as_f32(planes["G"]),
                        as_f32(planes["B"])], axis=-1)
    elif "Y" in planes:
        img = as_f32(planes["Y"])[..., None].repeat(3, axis=-1)
    else:
        first = as_f32(planes[chans[0][0]])
        img = first[..., None].repeat(3, axis=-1)
    return np.ascontiguousarray(img)
