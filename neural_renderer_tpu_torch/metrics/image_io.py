"""PNG writing and reading with the standard library (`zlib` + `struct`).

Counterpart of `neural_renderer_tpu/metrics/image_io.py`, which goes through
`imageio`; this package writes and reads 8-bit PNG itself, so it needs
nothing beyond numpy. The writer emits 8-bit RGB, non-interlaced, filter 0;
the reader takes 8-bit greyscale / RGB / RGBA (and their alpha variants),
non-interlaced, all five filters.
"""

from __future__ import annotations

import struct
import sys
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # color type -> samples per pixel


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(pixels: np.ndarray) -> bytes:
    """uint8 [H, W, 3] (or [H, W, 4], alpha dropped) -> PNG bytes."""
    px = np.ascontiguousarray(np.asarray(pixels)[..., :3], np.uint8)
    if px.ndim != 3 or px.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] uint8, got {px.shape}")
    h, w, _ = px.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)   # filter byte 0 per scanline
    rows[:, 1:] = px.reshape(h, 3 * w)
    return (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_png(path: str, pixels: np.ndarray) -> bool:
    """pixels: uint8 [H, W, 3] (or [H, W, 4], alpha dropped)."""
    try:
        with open(path, "wb") as f:
            f.write(encode_png(pixels))
    except OSError as e:
        print(f"Failed to write PNG: {path} ({e})", file=sys.stderr)
        return False
    print(f"Saved: {path}")
    return True


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, 3]."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        length, tag = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"unsupported PNG (depth {depth}, color type "
                         f"{ctype}, interlace {interlace}); 8-bit "
                         "non-interlaced grey/RGB(A) only")
    c = _CHANNELS[ctype]
    stride = w * c
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError("PNG data has the wrong size")
    raw = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = int(raw[y, 0])
        line = raw[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 255
        elif ftype in (1, 3, 4):
            # These filters read the pixel to the left: run per channel over
            # the pixel columns.
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - c] if x >= c else 0
                b = prev[x]
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) >> 1
                else:
                    cc = prev[x - c] if x >= c else 0
                    p = a + b - cc
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                    pred = a if (pa <= pb and pa <= pc) else \
                        (b if pb <= pc else cc)
                cur[x] = (line[x] + pred) & 255
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    img = out.reshape(h, w, c)
    if c <= 2:                       # grey (+ alpha)
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def load_image(path: str) -> np.ndarray:
    """Load a PNG as uint8 [H, W, 3]."""
    with open(path, "rb") as f:
        return decode_png(f.read())
