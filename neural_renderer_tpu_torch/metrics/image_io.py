"""PNG writing and reading with the standard library (`zlib` + `struct`).

Counterpart of `neural_renderer_tpu/metrics/image_io.py`, which goes through
`imageio`; this package writes and reads PNG itself (and JPEG through
`metrics/jpeg.py`), so it needs nothing beyond numpy. The writer emits 8-bit RGB, non-interlaced, filter 0; the
reader takes every bit depth and colour type, non-interlaced, all five
filters, and can return the pixels as imageio gives them (textures).
"""

from __future__ import annotations

import struct
import sys
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # color type -> samples per pixel


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
    return (PNG_SIGNATURE
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


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five PNG scanline filters: [h, stride + 1] -> [h, stride]
    uint8. `bpp` is the filters' byte distance to the left pixel."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype = int(raw[y, 0])
        line = raw[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:
            # Sub: a running sum per byte position within the pixel.
            pad = (-stride) % bpp
            grid = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(
                -1, bpp).astype(np.int64)
            cur = (np.cumsum(grid, axis=0) & 255).astype(np.uint8).reshape(
                -1)[:stride]
        elif ftype == 2:
            cur = line + prev
        elif ftype in (3, 4):
            # These read the left pixel of the row being decoded: one byte
            # at a time.
            ln, pv = line.tolist(), prev.tolist()
            cu = [0] * stride
            for x in range(stride):
                a = cu[x - bpp] if x >= bpp else 0
                b = pv[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = pv[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else \
                        (b if pb <= pc else c)
                cu[x] = (ln[x] + pred) & 255
            cur = np.asarray(cu, np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes, rgb: bool = True) -> np.ndarray:
    """PNG bytes -> pixels (non-interlaced, every bit depth and colour
    type). rgb=True: uint8 [H, W, 3] (grey replicated, alpha dropped,
    16-bit samples cut to their high byte). rgb=False: what imageio
    (Pillow) returns for the file, which the texture atlas reads by dtype:
    grey [H, W] (1-bit as bool, 2- and 4-bit scaled to uint8, 16-bit as
    uint16), grey+alpha [H, W, 2], RGB [H, W, 3], RGBA [H, W, 4], palette
    as RGB, 16-bit colour as uint8 high bytes (16-bit grey+alpha as
    RGBA); tRNS is ignored."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header, palette = 8, [], None, None
    while pos + 8 <= len(data):
        length, tag = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or interlace != 0 or depth not in (
            1, 2, 4, 8, 16) or (ctype != 0 and ctype != 3 and depth < 8) \
            or (ctype == 3 and depth == 16):
        raise ValueError(f"unsupported PNG (depth {depth}, color type "
                         f"{ctype}, interlace {interlace}); non-interlaced "
                         "only")
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    c = _CHANNELS[ctype]
    stride = (w * c * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError("PNG data has the wrong size")
    rows = _unfilter(raw.reshape(h, stride + 1), h, stride,
                     max(1, c * depth // 8))
    if depth == 16:
        vals = rows.view(">u2").astype(np.uint16).reshape(h, w, c)
    elif depth == 8:
        vals = rows.reshape(h, w, c)
    else:
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
        weights = 1 << np.arange(depth - 1, -1, -1)
        vals = (bits * weights).sum(axis=2)[:, :w].astype(np.uint8)[..., None]
    if ctype == 3:
        img = palette[np.minimum(vals[..., 0], len(palette) - 1)]
    elif depth < 8:
        img = (vals[..., 0] != 0) if depth == 1 else \
            (vals[..., 0] * (255 // ((1 << depth) - 1))).astype(np.uint8)
    elif depth == 16 and ctype != 0:
        img = (vals >> 8).astype(np.uint8)
        if ctype == 4:
            img = img[..., [0, 0, 0, 1]]
    else:
        img = vals[..., 0] if c == 1 else vals
    img = np.ascontiguousarray(img)
    if not rgb:
        return img
    if img.dtype == np.bool_:
        img = img.astype(np.uint8) * 255
    elif img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[2] <= 2:            # grey (+ alpha)
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def load_image(path: str) -> np.ndarray:
    """Load a PNG or JPEG (told apart by their signatures) as uint8
    [H, W, 3], grey replicated."""
    from .jpeg import JPEG_SOI, decode_jpeg
    with open(path, "rb") as f:
        data = f.read()
    if data[:3] != JPEG_SOI:
        return decode_png(data)
    img = decode_jpeg(data)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img
