"""OpenEXR scanline writer (NONE / ZIPS / ZIP / PIZ).

Port (a copy: the module imports nothing of JAX) of
`neural_renderer_tpu/scene/exr_write.py`: single-part scanline files, HALF
or FLOAT channels, RGB or luminance-only. It writes HDR output and the
round-trip files of the reader's tests.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .exr_piz import piz_compress_block

_COMP_IDS = {"none": 0, "zips": 2, "zip": 3, "piz": 4}
_LINES = {0: 1, 2: 1, 3: 16, 4: 32}
_DT = {1: np.dtype("<f2"), 2: np.dtype("<f4")}


def _predict(a: np.ndarray) -> bytes:
    """ImfZip forward predictor: d[i] = t[i] - t[i-1] + 128 (mod 256)."""
    d = a.astype(np.int64)
    d[1:] = d[1:] - d[:-1] + 128
    return (d & 0xFF).astype(np.uint8).tobytes()


def _split(b: bytes) -> np.ndarray:
    """ImfZip forward reorder: even bytes then odd bytes."""
    a = np.frombuffer(b, np.uint8)
    half = (a.size + 1) // 2
    out = np.empty(a.size, np.uint8)
    out[:half] = a[0::2]
    out[half:] = a[1::2]
    return out


def write_exr(path: str, img: np.ndarray, compression: str = "piz",
              half: bool = True):
    """Write float image [H, W, 3] (RGB) or [H, W] (luminance 'Y') to EXR.

    compression: "none" | "zips" | "zip" | "piz". half=True stores HALF
    pixels (the HDRI norm), else FLOAT."""
    comp = _COMP_IDS[compression]
    lines_per = _LINES[comp]
    ptype = 1 if half else 2
    dt = _DT[ptype]
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        names = ["Y"]
        planes = [img]
    elif img.ndim == 3 and img.shape[2] == 3:
        names = ["B", "G", "R"]  # EXR channel lists are alphabetical
        planes = [img[..., 2], img[..., 1], img[..., 0]]
    else:
        raise ValueError(f"write_exr: unsupported shape {img.shape}")
    h, w = img.shape[:2]
    chans = [(n, ptype) for n in names]

    def attr(name, typ, payload):
        return (name.encode() + b"\0" + typ.encode() + b"\0"
                + struct.pack("<i", len(payload)) + payload)

    ch = b""
    for n in names:
        ch += (n.encode() + b"\0" + struct.pack("<i", ptype)
               + b"\0\0\0\0" + struct.pack("<ii", 1, 1))
    ch += b"\0"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (attr("channels", "chlist", ch)
              + attr("compression", "compression", bytes([comp]))
              + attr("dataWindow", "box2i", box)
              + attr("displayWindow", "box2i", box)
              + attr("lineOrder", "lineOrder", b"\0")
              + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
              + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + b"\0")

    chunks = []
    for y in range(0, h, lines_per):
        ny = min(lines_per, h - y)
        rows = b"".join(
            np.ascontiguousarray(p[y + line]).astype(dt).tobytes()
            for line in range(ny) for p in planes)
        if comp in (2, 3):
            enc = zlib.compress(_predict(_split(rows)))
        elif comp == 4:
            enc = piz_compress_block(rows, chans, w, ny)
        else:
            enc = rows
        if comp and len(enc) >= len(rows):
            enc = rows  # raw fallback, as real writers do
        chunks.append((y, enc))

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", 20000630, 2))
        f.write(header)
        off = 8 + len(header) + 8 * len(chunks)
        for y, enc in chunks:
            f.write(struct.pack("<Q", off))
            off += 8 + len(enc)
        for y, enc in chunks:
            f.write(struct.pack("<ii", y, len(enc)))
            f.write(enc)
