"""A baseline JPEG encoder in numpy (JFIF, 4:4:4 colour or grey).

The machine with the GPU has no Pillow or imageio, and chip_smoke.py
(phase 23) needs a JPEG of a rendered image to feed `compare_images`; the
port itself only decodes JPEG. This writer is what that phase and
tests/test_torch_jpeg.py use:

    encode_jpeg(pixels, quality=90) -> bytes

uint8 [H, W, 3] is converted to YCbCr (JFIF), [H, W] is coded as grey.
Blocks are the orthonormal 8x8 DCT of the level-shifted samples (edge
samples replicated to whole blocks), quantised with the JPEG standard's
example tables scaled as libjpeg scales them for `quality`, and coded with
Huffman tables of fixed lengths (every DC category a 4-bit code, every AC
run/size symbol an 8-bit code): valid for every decoder, if not the
smallest file.
"""

from __future__ import annotations

import struct

import numpy as np

_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_Q = np.full(64, 99)
_CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25, 27]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66, 99]

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# Fixed-length tables: DC categories 0-11 as 4-bit codes, the 162 AC
# symbols (EOB, ZRL, run 0-15 x size 1-10) as 8-bit codes; no code is all
# ones.
_DC_SYMBOLS = list(range(12))
_AC_SYMBOLS = [0x00, 0xF0] + [(r << 4) | s for r in range(16)
                              for s in range(1, 11)]


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    c = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * 0.5
    c[0] /= np.sqrt(2.0)
    return c


def _qtable(base: np.ndarray, quality: int) -> np.ndarray:
    """The table in natural order, scaled as libjpeg's jpeg_quality_scaling
    and jpeg_add_quant_table (baseline: clamped to [1, 255])."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def _blocks(plane: np.ndarray) -> tuple[np.ndarray, int, int]:
    """[H, W] -> [by * bx, 8, 8] blocks, edges replicated."""
    h, w = plane.shape
    ph, pw = -h % 8, -w % 8
    p = np.pad(plane, ((0, ph), (0, pw)), mode="edge")
    by, bx = p.shape[0] // 8, p.shape[1] // 8
    return p.reshape(by, 8, bx, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8), \
        by, bx


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, code: int, length: int):
        self.acc = (self.acc << length) | (code & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0x00)
        self.acc &= (1 << self.n) - 1

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)   # pad with ones
        return bytes(self.out)


def _category(v: int) -> int:
    return abs(v).bit_length()


def encode_jpeg(pixels: np.ndarray, quality: int = 90) -> bytes:
    """uint8 [H, W, 3] (YCbCr 4:4:4) or [H, W] (grey) -> JPEG bytes."""
    px = np.asarray(pixels)
    if px.dtype != np.uint8 or px.ndim not in (2, 3) or (
            px.ndim == 3 and px.shape[2] != 3):
        raise ValueError(f"expected uint8 [H, W] or [H, W, 3], got "
                         f"{px.dtype} {px.shape}")
    h, w = px.shape[:2]
    if px.ndim == 2:
        planes = [px.astype(np.float64)]
    else:
        r, g, b = (px[..., i].astype(np.float64) for i in range(3))
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128.0]
    qts = [_qtable(_LUMA_Q, quality), _qtable(_CHROMA_Q, quality)]
    c = _dct_matrix()
    coded = []
    for i, plane in enumerate(planes):
        blocks, by, bx = _blocks(plane - 128.0)
        coef = np.einsum("ux,nxy,vy->nuv", c, blocks, c).reshape(-1, 64)
        q = qts[min(i, 1)]
        coded.append(np.rint(coef / q).astype(np.int64)[:, _ZIGZAG])
    dc_code = {s: (k, 4) for k, s in enumerate(_DC_SYMBOLS)}
    ac_code = {s: (k, 8) for k, s in enumerate(_AC_SYMBOLS)}
    bw = _BitWriter()
    pred = [0] * len(planes)
    for blk in range(coded[0].shape[0]):            # 4:4:4: one block each
        for ci, zz in enumerate(coded):
            row = zz[blk].tolist()
            diff = row[0] - pred[ci]
            pred[ci] = row[0]
            s = _category(diff)
            bw.put(*dc_code[s])
            if s:
                bw.put(diff if diff > 0 else diff + (1 << s) - 1, s)
            run = 0
            last = max((k for k in range(1, 64) if row[k]), default=0)
            for k in range(1, last + 1):
                v = row[k]
                if v == 0:
                    run += 1
                    continue
                while run > 15:
                    bw.put(*ac_code[0xF0])
                    run -= 16
                s = _category(v)
                bw.put(*ac_code[(run << 4) | s])
                bw.put(v if v > 0 else v + (1 << s) - 1, s)
                run = 0
            if last < 63:
                bw.put(*ac_code[0x00])
    data = bw.flush()

    def segment(marker: int, body: bytes) -> bytes:
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body

    def dht(tc_th: int, symbols: list[int], length: int) -> bytes:
        counts = [0] * 16
        counts[length - 1] = len(symbols)
        return bytes([tc_th] + counts + symbols)

    nc = len(planes)
    out = b"\xff\xd8" + segment(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    out += segment(0xDB, b"".join(bytes([t]) + bytes(qts[t][_ZIGZAG].tolist())
                                  for t in range(min(nc, 2))))
    out += segment(0xC0, struct.pack(">BHHB", 8, h, w, nc) + b"".join(
        bytes([i + 1, 0x11, min(i, 1)]) for i in range(nc)))
    out += segment(0xC4, dht(0x00, _DC_SYMBOLS, 4) + dht(0x10, _AC_SYMBOLS, 8))
    out += segment(0xDA, bytes([nc]) + b"".join(
        bytes([i + 1, 0x00]) for i in range(nc)) + b"\x00\x3f\x00")
    return out + data + b"\xff\xd9"
