"""EXR B44 / B44A decoders (compression ids 6 / 7).

Port (a copy: the module imports nothing of JAX) of
`neural_renderer_tpu/scene/exr_b44.py`. B44 packs each HALF channel in 4x4
pixel blocks of 14 bytes: the first pixel's monotonic-mapped 16-bit value,
a 4-bit shift, and fifteen 6-bit biased neighbor differences chained
column-then-row (s0->s4->s8->s12 down the first column, each row chained
rightward from its column anchor). B44A additionally emits 3-byte blocks
(marker byte b[2] == 0xfc) for flat 4x4 regions. Non-HALF channels are
stored verbatim. Lossy for shift > 0 (shift-and-round on the differences).
Scanline chunks are 32 rows. The golden files tests/golden/b44*_reference.exr
hold it bit-exactly to the OpenEXR library's decode.
"""

from __future__ import annotations

import numpy as np

__all__ = ["B44Error", "b44_uncompress_block"]


class B44Error(RuntimeError):
    pass


_PIX_DTYPE = {0: np.dtype("<u4"), 1: np.dtype("<u2"), 2: np.dtype("<f4")}


def _unpack14(blocks: np.ndarray) -> np.ndarray:
    """blocks: [N, 14] uint8 -> [N, 16] uint16 half bit patterns (4x4
    row-major per block)."""
    b = blocks.astype(np.int64)
    s = np.zeros((b.shape[0], 16), np.int64)
    s[:, 0] = (b[:, 0] << 8) | b[:, 1]
    shift = b[:, 2] >> 2
    bias = 0x20 << shift

    def r(hi, lo, hs, ls):
        return (((b[:, hi] << hs) | (b[:, lo] >> ls)) & 0x3F) << shift

    d = [
        r(2, 3, 4, 4), r(3, 4, 2, 6), ((b[:, 4] & 0x3F) << shift),
        ((b[:, 5] >> 2) << shift), r(5, 6, 4, 4), r(6, 7, 2, 6),
        ((b[:, 7] & 0x3F) << shift),
        ((b[:, 8] >> 2) << shift), r(8, 9, 4, 4), r(9, 10, 2, 6),
        ((b[:, 10] & 0x3F) << shift),
        ((b[:, 11] >> 2) << shift), r(11, 12, 4, 4), r(12, 13, 2, 6),
        ((b[:, 13] & 0x3F) << shift),
    ]
    # Column anchors s0 -> s4 -> s8 -> s12, then each row chained from its
    # anchor (ImfB44Compressor unpack14 order).
    s[:, 4] = s[:, 0] + d[0] - bias
    s[:, 8] = s[:, 4] + d[1] - bias
    s[:, 12] = s[:, 8] + d[2] - bias
    s[:, 1] = s[:, 0] + d[3] - bias
    s[:, 5] = s[:, 4] + d[4] - bias
    s[:, 9] = s[:, 8] + d[5] - bias
    s[:, 13] = s[:, 12] + d[6] - bias
    s[:, 2] = s[:, 1] + d[7] - bias
    s[:, 6] = s[:, 5] + d[8] - bias
    s[:, 10] = s[:, 9] + d[9] - bias
    s[:, 14] = s[:, 13] + d[10] - bias
    s[:, 3] = s[:, 2] + d[11] - bias
    s[:, 7] = s[:, 6] + d[12] - bias
    s[:, 11] = s[:, 10] + d[13] - bias
    s[:, 15] = s[:, 14] + d[14] - bias
    s &= 0xFFFF
    # Inverse of the monotonic sign-magnitude mapping.
    return np.where(s & 0x8000, s & 0x7FFF, ~s & 0xFFFF).astype(np.uint16)


def _unpack3(blocks: np.ndarray) -> np.ndarray:
    """Flat blocks [N, 3] uint8 -> [N, 16] uint16 (all 16 pixels equal)."""
    s0 = (blocks[:, 0].astype(np.int64) << 8) | blocks[:, 1]
    s0 = np.where(s0 & 0x8000, s0 & 0x7FFF, ~s0 & 0xFFFF).astype(np.uint16)
    return np.repeat(s0[:, None], 16, axis=1)


def b44_uncompress_block(raw: bytes, chans, width: int, ny: int) -> bytes:
    """Decode one B44/B44A chunk into the standard interleaved scanline
    layout (per line: each channel's `width` values in channel order).

    chans: [(name, pixel_type)] in file order. HALF channels are block
    coded; FLOAT/UINT channels are stored verbatim (channel-major within
    the chunk)."""
    buf = np.frombuffer(raw, np.uint8)
    pos = 0
    nbx = (width + 3) // 4
    nby = (ny + 3) // 4
    planes = {}
    for cname, ptype in chans:
        if ptype != 1:
            dt = _PIX_DTYPE[ptype]
            nbytes = width * ny * dt.itemsize
            if pos + nbytes > len(buf):
                raise B44Error("truncated non-half channel")
            planes[cname] = np.frombuffer(raw, dt, count=width * ny,
                                          offset=pos).reshape(ny, width)
            pos += nbytes
            continue

        nblocks = nbx * nby
        # Block sizes depend on flat-block markers (B44A); walk the stream
        # once to find each block's offset.
        offs = np.empty(nblocks, np.int64)
        flat = np.empty(nblocks, bool)
        p = pos
        for i in range(nblocks):
            if p + 3 > len(buf):
                raise B44Error("truncated B44 stream")
            offs[i] = p
            f = buf[p + 2] == 0xFC
            flat[i] = f
            p += 3 if f else 14
        if p > len(buf):
            raise B44Error("truncated B44 stream")
        pos = p

        s = np.empty((nblocks, 16), np.uint16)
        if (~flat).any():
            idx = np.where(~flat)[0]
            gather = offs[idx][:, None] + np.arange(14)
            s[idx] = _unpack14(buf[gather])
        if flat.any():
            idx = np.where(flat)[0]
            gather = offs[idx][:, None] + np.arange(3)
            s[idx] = _unpack3(buf[gather])

        # [nby, nbx, 4, 4] -> [nby*4, nbx*4], crop to (ny, width).
        grid = s.reshape(nby, nbx, 4, 4).transpose(0, 2, 1, 3)
        plane = grid.reshape(nby * 4, nbx * 4)[:ny, :width]
        planes[cname] = plane

    out = bytearray()
    for line in range(ny):
        for cname, ptype in chans:
            out += planes[cname][line].tobytes()
    return bytes(out)
