"""OpenEXR DWAA / DWAB decoder.

Port (a copy: the module imports nothing of JAX) of
`neural_renderer_tpu/scene/exr_dwa.py`; numpy + zlib, host-side asset I/O.

DWA is a lossy DCT codec over 8x8 blocks of half data in a perceptually
nonlinear space, with three per-channel schemes chosen by suffix rules
embedded in every compressed block (version 2):

  LOSSY_DCT  R/G/B-style channels; RGB triples go through a BT.709 CSC and
             share a channel set. AC coefficients are zigzag + zero-run
             coded and entropy-packed with the same static Huffman coder
             PIZ uses; DC coefficients are deflate-packed behind the ImfZip
             predictor/interleave transform.
  RLE        flat channels (alpha): byte-planar split, EXR RLE, deflate.
  UNKNOWN    everything else: plain deflate of the planar channel data.

Layout (reverse-engineered from OpenEXR 3.1 output and validated against
it — scripts/make_dwa_fixture.py):

  [11 x uint64] version, unknownUncompressedSize, unknownCompressedSize,
                acCompressedSize, dcCompressedSize, rleCompressedSize,
                rleUncompressedSize, rleRawSize, totalAcUncompressedCount,
                totalDcUncompressedCount, acCompression
  [uint16 ruleSize][rules: cstr suffix, flags byte, type byte]   (version 2)
  [unknown bytes][AC bytes][DC bytes][RLE bytes]

flags byte: hi nibble = cscIdx + 1 (0 = none), bits 2-3 = scheme
(0 UNKNOWN, 1 LOSSY_DCT, 2 RLE), bit 0 = caseSensitive. type byte =
EXR pixel type (0 UINT, 1 HALF, 2 FLOAT).

The nonlinear transfer ("toLinear" on decode) is gamma-2.2 below 1.0 with a
log continuation above: x <= 1 -> sign(x)*|x|^2.2, else sign(x)*e^{2.2(|x|-1)}.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .exr import _interleave, _reconstruct, _rle_decode
from .exr_piz import huf_uncompress

_PIX_SIZE = {0: 4, 1: 2, 2: 4}

UNKNOWN, LOSSY_DCT, RLE = 0, 1, 2


class DwaError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------

_ZIGZAG = None  # scan position -> block index (row*8 + col)
_TO_LINEAR = None  # half bits -> half bits
_IDCT_BASIS = None


def _zigzag_order() -> np.ndarray:
    global _ZIGZAG
    if _ZIGZAG is None:
        order = np.empty(64, np.int32)
        r = c = 0
        for i in range(64):
            order[i] = r * 8 + c
            if (r + c) % 2 == 0:  # moving up-right
                if c == 7:
                    r += 1
                elif r == 0:
                    c += 1
                else:
                    r -= 1
                    c += 1
            else:  # moving down-left
                if r == 7:
                    c += 1
                elif c == 0:
                    r += 1
                else:
                    r += 1
                    c -= 1
        _ZIGZAG = order
    return _ZIGZAG


def _to_linear_table() -> np.ndarray:
    """65536-entry half-bits -> half-bits inverse nonlinear transfer."""
    global _TO_LINEAR
    if _TO_LINEAR is None:
        bits = np.arange(65536, dtype=np.uint16)
        x = bits.view(np.float16).astype(np.float32)
        sign = np.sign(x)
        a = np.abs(x)
        with np.errstate(over="ignore", invalid="ignore"):
            y = np.where(a <= 1.0, a ** 2.2, np.exp(2.2 * (a - 1.0)))
            y = (sign * y).astype(np.float32)
            y[~np.isfinite(x)] = x[~np.isfinite(x)]
            _TO_LINEAR = y.astype(np.float16).view(np.uint16)
    return _TO_LINEAR


def _idct8x8(blocks: np.ndarray) -> np.ndarray:
    """JPEG IDCT of [..., 8, 8] blocks, replicating OpenEXR's even/odd
    butterfly (dctInverse8x8, ImfDwaCompressorSimd.h) op-for-op in float32 —
    including its truncated 3.14159 pi — so decoded halfs round identically
    to the library's."""
    pi = np.float32(3.14159)
    ka = np.float32(0.5) * np.cos(pi / np.float32(4.0), dtype=np.float32)
    kb = np.float32(0.5) * np.cos(pi / np.float32(16.0), dtype=np.float32)
    kc = np.float32(0.5) * np.cos(pi / np.float32(8.0), dtype=np.float32)
    kd = np.float32(0.5) * np.cos(np.float32(3.0) * pi / np.float32(16.0),
                                  dtype=np.float32)
    ke = np.float32(0.5) * np.cos(np.float32(5.0) * pi / np.float32(16.0),
                                  dtype=np.float32)
    kf = np.float32(0.5) * np.cos(np.float32(3.0) * pi / np.float32(8.0),
                                  dtype=np.float32)
    kg = np.float32(0.5) * np.cos(np.float32(7.0) * pi / np.float32(16.0),
                                  dtype=np.float32)

    def one_pass(x):
        # x: [..., 8, n] — butterfly along axis -2 (the "row" being
        # transformed), vectorized over everything else.
        r0, r1, r2, r3 = x[..., 0, :], x[..., 1, :], x[..., 2, :], x[..., 3, :]
        r4, r5, r6, r7 = x[..., 4, :], x[..., 5, :], x[..., 6, :], x[..., 7, :]
        a0 = kc * r2
        a1 = kf * r2
        a2 = kc * r6
        a3 = kf * r6
        b0 = kb * r1 + kd * r3 + ke * r5 + kg * r7
        b1 = kd * r1 - kg * r3 - kb * r5 - ke * r7
        b2 = ke * r1 - kb * r3 + kg * r5 + kd * r7
        b3 = kg * r1 - ke * r3 + kd * r5 - kb * r7
        t0 = ka * (r0 + r4)
        t3 = ka * (r0 - r4)
        t1 = a0 + a3
        t2 = a1 - a2
        g0 = t0 + t1
        g1 = t3 + t2
        g2 = t3 - t2
        g3 = t0 - t1
        return np.stack([g0 + b0, g1 + b1, g2 + b2, g3 + b3,
                         g3 - b3, g2 - b2, g1 - b1, g0 - b0], axis=-2)

    # first pass row-wise (transform along the last axis), then column-wise.
    y = one_pass(blocks.swapaxes(-1, -2)).swapaxes(-1, -2)
    return one_pass(y)


# ---------------------------------------------------------------------------
# Channel classification
# ---------------------------------------------------------------------------

class _Rule:
    __slots__ = ("suffix", "scheme", "ptype", "csc_idx", "case_sensitive")

    def __init__(self, suffix, scheme, ptype, csc_idx, case_sensitive):
        self.suffix = suffix
        self.scheme = scheme
        self.ptype = ptype
        self.csc_idx = csc_idx
        self.case_sensitive = case_sensitive

    def matches(self, suffix: str, ptype: int) -> bool:
        if self.ptype != ptype:
            return False
        if self.case_sensitive:
            return suffix == self.suffix
        return suffix.lower() == self.suffix.lower()


def _default_rules() -> list[_Rule]:
    # ImfDwaCompressor's default classifier (version < 2 files).
    rules = []
    for suffix, csc in (("r", 0), ("g", 1), ("b", 2)):
        for pt in (1, 2):
            rules.append(_Rule(suffix, LOSSY_DCT, pt, csc, False))
    for suffix in ("y", "by", "ry"):
        for pt in (1, 2):
            rules.append(_Rule(suffix, LOSSY_DCT, pt, -1, False))
    for pt in (0, 1, 2):
        rules.append(_Rule("a", RLE, pt, -1, False))
    return rules


def _parse_rules(buf: bytes) -> list[_Rule]:
    rules = []
    q = 0
    while q < len(buf):
        end = buf.index(b"\0", q)
        suffix = buf[q:end].decode("latin-1")
        q = end + 1
        if q + 2 > len(buf):
            raise DwaError("truncated channel rule")
        flags, ptype = buf[q], buf[q + 1]
        q += 2
        rules.append(_Rule(suffix, (flags >> 2) & 3, ptype,
                           ((flags >> 4) & 15) - 1, bool(flags & 1)))
    return rules


def _classify(chans, rules):
    """Per channel: (scheme, csc_idx). CSC sets group channels sharing a
    prefix whose rules carry cscIdx 0/1/2; only complete R,G,B triples CSC
    together (ImfDwaCompressor::classifyChannels)."""
    schemes = []
    for name, ptype in chans:
        base = name.rsplit(".", 1)[-1]
        scheme, csc = UNKNOWN, -1
        for r in rules:
            if r.matches(base, ptype):
                scheme, csc = r.scheme, r.csc_idx
                break
        schemes.append([scheme, csc])

    # group csc candidates by prefix
    sets: dict[str, list[int | None]] = {}
    for i, (name, _) in enumerate(chans):
        if schemes[i][1] >= 0:
            prefix = name.rsplit(".", 1)[0] if "." in name else ""
            sets.setdefault(prefix, [None, None, None])[schemes[i][1]] = i
    csc_sets = []
    for prefix in sorted(sets):
        trio = sets[prefix]
        if all(v is not None for v in trio):
            csc_sets.append(trio)
        else:
            for i in trio:
                if i is not None:
                    schemes[i][1] = -1  # incomplete: solo lossy DCT
    in_set = {i for trio in csc_sets for i in trio}
    for i in range(len(chans)):
        if schemes[i][1] >= 0 and i not in in_set:
            schemes[i][1] = -1
    return schemes, csc_sets


# ---------------------------------------------------------------------------
# Lossy DCT reconstruction
# ---------------------------------------------------------------------------

def _unrle_ac(ac: np.ndarray, pos: int, nblocks: int, ncomp: int):
    """Expand the zero-run token stream into [nblocks, ncomp, 64] half-bit
    coefficient blocks (zigzag order). Token 0xff00 = rest of block is zero;
    0xffXX = skip XX zeros; else literal half bits. Returns (blocks, pos).

    The stream covers zigzag indices 1..63 only — the DC coefficient lives
    in its own deflate stream. Tokens are stored per component, interleaved
    block-by-block."""
    out = np.zeros((nblocks, ncomp, 64), np.uint16)
    n = ac.size
    for b in range(nblocks):
        for c in range(ncomp):
            idx = 1
            while idx < 64:
                if pos >= n:
                    raise DwaError("AC stream underrun")
                val = int(ac[pos])
                pos += 1
                if val == 0xFF00:
                    break
                if (val >> 8) == 0xFF:
                    idx += val & 0xFF
                else:
                    out[b, c, idx] = val
                    idx += 1
    return out, pos


def _csc709_inverse(comp: np.ndarray) -> np.ndarray:
    """BT.709 YCbCr -> RGB across component axis 0 (csc709Inverse,
    ImfDwaCompressorSimd.h)."""
    y, cb, cr = comp[0], comp[1], comp[2]
    f = np.float32
    r = y + f(1.5747) * cr
    g = y - f(0.1873) * cb - f(0.4682) * cr
    b = y + f(1.8556) * cb
    return np.stack([r, g, b])


def _decode_dct_set(comp_idx, chans, ac, ac_pos, dc, dc_pos, width, ny,
                    planes, apply_csc):
    """Reconstruct one channel set (1 or 3 components) into planes[i]
    ([ny, width] float32 in the CODED half space, before toLinear)."""
    ncomp = len(comp_idx)
    bx = (width + 7) // 8
    by = (ny + 7) // 8
    nblocks = bx * by
    zig = _zigzag_order()

    blocks, ac_pos = _unrle_ac(ac, ac_pos, nblocks, ncomp)
    # DC components live in their own stream: per component, nblocks values,
    # components contiguous (currDcComp[c] = currDcComp[c-1] + nblocks).
    if dc_pos + ncomp * nblocks > dc.size:
        raise DwaError("DC stream underrun")
    dcv = dc[dc_pos:dc_pos + ncomp * nblocks].reshape(ncomp, nblocks)
    dc_pos += ncomp * nblocks
    blocks[:, :, 0] = dcv.T

    # unzigzag -> [nblocks, ncomp, 8, 8] floats, IDCT via the basis matrix.
    co = np.zeros((nblocks, ncomp, 64), np.float32)
    co[:, :, zig] = blocks.view(np.float16).astype(np.float32)
    pix = _idct8x8(co.reshape(nblocks, ncomp, 8, 8))
    if apply_csc:
        pix = _csc709_inverse(pix.transpose(1, 0, 2, 3)).transpose(1, 0, 2, 3)

    # reassemble blocks -> [ncomp, by*8, bx*8], crop to [ny, width]
    img = pix.reshape(by, bx, ncomp, 8, 8).transpose(2, 0, 3, 1, 4)
    img = img.reshape(ncomp, by * 8, bx * 8)[:, :ny, :width]
    for c, i in enumerate(comp_idx):
        planes[i] = img[c]
    return ac_pos, dc_pos


# ---------------------------------------------------------------------------
# Block decode
# ---------------------------------------------------------------------------

def dwa_uncompress_block(raw: bytes, chans, width: int, ny: int) -> bytes:
    """Decode one DWAA/DWAB chunk to scanline-interleaved planar rows (the
    same output contract as piz_uncompress_block)."""
    if len(raw) < 88:
        raise DwaError("truncated DWA header")
    (version, unk_unc, unk_comp, ac_comp, dc_comp, rle_comp, rle_unc,
     rle_raw, ac_count, dc_count, ac_compression) = struct.unpack_from(
        "<11Q", raw, 0)
    pos = 88
    if version >= 2:
        if pos + 2 > len(raw):
            raise DwaError("truncated DWA rules")
        rule_size = struct.unpack_from("<H", raw, pos)[0]
        if rule_size < 2 or pos + rule_size > len(raw):
            raise DwaError("bad DWA rule size")
        rules = _parse_rules(raw[pos + 2:pos + rule_size])
        pos += rule_size
    else:
        rules = _default_rules()

    for sz in (unk_comp, ac_comp, dc_comp, rle_comp):
        if sz > len(raw):
            raise DwaError("DWA segment overruns block")
    if pos + unk_comp + ac_comp + dc_comp + rle_comp > len(raw):
        raise DwaError("DWA segments overrun block")
    unk_buf = raw[pos:pos + unk_comp]
    pos += unk_comp
    ac_buf = raw[pos:pos + ac_comp]
    pos += ac_comp
    dc_buf = raw[pos:pos + dc_comp]
    pos += dc_comp
    rle_buf = raw[pos:pos + rle_comp]

    schemes, csc_sets = _classify(chans, rules)

    unknown = zlib.decompress(unk_buf) if unk_comp else b""
    if len(unknown) != unk_unc:
        if unk_comp:
            raise DwaError("unknown-channel data size mismatch")
    if ac_comp:
        if ac_compression == 0:  # STATIC_HUFFMAN (the PIZ coder)
            ac = huf_uncompress(ac_buf, int(ac_count))
        elif ac_compression == 1:  # DEFLATE
            ac = np.frombuffer(zlib.decompress(ac_buf), "<u2")
            if ac.size != ac_count:
                raise DwaError("AC deflate count mismatch")
        else:
            raise DwaError(f"unknown AC compression {ac_compression}")
    else:
        ac = np.zeros(0, np.uint16)
    if dc_comp:
        dc = np.frombuffer(
            _interleave(_reconstruct(zlib.decompress(dc_buf))), "<u2")
        if dc.size != dc_count:
            raise DwaError("DC count mismatch")
    else:
        dc = np.zeros(0, np.uint16)
    if rle_comp:
        rle_bytes = _rle_decode(zlib.decompress(rle_buf), int(rle_raw))
    else:
        rle_bytes = b""

    # --- reconstruct planes ------------------------------------------------
    nch = len(chans)
    planes: list = [None] * nch
    ac_pos = dc_pos = 0
    done = [False] * nch

    # CSC triples first, then solo DCT channels in channel order — the
    # stream consumption order of ImfDwaCompressor::compress.
    for trio in csc_sets:
        ac_pos, dc_pos = _decode_dct_set(trio, chans, ac, ac_pos, dc, dc_pos,
                                         width, ny, planes, apply_csc=True)
        for i in trio:
            done[i] = True
    for i in range(nch):
        if schemes[i][0] == LOSSY_DCT and not done[i]:
            ac_pos, dc_pos = _decode_dct_set([i], chans, ac, ac_pos, dc,
                                             dc_pos, width, ny, planes,
                                             apply_csc=False)
            done[i] = True

    to_linear = _to_linear_table()
    out_rows = []
    rle_off = 0
    unk_off = 0
    # RLE channels: byte-planar across the channel's whole chunk
    # (all byte-0 planes, then byte-1, per channel in order).
    rle_data = {}
    for i, (name, ptype) in enumerate(chans):
        if schemes[i][0] == RLE:
            size = _PIX_SIZE[ptype]
            n = width * ny
            if rle_off + n * size > len(rle_bytes):
                raise DwaError("RLE channel data underrun")
            planar = np.frombuffer(rle_bytes, np.uint8, count=n * size,
                                   offset=rle_off).reshape(size, n)
            rle_off += n * size
            rle_data[i] = planar.T.reshape(ny, width * size)
        elif schemes[i][0] == UNKNOWN:
            size = _PIX_SIZE[ptype]
            n = width * ny * size
            if unk_off + n > len(unknown):
                raise DwaError("unknown channel data underrun")
            rle_data[i] = np.frombuffer(unknown, np.uint8, count=n,
                                        offset=unk_off).reshape(ny,
                                                                width * size)
            unk_off += n

    for i, (name, ptype) in enumerate(chans):
        if schemes[i][0] != LOSSY_DCT:
            continue
        # float -> half bits -> toLinear lookup; FLOAT channels widen after.
        hbits = planes[i].astype(np.float16).view(np.uint16)
        lin = to_linear[hbits]
        if ptype == 1:
            planes[i] = lin
        elif ptype == 2:
            planes[i] = lin.view(np.float16).astype(np.float32)
        else:
            raise DwaError("UINT lossy-DCT channel unsupported")

    for yrow in range(ny):
        for i, (name, ptype) in enumerate(chans):
            if schemes[i][0] == LOSSY_DCT:
                out_rows.append(planes[i][yrow].tobytes())
            else:
                out_rows.append(rle_data[i][yrow].tobytes())
    return b"".join(out_rows)
