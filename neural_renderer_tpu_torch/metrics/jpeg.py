"""Baseline and progressive JPEG decoding, pixel-exact to libjpeg-turbo.

The JAX package reads JPEG images (environment maps, glTF textures,
`compare_images` inputs) through imageio, that is Pillow, that is
libjpeg-turbo with its defaults. This module decodes the same files to the
same bytes with numpy alone:

  * markers: SOF0 / SOF1 (sequential Huffman) and SOF2 (progressive), 8-bit
    samples, 1 or 3 components, any integral sampling factors (4:4:4,
    4:2:2, 4:2:0, 4:4:0 ...), DQT (8- and 16-bit tables, latched per
    component at its first scan as libjpeg does), DHT, DRI and restart
    markers; APPn and COM segments are skipped, except that JFIF / Adobe
    markers and the component ids choose YCbCr or RGB as libjpeg does;
  * entropy decoding of one scan (`_scan_python`, and the same algorithm in
    the host helper `csrc/jpeg_decode.cpp`, compiled at first use by
    `utils/native.py`): sequential blocks, and the progressive DC / AC
    first and refinement scans with their end-of-band runs;
  * libjpeg's integer "islow" IDCT (jidctint.c: 13-bit fixed-point
    constants, DESCALE rounding, the 1024-entry range-limit table),
  * its "fancy" upsampling (jdsample.c: the 3/4 - 1/4 triangle filter with
    its alternating rounding bias, in both directions for 4:2:0, edge
    samples replicated; plain replication where a component is at most two
    samples wide),
  * its fixed-point YCbCr -> RGB tables (jdcolor.c).

A progressive file whose first AC coefficients are not all final after its
last scan would take libjpeg's block smoothing, which is not reproduced: it
raises. So do arithmetic-coded, lossless, hierarchical, 12-bit and
four-component (CMYK / YCCK) files, each naming the variant.

`decode_jpeg` returns what imageio returns: uint8 [H, W] for one component,
uint8 [H, W, 3] for three.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

JPEG_SOI = b"\xff\xd8\xff"

# Zigzag position -> natural (row-major) index, with 16 guard entries so a
# run that overshoots position 63 in a corrupt scan stays in the block.
NATURAL_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
    + [63] * 16, np.int64)

_UNSUPPORTED_SOF = {
    0xC3: "lossless (SOF3)",
    0xC5: "hierarchical (SOF5)", 0xC6: "hierarchical (SOF6)",
    0xC7: "hierarchical (SOF7)",
    0xC9: "arithmetic-coded (SOF9)", 0xCA: "arithmetic-coded (SOF10)",
    0xCB: "arithmetic-coded (SOF11)", 0xCD: "arithmetic-coded (SOF13)",
    0xCE: "arithmetic-coded (SOF14)", 0xCF: "arithmetic-coded (SOF15)",
}


class JpegError(ValueError):
    pass


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "width", "height", "bw", "bh",
                 "alloc_w", "alloc_h", "coef", "qtable", "coef_bits")

    def __init__(self, cid, h, v, tq):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.qtable = None


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# Entropy decoding (the Python path; csrc/jpeg_decode.cpp is the same)
# ---------------------------------------------------------------------------

def _huffman_lut(bits: bytes, vals: bytes, dc: bool) -> list[int]:
    """65,536 entries indexed by the next 16 bits: (length << 8) | symbol,
    0 where no code matches. A DC symbol (a bit count) above 15 is refused,
    as libjpeg refuses it."""
    if dc and any(v > 15 for v in vals):
        raise JpegError("bad Huffman table")
    lut = [0] * 65536
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            if k >= len(vals):
                raise JpegError("bad Huffman table")
            start = code << (16 - length)
            end = (code + 1) << (16 - length)
            if end > 65536:
                raise JpegError("bad Huffman table")
            lut[start:end] = [(length << 8) | vals[k]] * (end - start)
            code += 1
            k += 1
        code <<= 1
    return lut


def _intervals(seg: bytes) -> list[bytes]:
    """The scan's entropy-coded bytes, unstuffed (FF 00 -> FF) and split at
    its restart markers, each interval padded with zero bytes."""
    out, cur = [], bytearray()
    i, n = 0, len(seg)
    while i < n:
        j = seg.find(b"\xff", i)
        if j < 0 or j + 1 >= n:
            cur += seg[i:n if j < 0 else j]
            break
        cur += seg[i:j]
        m = seg[j + 1]
        if m == 0x00:
            cur.append(0xFF)
            i = j + 2
        elif 0xD0 <= m <= 0xD7:
            out.append(bytes(cur) + bytes(8))
            cur = bytearray()
            i = j + 2
        else:            # fill byte before a marker
            i = j + 1
    out.append(bytes(cur) + bytes(8))
    return out


def _scan_blocks(comps, mcus_x, mcus_y):
    """Per MCU of the scan, the (component, block index) pairs it codes, in
    stream order. One component: one block per MCU over the component's
    own block grid; several: each component's h x v blocks per MCU."""
    if len(comps) == 1:
        c = comps[0]
        return [[(0, by * c.alloc_w + bx)] for by in range(c.bh)
                for bx in range(c.bw)]
    mcus = []
    for my in range(mcus_y):
        for mx in range(mcus_x):
            blocks = []
            for ci, c in enumerate(comps):
                for y in range(c.v):
                    for x in range(c.h):
                        blocks.append((ci, (my * c.v + y) * c.alloc_w
                                       + mx * c.h + x))
            mcus.append(blocks)
    return mcus


def _scan_python(seg, comps, dc_luts, ac_luts, mcus_x, mcus_y, ss, se, ah,
                 al, progressive, restart_interval):
    """Decode one scan's coefficients into each component's `coef`
    ([alloc_h * alloc_w * 64] int16, natural order)."""
    order = NATURAL_ORDER.tolist()
    coefs = [memoryview(c.coef.reshape(-1)) for c in comps]
    mcus = _scan_blocks(comps, mcus_x, mcus_y)
    intervals = _intervals(seg)
    per = restart_interval if restart_interval > 0 else len(mcus)
    p1, m1 = 1 << al, -1 << al
    for start in range(0, len(mcus), per):
        k_int = start // per
        if k_int >= len(intervals):
            raise JpegError("scan data ends early (missing restart marker)")
        buf = intervals[k_int]
        limit = (len(buf) - 8) * 8
        pos = 0
        pred = [0] * len(comps)
        eobrun = 0

        def bits(s):
            nonlocal pos
            q = pos >> 3
            v = int.from_bytes(buf[q:q + 4], "big")
            r = (v >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
            pos += s
            return r

        def huff(lut):
            nonlocal pos
            q = pos >> 3
            v = int.from_bytes(buf[q:q + 3], "big")
            e = lut[(v >> (8 - (pos & 7))) & 0xFFFF]
            if e == 0:
                raise JpegError("bad Huffman code")
            pos += e >> 8
            return e & 0xFF

        def extend(r, s):
            return r - (1 << s) + 1 if r < (1 << (s - 1)) else r

        for blocks in mcus[start:start + per]:
            for ci, b in blocks:
                if pos > limit:
                    raise JpegError("scan data ends early")
                co = coefs[ci]
                base = b * 64
                if not progressive:
                    s = huff(dc_luts[ci])
                    if s:
                        s = extend(bits(s), s)
                    pred[ci] += s
                    co[base] = (pred[ci] + 32768) % 65536 - 32768
                    lut = ac_luts[ci]
                    k = 1
                    while k < 64:
                        rs = huff(lut)
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            co[base + order[k]] = extend(bits(s), s)
                        elif r != 15:
                            break
                        else:
                            k += 15
                        k += 1
                elif ss == 0:                       # DC scans
                    if ah == 0:
                        s = huff(dc_luts[ci])
                        if s:
                            s = extend(bits(s), s)
                        pred[ci] += s
                        co[base] = ((pred[ci] << al) + 32768) % 65536 - 32768
                    elif bits(1):
                        co[base] |= p1
                elif ah == 0:                       # AC first scan
                    if eobrun > 0:
                        eobrun -= 1
                        continue
                    lut = ac_luts[ci]
                    k = ss
                    while k <= se:
                        rs = huff(lut)
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            co[base + order[k]] = (
                                (extend(bits(s), s) << al) + 32768) \
                                % 65536 - 32768
                        elif r == 15:
                            k += 15
                        else:
                            eobrun = (1 << r) - 1
                            if r:
                                eobrun += bits(r)
                            break
                        k += 1
                else:                               # AC refinement
                    lut = ac_luts[ci]
                    k = ss
                    if eobrun == 0:
                        while k <= se:
                            rs = huff(lut)
                            r, s = rs >> 4, rs & 15
                            if s:
                                s = p1 if bits(1) else m1
                            elif r != 15:
                                eobrun = 1 << r
                                if r:
                                    eobrun += bits(r)
                                break
                            while k <= se:
                                z = base + order[k]
                                if co[z] != 0:
                                    if bits(1) and (co[z] & p1) == 0:
                                        co[z] += p1 if co[z] >= 0 else m1
                                else:
                                    r -= 1
                                    if r < 0:
                                        break
                                k += 1
                            if s:
                                co[base + order[k]] = s
                            k += 1
                    if eobrun > 0:
                        while k <= se:
                            z = base + order[k]
                            if co[z] != 0 and bits(1) \
                                    and (co[z] & p1) == 0:
                                co[z] += p1 if co[z] >= 0 else m1
                            k += 1
                        eobrun -= 1
        if pos > limit:
            raise JpegError("scan data ends early")


_NATIVE = {}


def _native_lib():
    if "lib" in _NATIVE:
        return _NATIVE["lib"]
    from ..utils.native import ensure_native_lib
    lib = None
    path = ensure_native_lib("jpeg_decode.cpp", flags=("-O2",))
    if path is not None:
        lib = ctypes.CDLL(path)
        lib.jpeg_decode_scan.restype = ctypes.c_int
        lib.jpeg_decode_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32]
    _NATIVE["lib"] = lib
    return lib


_NATIVE_ERRORS = {-1: "bad Huffman code", -2: "scan data ends early",
                  -3: "scan data ends early (missing restart marker)",
                  -4: "bad Huffman table"}


def _scan_native(lib, seg, comps, tables, huff_blob, mcus_x, mcus_y, ss,
                 se, ah, al, progressive, restart_interval):
    """_scan_python's work in csrc/jpeg_decode.cpp. `huff_blob`: eight
    tables (DC 0-3, then AC 0-3) of 16 code counts and 256 symbols."""
    info = np.array([[c.h, c.v, c.alloc_w, c.bw, c.bh, dc, ac]
                     for c, (dc, ac) in zip(comps, tables)], np.int32)
    ptrs = (ctypes.c_void_p * len(comps))(
        *[c.coef.ctypes.data for c in comps])
    rc = lib.jpeg_decode_scan(
        seg, len(seg), len(comps),
        info.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ptrs,
        huff_blob, mcus_x, mcus_y, ss, se, ah, al, int(progressive),
        restart_interval)
    if rc != 0:
        raise JpegError(_NATIVE_ERRORS.get(rc, f"native decoder error {rc}"))


# ---------------------------------------------------------------------------
# Sample reconstruction: libjpeg's islow IDCT, fancy upsampling, colour
# ---------------------------------------------------------------------------

_CONST_BITS, _PASS1_BITS = 13, 2
_F = dict(f0_298631336=2446, f0_390180644=3196, f0_541196100=4433,
          f0_765366865=6270, f0_899976223=7373, f1_175875602=9633,
          f1_501321110=12299, f1_847759065=15137, f1_961570560=16069,
          f2_053119869=16819, f2_562915447=20995, f3_072711026=25172)


def _range_limit_table() -> np.ndarray:
    """jdmaster.c's post-IDCT table: index (x & 1023) of a centred sample."""
    t = np.zeros(1024, np.uint8)
    t[:128] = np.arange(128, 256)
    t[128:512] = 255
    t[896:] = np.arange(0, 128)
    return t


_RANGE_LIMIT = _range_limit_table()


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_1d(x0, x1, x2, x3, x4, x5, x6, x7, shift_bits, f=_F):
    """One pass of jpeg_idct_islow on int64 arrays (x0..x7: the eight
    inputs of a column or row); returns the eight DESCALEd outputs."""
    z1 = (x2 + x6) * f["f0_541196100"]
    tmp2 = z1 + x6 * -f["f1_847759065"]
    tmp3 = z1 + x2 * f["f0_765366865"]
    tmp0 = (x0 + x4) << _CONST_BITS
    tmp1 = (x0 - x4) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x7, x5, x3, x1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["f1_175875602"]
    t0 = t0 * f["f0_298631336"]
    t1 = t1 * f["f2_053119869"]
    t2 = t2 * f["f3_072711026"]
    t3 = t3 * f["f1_501321110"]
    z1 = z1 * -f["f0_899976223"]
    z2 = z2 * -f["f2_562915447"]
    z3 = z3 * -f["f1_961570560"] + z5
    z4 = z4 * -f["f0_390180644"] + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    return (_descale(tmp10 + t3, shift_bits), _descale(tmp11 + t2, shift_bits),
            _descale(tmp12 + t1, shift_bits), _descale(tmp13 + t0, shift_bits),
            _descale(tmp13 - t0, shift_bits), _descale(tmp12 - t1, shift_bits),
            _descale(tmp11 - t2, shift_bits), _descale(tmp10 - t3, shift_bits))


def idct_islow(coef: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """[N, 64] int16 coefficients (natural order) and their [64]
    quantisation table -> [N, 8, 8] uint8 samples, as jpeg_idct_islow."""
    x = (coef.astype(np.int64) * qtable.astype(np.int64)).reshape(-1, 8, 8)
    # Pass 1: columns (inputs down axis 1), outputs scaled by 2^PASS1_BITS.
    ws = np.stack(_idct_1d(*[x[:, k, :] for k in range(8)],
                           _CONST_BITS - _PASS1_BITS), axis=1)
    # Pass 2: rows.
    out = np.stack(_idct_1d(*[ws[:, :, k] for k in range(8)],
                            _CONST_BITS + _PASS1_BITS + 3), axis=2)
    return _RANGE_LIMIT[out & 1023]


def _fancy_h2(p: np.ndarray) -> np.ndarray:
    """h2v1_fancy_upsample on [rows, w] int: 2w columns."""
    left = np.concatenate([p[:, :1], p[:, :-1]], axis=1)
    right = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
    out = np.empty((p.shape[0], 2 * p.shape[1]), np.int64)
    out[:, 0::2] = (3 * p + left + 1) >> 2
    out[:, 1::2] = (3 * p + right + 2) >> 2
    return out


def _fancy_v2(p: np.ndarray) -> np.ndarray:
    """h1v2_fancy_upsample on [h, cols] int: 2h rows."""
    up = np.concatenate([p[:1], p[:-1]], axis=0)
    down = np.concatenate([p[1:], p[-1:]], axis=0)
    out = np.empty((2 * p.shape[0], p.shape[1]), np.int64)
    out[0::2] = (3 * p + up + 1) >> 2
    out[1::2] = (3 * p + down + 2) >> 2
    return out


def _fancy_h2v2(p: np.ndarray) -> np.ndarray:
    """h2v2_fancy_upsample on [h, w] int: [2h, 2w]."""
    up = np.concatenate([p[:1], p[:-1]], axis=0)
    down = np.concatenate([p[1:], p[-1:]], axis=0)
    out = np.empty((2 * p.shape[0], 2 * p.shape[1]), np.int64)
    for r0, near in ((0, up), (1, down)):
        cs = 3 * p + near
        left = np.concatenate([cs[:, :1], cs[:, :-1]], axis=1)
        right = np.concatenate([cs[:, 1:], cs[:, -1:]], axis=1)
        out[r0::2, 0::2] = (3 * cs + left + 8) >> 4
        out[r0::2, 1::2] = (3 * cs + right + 7) >> 4
    return out


def _upsample(plane: np.ndarray, c: _Component, hmax: int,
              vmax: int) -> np.ndarray:
    """A component's [height, width] samples -> full resolution, as
    jdsample.c picks its method (fancy where libjpeg uses it)."""
    p = plane.astype(np.int64)
    hx, vx = hmax // c.h, vmax // c.v
    if hx == 1 and vx == 1:
        return p
    if hx == 2 and vx == 1:
        return _fancy_h2(p) if c.width > 2 else np.repeat(p, 2, axis=1)
    if hx == 1 and vx == 2:
        return _fancy_v2(p)
    if hx == 2 and vx == 2 and c.width > 2:
        return _fancy_h2v2(p)
    return np.repeat(np.repeat(p, vx, axis=0), hx, axis=1)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c ycc_rgb_convert with its SCALEBITS=16 tables."""
    one_half = 1 << 15

    def fix(v):
        return int(v * 65536 + 0.5)

    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Markers
# ---------------------------------------------------------------------------

def decode_jpeg(data: bytes, native: bool | None = None) -> np.ndarray:
    """JPEG bytes -> uint8 [H, W] (one component) or [H, W, 3], equal to
    libjpeg-turbo's decode with its defaults (what Pillow gives imageio).
    native: None uses csrc/jpeg_decode.cpp when it builds and the Python
    entropy decoder otherwise; True requires the helper; False runs Python.
    Raises JpegError for anything it cannot decode, corrupt data included.
    """
    try:
        return _decode_jpeg(bytes(data), native)
    except JpegError:
        raise
    except (struct.error, IndexError, KeyError, ValueError,
            OverflowError) as e:
        raise JpegError(f"corrupt JPEG: {type(e).__name__}: {e}") from e


# Pillow refuses images above twice its MAX_IMAGE_PIXELS (a decompression
# bomb); so does this decoder, before it allocates the coefficients.
_MAX_PIXELS = 2 * 89_478_485


def _decode_jpeg(data: bytes, native: bool | None) -> np.ndarray:
    if data[:2] != b"\xff\xd8":
        raise JpegError("not a JPEG file (no SOI marker)")
    lib = None
    if native is not False:
        lib = _native_lib()
        if lib is None and native:
            raise JpegError("the native JPEG decoder does not build here")
    qtables: dict[int, np.ndarray] = {}
    dc_tabs: dict[int, tuple] = {}
    ac_tabs: dict[int, tuple] = {}
    comps: list[_Component] = []
    frame = None
    restart_interval = 0
    jfif = adobe = False
    adobe_transform = None
    pos, n = 2, len(data)
    while True:
        while pos < n and data[pos] == 0xFF and pos + 1 < n \
                and data[pos + 1] == 0xFF:
            pos += 1                              # fill bytes
        if pos + 2 > n or data[pos] != 0xFF:
            if frame is not None and frame.get("scans"):
                break                             # no EOI: accept, as libjpeg
            raise JpegError("bad or missing JPEG marker")
        m = data[pos + 1]
        pos += 2
        if m == 0xD9:
            break
        if 0xD0 <= m <= 0xD7 or m == 0x01:
            continue
        if pos + 2 > n:
            raise JpegError("truncated JPEG segment")
        seg_len = struct.unpack_from(">H", data, pos)[0]
        body = data[pos + 2:pos + seg_len]
        if seg_len < 2 or len(body) != seg_len - 2:
            raise JpegError("truncated JPEG segment")
        pos += seg_len
        if m in _UNSUPPORTED_SOF:
            raise JpegError(f"{_UNSUPPORTED_SOF[m]} JPEG is not supported")
        if m == 0xCC:
            raise JpegError("arithmetic-coded (DAC) JPEG is not supported")
        if m in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                raise JpegError("more than one frame")
            prec, height, width, nf = struct.unpack_from(">BHHB", body)
            if prec != 8:
                raise JpegError(f"{prec}-bit JPEG is not supported "
                                "(8-bit only)")
            if nf == 4:
                raise JpegError("four-component (CMYK / YCCK) JPEG is not "
                                "supported")
            if nf not in (1, 3):
                raise JpegError(f"{nf}-component JPEG is not supported")
            if height == 0 or width == 0:
                raise JpegError("JPEG with a zero or DNL-defined size is "
                                "not supported")
            if width * height > _MAX_PIXELS:
                raise JpegError(f"JPEG of {width}x{height} pixels exceeds "
                                f"the {_MAX_PIXELS}-pixel limit")
            for i in range(nf):
                cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
                h, v = hv >> 4, hv & 15
                if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
                    raise JpegError("bad component sampling or table")
                comps.append(_Component(cid, h, v, tq))
            frame = _frame(comps, width, height, progressive=m == 0xC2)
        elif m == 0xC4:
            i = 0
            while i < len(body):
                tc_th = body[i]
                counts = body[i + 1:i + 17]
                total = sum(counts)
                vals = body[i + 17:i + 17 + total]
                if len(counts) != 16 or len(vals) != total or total > 256 \
                        or (tc_th & 15) > 3 or (tc_th >> 4) > 1:
                    raise JpegError("bad DHT segment")
                (ac_tabs if tc_th >> 4 else dc_tabs)[tc_th & 15] = (
                    bytes(counts), bytes(vals))
                i += 17 + total
        elif m == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                size = 128 if pq else 64
                raw = body[i + 1:i + 1 + size]
                if len(raw) != size or tq > 3:
                    raise JpegError("bad DQT segment")
                vals = np.frombuffer(raw, ">u2" if pq else np.uint8)
                q = np.zeros(64, np.int64)
                q[NATURAL_ORDER[:64]] = vals
                qtables[tq] = q
                i += 1 + size
        elif m == 0xDD:
            restart_interval = struct.unpack_from(">H", body)[0]
        elif m == 0xDA:
            if frame is None:
                raise JpegError("SOS before SOF")
            pos = _scan(data, pos, body, frame, comps, qtables, dc_tabs,
                        ac_tabs, restart_interval, lib)
        elif m == 0xE0 and body[:5] == b"JFIF\0" and len(body) >= 14:
            jfif = True
        elif m == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe, adobe_transform = True, body[11]
    if frame is None or not frame["scans"]:
        raise JpegError("JPEG without image data")
    return _finish(frame, comps, jfif, adobe, adobe_transform)


def _frame(comps, width, height, progressive):
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    mcus_x = _ceil_div(width, 8 * hmax)
    mcus_y = _ceil_div(height, 8 * vmax)
    for c in comps:
        c.width = _ceil_div(width * c.h, hmax)
        c.height = _ceil_div(height * c.v, vmax)
        c.bw, c.bh = _ceil_div(c.width, 8), _ceil_div(c.height, 8)
        c.alloc_w, c.alloc_h = mcus_x * c.h, mcus_y * c.v
        c.coef = np.zeros((c.alloc_h * c.alloc_w, 64), np.int16)
        c.coef_bits = np.full(64, -1, np.int64)
    return dict(width=width, height=height, hmax=hmax, vmax=vmax,
                mcus_x=mcus_x, mcus_y=mcus_y, progressive=progressive,
                scans=0)


def _entropy_end(data: bytes, pos: int) -> int:
    """Index of the marker that ends the entropy-coded segment at `pos`."""
    n = len(data)
    while True:
        j = data.find(b"\xff", pos)
        if j < 0 or j + 1 >= n:
            return n
        m = data[j + 1]
        if m == 0x00 or 0xD0 <= m <= 0xD7 or m == 0xFF:
            pos = j + 1 if m == 0xFF else j + 2
            continue
        return j


def _scan(data, pos, body, frame, comps, qtables, dc_tabs, ac_tabs,
          restart_interval, lib) -> int:
    """Decode the scan whose SOS body is `body`; its entropy-coded data
    starts at `pos`. Returns the position of the marker after it."""
    ns = body[0]
    if not 1 <= ns <= 4 or len(body) != 4 + 2 * ns:
        raise JpegError("bad SOS segment")
    by_id = {c.cid: c for c in comps}
    scomps, tables = [], []
    for i in range(ns):
        cid, tt = body[1 + 2 * i], body[2 + 2 * i]
        if cid not in by_id:
            raise JpegError("scan names an unknown component")
        scomps.append(by_id[cid])
        tables.append((tt >> 4, tt & 15))
    ss, se, ahal = body[1 + 2 * ns:4 + 2 * ns]
    ah, al = ahal >> 4, ahal & 15
    progressive = frame["progressive"]
    if progressive:
        if ss > se or se > 63 or al > 13 or (ss == 0 and se != 0) \
                or (ss > 0 and ns != 1):
            raise JpegError("bad progressive scan parameters")
    elif ss != 0 or se != 63 or ah or al:
        raise JpegError("bad sequential scan parameters")
    if ns > 1 and sum(c.h * c.v for c in scomps) > 10:
        raise JpegError("too many blocks per MCU")
    for c in scomps:
        if c.qtable is None:            # latched at the first scan
            if c.tq not in qtables:
                raise JpegError("scan before its quantisation table")
            c.qtable = qtables[c.tq].copy()
        if ss == 0:
            c.coef_bits[0] = al
        if se > 0:
            c.coef_bits[max(ss, 1):se + 1] = al
    end = _entropy_end(data, pos)
    seg = data[pos:end]
    need_dc = not progressive or (ss == 0 and ah == 0)
    need_ac = not progressive or ss > 0
    for dc, ac in tables:
        if (need_dc and dc not in dc_tabs) or (need_ac and ac not in ac_tabs):
            raise JpegError("scan uses an undefined Huffman table")
    if lib is not None:
        blob = bytearray(8 * 272)
        for slot, tabs in ((0, dc_tabs), (4, ac_tabs)):
            for t, (counts, vals) in tabs.items():
                o = (slot + t) * 272
                blob[o:o + 16] = counts
                blob[o + 16:o + 16 + len(vals)] = vals
        _scan_native(lib, seg, scomps, tables, bytes(blob), frame["mcus_x"],
                     frame["mcus_y"], ss, se, ah, al, progressive,
                     restart_interval)
    else:
        luts = {}

        def lut(kind, t):
            key = (kind, t)
            if key not in luts:
                tabs = dc_tabs if kind == 0 else ac_tabs
                luts[key] = (_huffman_lut(*tabs[t], dc=kind == 0)
                             if t in tabs else None)
            return luts[key]

        _scan_python(seg, scomps, [lut(0, dc) for dc, _ in tables],
                     [lut(1, ac) for _, ac in tables], frame["mcus_x"],
                     frame["mcus_y"], ss, se, ah, al, progressive,
                     restart_interval)
    frame["scans"] += 1
    return end


def _finish(frame, comps, jfif, adobe, adobe_transform) -> np.ndarray:
    if frame["progressive"] and all(c.coef_bits[0] >= 0 for c in comps) \
            and any((c.coef_bits[1:10] != 0).any() for c in comps):
        raise JpegError(
            "progressive JPEG whose first AC coefficients are not final "
            "after its last scan (libjpeg's block smoothing is not "
            "supported)")
    width, height = frame["width"], frame["height"]
    planes = []
    for c in comps:
        if c.qtable is None:
            raise JpegError("a component has no scan")
        blocks = idct_islow(c.coef, c.qtable)
        plane = blocks.reshape(c.alloc_h, c.alloc_w, 8, 8).transpose(
            0, 2, 1, 3).reshape(c.alloc_h * 8, c.alloc_w * 8)
        plane = plane[:c.height, :c.width]
        planes.append(_upsample(plane, c, frame["hmax"],
                                frame["vmax"])[:height, :width])
    if len(comps) == 1:
        return np.ascontiguousarray(planes[0].astype(np.uint8))
    rgb = False
    if jfif:
        rgb = False
    elif adobe:
        rgb = adobe_transform == 0
    else:
        rgb = [c.cid for c in comps] == [82, 71, 66]
    if rgb:
        return np.ascontiguousarray(np.stack(planes, axis=-1).astype(
            np.uint8))
    return _ycc_to_rgb(*planes)
