"""PIZ and PXR24 codecs of the OpenEXR reader and writer.

Port (a copy: the module imports nothing of JAX) of
`neural_renderer_tpu/scene/exr_piz.py`, written from the OpenEXR format
specification (ImfPizCompressor / ImfHuf / ImfWav / ImfPxr24Compressor):

  * the PIZ pipeline: value bitmap + LUT, the 2D integer wavelet
    (wdec14/wdec16, vectorized over numpy strided views), and the canonical
    Huffman coder with its run-length escape symbol;
  * PXR24: zlib over per-scanline per-channel delta-coded byte planes
    (floats truncated to 24 bits, lossy by design);
  * the encode direction for PIZ, used by `scene/exr_write.py`.

Host-side asset I/O in numpy; no device code.
"""

from __future__ import annotations

import struct

import numpy as np

USHORT_RANGE = 1 << 16
BITMAP_SIZE = USHORT_RANGE >> 3

HUF_ENCBITS = 16
HUF_DECBITS = 14
HUF_ENCSIZE = (1 << HUF_ENCBITS) + 1
HUF_DECSIZE = 1 << HUF_DECBITS
HUF_DECMASK = HUF_DECSIZE - 1

SHORT_ZEROCODE_RUN = 59
LONG_ZEROCODE_RUN = 63
SHORTEST_LONG_RUN = 2 + LONG_ZEROCODE_RUN - SHORT_ZEROCODE_RUN  # 6
LONGEST_LONG_RUN = 255 + SHORTEST_LONG_RUN

_NBITS = 16
_A_OFFSET = 1 << (_NBITS - 1)
_M_OFFSET = 1 << (_NBITS - 1)
_MOD_MASK = (1 << _NBITS) - 1


class PizError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Bitmap / LUT
# ---------------------------------------------------------------------------

def bitmap_from_data(data: np.ndarray):
    """Presence bitmap over u16 values (value 0 is never stored)."""
    bitmap = np.zeros(BITMAP_SIZE, np.uint8)
    present = np.zeros(USHORT_RANGE, bool)
    present[data] = True
    present[0] = False
    idx = np.nonzero(present)[0]
    np.bitwise_or.at(bitmap, idx >> 3, (1 << (idx & 7)).astype(np.uint8))
    nz = np.nonzero(bitmap)[0]
    if nz.size == 0:
        return bitmap, BITMAP_SIZE - 1, 0  # min > max: empty range
    return bitmap, int(nz[0]), int(nz[-1])


def forward_lut_from_bitmap(bitmap: np.ndarray):
    bits = np.unpackbits(bitmap, bitorder="little")
    present = bits.astype(bool)
    present[0] = True
    lut = np.zeros(USHORT_RANGE, np.uint16)
    k = np.cumsum(present) - 1
    lut[present] = k[present]
    return lut, int(k[-1])  # maxValue


def reverse_lut_from_bitmap(bitmap: np.ndarray):
    bits = np.unpackbits(bitmap, bitorder="little")
    present = bits.astype(bool)
    present[0] = True
    vals = np.nonzero(present)[0].astype(np.uint16)
    lut = np.zeros(USHORT_RANGE, np.uint16)
    lut[:vals.size] = vals
    return lut, int(vals.size - 1)  # maxValue


# ---------------------------------------------------------------------------
# 2D wavelet (ImfWav semantics, vectorized per level)
# ---------------------------------------------------------------------------

def _wdec14(l, h):
    ls = l.astype(np.int16).astype(np.int32)
    hi = h.astype(np.int16).astype(np.int32)
    ai = ls + (hi & 1) + (hi >> 1)
    a = ai.astype(np.int16)
    b = (a.astype(np.int32) - hi).astype(np.int16)
    return a.astype(np.uint16), b.astype(np.uint16)


def _wenc14(a, b, _=None):
    as_ = a.astype(np.int16).astype(np.int32)
    bs = b.astype(np.int16).astype(np.int32)
    ms = (as_ + bs) >> 1
    ds = as_ - bs
    return ms.astype(np.uint16), ds.astype(np.uint16)


def _wdec16(l, h):
    m = l.astype(np.uint32)
    d = h.astype(np.uint32)
    bb = (m - (d >> 1)) & _MOD_MASK
    aa = (d + bb - _A_OFFSET) & _MOD_MASK
    return aa.astype(np.uint16), bb.astype(np.uint16)


def _wenc16(a, b, _=None):
    ao = (a.astype(np.int64) + _A_OFFSET) & _MOD_MASK
    bv = b.astype(np.int64)
    m = (ao + bv) >> 1
    d = ao - bv
    m = np.where(d < 0, (m + _M_OFFSET) & _MOD_MASK, m)
    d &= _MOD_MASK
    return m.astype(np.uint16), d.astype(np.uint16)


def wav2_decode(plane: np.ndarray, mx: int):
    """In-place inverse wavelet on a [ny, nx] u16 plane."""
    dec = _wdec14 if mx < (1 << 14) else _wdec16
    ny, nx = plane.shape
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1
    while p >= 1:
        ys = np.arange(0, ny - p2 + 1, p2)
        xs = np.arange(0, nx - p2 + 1, p2)
        if ys.size and xs.size:
            yy = ys[:, None]
            xx = xs[None, :]
            a00 = plane[yy, xx]
            a01 = plane[yy, xx + p]
            a10 = plane[yy + p, xx]
            a11 = plane[yy + p, xx + p]
            i00, i10 = dec(a00, a10)
            i01, i11 = dec(a01, a11)
            n00, n01 = dec(i00, i01)
            n10, n11 = dec(i10, i11)
            plane[yy, xx] = n00
            plane[yy, xx + p] = n01
            plane[yy + p, xx] = n10
            plane[yy + p, xx + p] = n11
            if nx & p:
                xo = xs[-1] + p2
                c0, c1 = dec(plane[ys, xo], plane[ys + p, xo])
                plane[ys, xo] = c0
                plane[ys + p, xo] = c1
        if (ny & p) and xs.size:
            yo = (ys[-1] + p2) if ys.size else 0
            r0, r1 = dec(plane[yo, xs], plane[yo, xs + p])
            plane[yo, xs] = r0
            plane[yo, xs + p] = r1
        p2 = p
        p >>= 1
    return plane


def wav2_encode(plane: np.ndarray, mx: int):
    """In-place forward wavelet on a [ny, nx] u16 plane."""
    enc = _wenc14 if mx < (1 << 14) else _wenc16
    ny, nx = plane.shape
    n = min(nx, ny)
    p = 1
    p2 = 2
    while p2 <= n:
        ys = np.arange(0, ny - p2 + 1, p2)
        xs = np.arange(0, nx - p2 + 1, p2)
        if ys.size and xs.size:
            yy = ys[:, None]
            xx = xs[None, :]
            a00 = plane[yy, xx]
            a01 = plane[yy, xx + p]
            a10 = plane[yy + p, xx]
            a11 = plane[yy + p, xx + p]
            i00, i01 = enc(a00, a01)
            i10, i11 = enc(a10, a11)
            n00, n10 = enc(i00, i10)
            n01, n11 = enc(i01, i11)
            plane[yy, xx] = n00
            plane[yy, xx + p] = n01
            plane[yy + p, xx] = n10
            plane[yy + p, xx + p] = n11
            if nx & p:
                xo = xs[-1] + p2
                c0, c1 = enc(plane[ys, xo], plane[ys + p, xo])
                plane[ys, xo] = c0
                plane[ys + p, xo] = c1
        if (ny & p) and xs.size:
            yo = (ys[-1] + p2) if ys.size else 0
            r0, r1 = enc(plane[yo, xs], plane[yo, xs + p])
            plane[yo, xs] = r0
            plane[yo, xs + p] = r1
        p = p2
        p2 <<= 1
    return plane


# ---------------------------------------------------------------------------
# Canonical Huffman coder (ImfHuf semantics)
# ---------------------------------------------------------------------------

class _BitReader:
    __slots__ = ("data", "pos", "c", "lc")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.c = 0
        self.lc = 0

    def get(self, n: int) -> int:
        while self.lc < n:
            if self.pos >= len(self.data):
                raise PizError("Huffman bit stream truncated")
            self.c = (self.c << 8) | self.data[self.pos]
            self.pos += 1
            self.lc += 8
        self.lc -= n
        return (self.c >> self.lc) & ((1 << n) - 1)


class _BitWriter:
    __slots__ = ("out", "c", "lc", "nbits")

    def __init__(self):
        self.out = bytearray()
        self.c = 0
        self.lc = 0
        self.nbits = 0

    def put(self, nbits: int, value: int):
        self.c = (self.c << nbits) | (value & ((1 << nbits) - 1))
        self.lc += nbits
        self.nbits += nbits
        while self.lc >= 8:
            self.lc -= 8
            self.out.append((self.c >> self.lc) & 0xFF)
        self.c &= (1 << self.lc) - 1

    def flush(self) -> bytes:
        if self.lc:
            self.out.append((self.c << (8 - self.lc)) & 0xFF)
            self.c = 0
            self.lc = 0
        return bytes(self.out)


def _canonical_code_table(lengths: np.ndarray) -> np.ndarray:
    """lengths[HUF_ENCSIZE] (0 = unused) -> packed (code << 6) | length,
    exactly hufCanonicalCodeTable's assignment order."""
    n = np.bincount(lengths, minlength=59).astype(np.int64)
    c = 0
    base = np.zeros(59, np.int64)
    for i in range(58, 0, -1):
        nc = (c + n[i]) >> 1
        base[i] = c
        c = nc
    codes = np.zeros(HUF_ENCSIZE, np.int64)
    for i in np.nonzero(lengths)[0]:
        l = lengths[i]
        codes[i] = (base[l] << 6) | l
        base[l] += 1
    return codes


def _unpack_enc_table(reader: _BitReader, im: int, iM: int) -> np.ndarray:
    lengths = np.zeros(HUF_ENCSIZE, np.uint8)
    i = im
    while i <= iM:
        l = reader.get(6)
        if l == LONG_ZEROCODE_RUN:
            zerun = reader.get(8) + SHORTEST_LONG_RUN
            if i + zerun > iM + 1:
                raise PizError("Huffman table zero run overflows")
            i += zerun
        elif l >= SHORT_ZEROCODE_RUN:
            zerun = l - SHORT_ZEROCODE_RUN + 2
            if i + zerun > iM + 1:
                raise PizError("Huffman table zero run overflows")
            i += zerun
        else:
            lengths[i] = l
            i += 1
    return lengths


def _pack_enc_table(writer: _BitWriter, lengths: np.ndarray, im: int, iM: int):
    i = im
    while i <= iM:
        l = int(lengths[i])
        if l == 0:
            zerun = 1
            while i + zerun <= iM and zerun < LONGEST_LONG_RUN:
                if lengths[i + zerun] > 0:
                    break
                zerun += 1
            if zerun >= 2:
                if zerun >= SHORTEST_LONG_RUN:
                    writer.put(6, LONG_ZEROCODE_RUN)
                    writer.put(8, zerun - SHORTEST_LONG_RUN)
                else:
                    writer.put(6, SHORT_ZEROCODE_RUN + zerun - 2)
                i += zerun
                continue
        writer.put(6, l)
        i += 1


def _build_dec_table(codes: np.ndarray, im: int, iM: int):
    """Short-code fast table (14-bit prefix -> symbol, length) + long list."""
    short_sym = np.zeros(HUF_DECSIZE, np.int32)
    short_len = np.zeros(HUF_DECSIZE, np.uint8)
    longs: dict[int, list[tuple[int, int, int]]] = {}
    for sym in range(im, iM + 1):
        packed = int(codes[sym])
        l = packed & 63
        if l == 0:
            continue
        code = packed >> 6
        if code >> l:
            raise PizError("invalid Huffman code table")
        if l > HUF_DECBITS:
            prefix = code >> (l - HUF_DECBITS)
            longs.setdefault(prefix, []).append((sym, code, l))
            if short_len[prefix]:
                raise PizError("invalid Huffman code table")
        else:
            start = code << (HUF_DECBITS - l)
            count = 1 << (HUF_DECBITS - l)
            if np.any(short_len[start:start + count]):
                raise PizError("invalid Huffman code table")
            short_sym[start:start + count] = sym
            short_len[start:start + count] = l
    return short_sym, short_len, longs


def huf_uncompress(data: bytes, n_out: int) -> np.ndarray:
    """ImfHuf-format stream -> u16 array of n_out values."""
    if len(data) < 20:
        raise PizError("Huffman block too short")
    im, iM, _table_len, n_bits = struct.unpack_from("<IIII", data, 0)
    if not (0 <= im < HUF_ENCSIZE and 0 <= iM < HUF_ENCSIZE and im <= iM):
        raise PizError("Huffman table range corrupt")
    reader = _BitReader(data[20:])
    lengths = _unpack_enc_table(reader, im, iM)
    codes = _canonical_code_table(lengths)
    short_sym, short_len, longs = _build_dec_table(codes, im, iM)

    # hufDecode: MSB-first bit stream of n_bits bits starting at the next
    # byte boundary after the table.
    if reader.lc:  # the table bit-reader stops mid-byte; encode pads per spec
        reader.lc = 0
    bits = reader.data[reader.pos:]
    if len(bits) * 8 < n_bits:
        raise PizError("Huffman data truncated")
    out = np.empty(n_out, np.uint16)
    no = 0
    rlc = iM
    c = 0
    lc = 0
    pos = 0
    ie = (n_bits + 7) // 8
    get_short_sym = short_sym
    get_short_len = short_len
    while pos < ie:
        c = (c << 8) | bits[pos]
        pos += 1
        lc += 8
        while lc >= HUF_DECBITS:
            idx = (c >> (lc - HUF_DECBITS)) & HUF_DECMASK
            l = int(get_short_len[idx])
            if l:
                lc -= l
                c &= (1 << lc) - 1  # keep the Python int bounded
                sym = int(get_short_sym[idx])
            else:
                for sym_j, code_j, l_j in longs.get(idx, ()):
                    while lc < l_j and pos < ie:
                        c = (c << 8) | bits[pos]
                        pos += 1
                        lc += 8
                    if lc >= l_j and ((c >> (lc - l_j))
                                      & ((1 << l_j) - 1)) == code_j:
                        lc -= l_j
                        c &= (1 << lc) - 1
                        sym = sym_j
                        break
                else:
                    raise PizError("invalid Huffman code")
            if sym == rlc:
                if lc < 8:
                    if pos >= ie:
                        raise PizError("Huffman run count truncated")
                    c = (c << 8) | bits[pos]
                    pos += 1
                    lc += 8
                lc -= 8
                cs = (c >> lc) & 0xFF
                if no == 0 or no + cs > n_out:
                    raise PizError("Huffman run overflows output")
                out[no:no + cs] = out[no - 1]
                no += cs
            else:
                if no >= n_out:
                    raise PizError("Huffman output overflow")
                out[no] = sym
                no += 1
    # Flush: decode remaining whole codes from the bit residue.
    i = (8 - n_bits) & 7
    c >>= i
    lc -= i
    while lc > 0:
        idx = (c << (HUF_DECBITS - lc)) & HUF_DECMASK
        l = int(get_short_len[idx])
        if l and l <= lc:
            lc -= l
            sym = int(get_short_sym[idx])
            if sym == rlc:
                if lc < 8:
                    raise PizError("Huffman run count truncated")
                lc -= 8
                cs = (c >> lc) & 0xFF
                if no == 0 or no + cs > n_out:
                    raise PizError("Huffman run overflows output")
                out[no:no + cs] = out[no - 1]
                no += cs
            else:
                if no >= n_out:
                    raise PizError("Huffman output overflow")
                out[no] = sym
                no += 1
        else:
            break
    if no != n_out:
        raise PizError(f"Huffman decoded {no} of {n_out} values")
    return out


def _build_code_lengths(freq: np.ndarray) -> np.ndarray:
    """Huffman code lengths for nonzero-frequency symbols (heap merge).
    Any valid length set decodes (the table ships in the stream); OpenEXR's
    own merge order is not required. Lengths capped at 58 by flattening."""
    import heapq
    syms = np.nonzero(freq)[0]
    lengths = np.zeros(HUF_ENCSIZE, np.uint8)
    if syms.size == 1:
        lengths[syms[0]] = 1
        return lengths
    heap = [(int(freq[s]), int(s), [int(s)]) for s in syms]
    heapq.heapify(heap)
    depth = {int(s): 0 for s in syms}
    while len(heap) > 1:
        fa, ta, la = heapq.heappop(heap)
        fb, tb, lb = heapq.heappop(heap)
        for s in la + lb:
            depth[s] += 1
        heapq.heappush(heap, (fa + fb, min(ta, tb), la + lb))
    for s, d in depth.items():
        lengths[s] = d
    if lengths.max() > 58:
        # Degenerate distribution: fall back to a flat code.
        flat = max(1, int(np.ceil(np.log2(syms.size))))
        lengths[:] = 0
        lengths[syms] = flat
    return lengths


def huf_compress(raw: np.ndarray) -> bytes:
    """u16 array -> ImfHuf-format stream."""
    raw = np.asarray(raw, np.uint16)
    if raw.size == 0:
        return b""
    freq = np.bincount(raw, minlength=HUF_ENCSIZE).astype(np.int64)
    im = int(np.nonzero(freq)[0][0])
    iM = int(np.nonzero(freq)[0][-1]) + 1  # pseudo-symbol: the RLE code
    freq[iM] = 1
    lengths = _build_code_lengths(freq)
    codes = _canonical_code_table(lengths)

    tw = _BitWriter()
    _pack_enc_table(tw, lengths, im, iM)
    table_bytes = tw.flush()

    dw = _BitWriter()
    code_of = [(int(codes[s]) >> 6, int(codes[s]) & 63)
               for s in range(HUF_ENCSIZE)]
    rlc_code, rlc_len = code_of[iM]

    def send(sym: int, run: int):
        code, l = code_of[sym]
        if l + rlc_len + 8 < l * run:
            dw.put(l, code)
            dw.put(rlc_len, rlc_code)
            dw.put(8, run)
        else:
            for _ in range(run + 1):
                dw.put(l, code)

    s = int(raw[0])
    cs = 0
    for v in raw[1:]:
        v = int(v)
        if v == s and cs < 255:
            cs += 1
        else:
            send(s, cs)
            s = v
            cs = 0
    send(s, cs)
    n_bits = dw.nbits
    data_bytes = dw.flush()
    header = struct.pack("<IIIII", im, iM, len(table_bytes), n_bits, 0)
    return header + table_bytes + data_bytes


# ---------------------------------------------------------------------------
# PIZ block codec
# ---------------------------------------------------------------------------

def piz_uncompress_block(raw: bytes, chans, width: int, ny: int) -> bytes:
    """One PIZ chunk -> raw scanline-interleaved block bytes.

    chans: [(name, pixel_type)] in header order; pixel sizes 2 (HALF) or
    4 (FLOAT/UINT) bytes, i.e. 1 or 2 u16 units."""
    if len(raw) < 4:
        raise PizError("PIZ chunk too short")
    min_nz, max_nz = struct.unpack_from("<HH", raw, 0)
    pos = 4
    bitmap = np.zeros(BITMAP_SIZE, np.uint8)
    if min_nz <= max_nz:
        if max_nz >= BITMAP_SIZE or pos + (max_nz - min_nz + 1) > len(raw):
            raise PizError("PIZ bitmap range corrupt")
        count = max_nz - min_nz + 1
        bitmap[min_nz:max_nz + 1] = np.frombuffer(raw, np.uint8, count, pos)
        pos += count
    rev_lut, max_value = reverse_lut_from_bitmap(bitmap)

    (length,) = struct.unpack_from("<i", raw, pos)
    pos += 4
    if length < 0 or pos + length > len(raw):
        raise PizError("PIZ Huffman length corrupt")

    sizes = [2 if t == 1 else 4 for _, t in chans]  # bytes per pixel
    units = [s // 2 for s in sizes]  # u16 per pixel
    total = sum(width * ny * u for u in units)
    tmp = huf_uncompress(raw[pos:pos + length], total)

    # Per channel, per interleaved u16 sub-plane: inverse wavelet.
    out_rows = []
    off = 0
    chan_planes = []
    for (name, _t), u in zip(chans, units):
        n = width * ny * u
        cd = tmp[off:off + n].copy()
        off += n
        view = cd.reshape(ny, width, u)
        for j in range(u):
            plane = np.ascontiguousarray(view[:, :, j])
            wav2_decode(plane, max_value)
            view[:, :, j] = plane
        chan_planes.append(rev_lut[cd].reshape(ny, width * u))
    # Interleave to scanline order: per row, channels in header order.
    row_parts = []
    for y in range(ny):
        for plane in chan_planes:
            row_parts.append(plane[y].tobytes())
    return b"".join(row_parts)


def piz_compress_block(block: bytes, chans, width: int, ny: int) -> bytes:
    """Raw scanline-interleaved block bytes -> one PIZ chunk."""
    units = [(2 if t == 1 else 4) // 2 for _, t in chans]
    row_u16 = width * sum(units)
    data = np.frombuffer(block, "<u2").copy()
    if data.size != row_u16 * ny:
        raise PizError("PIZ block size mismatch")
    rows = data.reshape(ny, row_u16)
    # De-interleave to channel-major.
    chan_data = []
    coff = 0
    for u in units:
        w = width * u
        chan_data.append(np.ascontiguousarray(rows[:, coff:coff + w]))
        coff += w
    tmp = np.concatenate([c.reshape(-1) for c in chan_data])

    bitmap, min_nz, max_nz = bitmap_from_data(tmp)
    lut, max_value = forward_lut_from_bitmap(bitmap)
    off = 0
    pieces = []
    for cd, u in zip(chan_data, units):
        flat = lut[cd.reshape(-1)]
        view = flat.reshape(ny, width, u)
        for j in range(u):
            plane = np.ascontiguousarray(view[:, :, j])
            wav2_encode(plane, max_value)
            view[:, :, j] = plane
        pieces.append(flat)
        off += flat.size
    packed = np.concatenate(pieces)
    huf = huf_compress(packed)
    head = struct.pack("<HH", min_nz, max_nz)
    bm = bitmap[min_nz:max_nz + 1].tobytes() if min_nz <= max_nz else b""
    return head + bm + struct.pack("<i", len(huf)) + huf


# ---------------------------------------------------------------------------
# PXR24 block codec (decode; lossy 24-bit floats)
# ---------------------------------------------------------------------------

def pxr24_uncompress_block(raw_z: bytes, chans, width: int, ny: int) -> bytes:
    """One PXR24 chunk (zlib payload) -> raw scanline block bytes."""
    import zlib
    data = np.frombuffer(zlib.decompress(raw_z), np.uint8)
    pos = 0
    out = bytearray()
    for _y in range(ny):
        for name, t in chans:
            n = width
            if t == 0:  # UINT: 4 delta byte-planes
                if pos + 4 * n > data.size:
                    raise PizError("PXR24 chunk truncated")
                p = data[pos:pos + 4 * n].reshape(4, n).astype(np.uint32)
                pos += 4 * n
                diff = (p[0] << 24) | (p[1] << 16) | (p[2] << 8) | p[3]
                pix = np.cumsum(diff, dtype=np.uint32)
                out += pix.astype("<u4").tobytes()
            elif t == 1:  # HALF: 2 delta byte-planes
                if pos + 2 * n > data.size:
                    raise PizError("PXR24 chunk truncated")
                p = data[pos:pos + 2 * n].reshape(2, n).astype(np.uint32)
                pos += 2 * n
                diff = (p[0] << 8) | p[1]
                pix = np.cumsum(diff, dtype=np.uint32) & 0xFFFF
                out += pix.astype("<u2").tobytes()
            else:  # FLOAT: 3 delta byte-planes, low byte zeroed
                if pos + 3 * n > data.size:
                    raise PizError("PXR24 chunk truncated")
                p = data[pos:pos + 3 * n].reshape(3, n).astype(np.uint32)
                pos += 3 * n
                diff = (p[0] << 24) | (p[1] << 16) | (p[2] << 8)
                pix = np.cumsum(diff, dtype=np.uint32)
                out += pix.astype("<u4").tobytes()
    return bytes(out)
