// Entropy decoding of one JPEG scan (Huffman, sequential or progressive).
//
// The twin of metrics/jpeg.py::_scan_python, the same algorithm line for
// line (libjpeg's jdhuff.c / jdphuff.c): the Python side parses the
// markers, and runs the IDCT, upsampling and colour conversion in numpy;
// this helper turns a scan's entropy-coded bytes into the quantised DCT
// coefficients, which is where the Python loop spends its time. The Python
// decoder stays authoritative where no host compiler exists;
// tests/test_torch_jpeg.py holds both to libjpeg-turbo byte for byte.
//
// Built at first use by utils/native.py::ensure_native_lib, like
// hdr_rle.cpp and obj_parser.cpp.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int kNaturalOrder[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// Error codes, named in metrics/jpeg.py::_NATIVE_ERRORS.
const int kBadCode = -1, kEndsEarly = -2, kNoRestart = -3, kBadTable = -4;

// 65,536 entries indexed by the next 16 bits: (length << 8) | symbol, 0
// where no code matches. A DC symbol (a bit count) above 15 is refused,
// as libjpeg refuses it.
bool build_lut(const uint8_t* table, bool dc, std::vector<uint16_t>& lut) {
    lut.assign(65536, 0);
    const uint8_t* counts = table;
    const uint8_t* vals = table + 16;
    int code = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
        for (int i = 0; i < counts[len - 1]; ++i) {
            if (k >= 256 || (dc && vals[k] > 15)) return false;
            const int start = code << (16 - len);
            const int end = (code + 1) << (16 - len);
            if (end > 65536) return false;
            const uint16_t e = uint16_t((len << 8) | vals[k]);
            for (int j = start; j < end; ++j) lut[j] = e;
            ++code;
            ++k;
        }
        code <<= 1;
    }
    return true;
}

// The scan's bytes unstuffed (FF 00 -> FF) and split at restart markers,
// each interval padded with zero bytes.
std::vector<std::vector<uint8_t>> intervals(const uint8_t* seg, int64_t n) {
    std::vector<std::vector<uint8_t>> out(1);
    for (int64_t i = 0; i < n;) {
        if (seg[i] != 0xFF || i + 1 >= n) {
            if (seg[i] != 0xFF) out.back().push_back(seg[i]);
            ++i;
            continue;
        }
        const uint8_t m = seg[i + 1];
        if (m == 0x00) {
            out.back().push_back(0xFF);
            i += 2;
        } else if (m >= 0xD0 && m <= 0xD7) {
            out.emplace_back();
            i += 2;
        } else {
            ++i;  // fill byte before a marker
        }
    }
    for (auto& v : out) v.insert(v.end(), 8, 0);
    return out;
}

struct Bits {
    const uint8_t* buf;
    int64_t pos;  // in bits
    uint32_t get(int s) {
        if (s == 0) return 0;
        const uint8_t* q = buf + (pos >> 3);
        const uint32_t v = (uint32_t(q[0]) << 24) | (uint32_t(q[1]) << 16) |
                           (uint32_t(q[2]) << 8) | uint32_t(q[3]);
        const uint32_t r = (v >> (32 - (pos & 7) - s)) & ((1u << s) - 1);
        pos += s;
        return r;
    }
    int huff(const std::vector<uint16_t>& lut) {
        const uint8_t* q = buf + (pos >> 3);
        const uint32_t v = (uint32_t(q[0]) << 16) | (uint32_t(q[1]) << 8) |
                           uint32_t(q[2]);
        const uint16_t e = lut[(v >> (8 - (pos & 7))) & 0xFFFF];
        if (e == 0) return -1;
        pos += e >> 8;
        return e & 0xFF;
    }
};

inline int extend(int r, int s) {
    return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r;
}

}  // namespace

extern "C" {

// Decode one scan into each scan component's coefficients.
//   seg, n         the entropy-coded bytes after the SOS segment
//   ncomp          components in the scan
//   comp           ncomp x 7 int32: h, v, alloc_w (blocks per row of the
//                  coefficient array), width and height in blocks, DC and
//                  AC table numbers
//   coefs          ncomp pointers to [alloc_h * alloc_w][64] int16 in
//                  natural order, kept across scans (progressive)
//   huff           8 x 272 bytes: DC tables 0-3 then AC tables 0-3, each 16
//                  code counts and 256 symbols
//   mcus_x, mcus_y the frame's MCU grid (used when ncomp > 1)
//   ss, se, ah, al the scan's spectral selection and approximation
// Returns 0, or a negative error code.
int jpeg_decode_scan(const char* seg_chars, int64_t n, int32_t ncomp,
                     const int32_t* comp, void** coefs, const char* huff,
                     int32_t mcus_x, int32_t mcus_y, int32_t ss, int32_t se,
                     int32_t ah, int32_t al, int32_t progressive,
                     int32_t restart_interval) {
    const uint8_t* seg = reinterpret_cast<const uint8_t*>(seg_chars);
    const uint8_t* tables = reinterpret_cast<const uint8_t*>(huff);
    if (ncomp < 1 || ncomp > 4) return kBadTable;
    std::vector<uint16_t> dc_lut[4], ac_lut[4];
    const bool need_dc = !progressive || (ss == 0 && ah == 0);
    const bool need_ac = !progressive || ss > 0;
    for (int c = 0; c < ncomp; ++c) {
        const int dc = comp[c * 7 + 5], ac = comp[c * 7 + 6];
        if (dc < 0 || dc > 3 || ac < 0 || ac > 3) return kBadTable;
        if (need_dc && !build_lut(tables + dc * 272, true, dc_lut[c]))
            return kBadTable;
        if (need_ac && !build_lut(tables + (4 + ac) * 272, false, ac_lut[c]))
            return kBadTable;
    }
    // The (component, block index) pairs of every MCU, in stream order.
    std::vector<int64_t> blocks;
    std::vector<int64_t> mcu_start;
    if (ncomp == 1) {
        const int64_t aw = comp[2], bw = comp[3], bh = comp[4];
        for (int64_t by = 0; by < bh; ++by)
            for (int64_t bx = 0; bx < bw; ++bx) {
                mcu_start.push_back(int64_t(blocks.size()));
                blocks.push_back(by * aw + bx);  // component 0
            }
    } else {
        for (int64_t my = 0; my < mcus_y; ++my)
            for (int64_t mx = 0; mx < mcus_x; ++mx) {
                mcu_start.push_back(int64_t(blocks.size()));
                for (int c = 0; c < ncomp; ++c) {
                    const int64_t h = comp[c * 7], v = comp[c * 7 + 1];
                    const int64_t aw = comp[c * 7 + 2];
                    for (int64_t y = 0; y < v; ++y)
                        for (int64_t x = 0; x < h; ++x)
                            blocks.push_back((int64_t(c) << 48) |
                                             ((my * v + y) * aw + mx * h + x));
                }
            }
    }
    mcu_start.push_back(int64_t(blocks.size()));
    const int64_t nmcu = int64_t(mcu_start.size()) - 1;
    const auto parts = intervals(seg, n);
    const int64_t per = restart_interval > 0 ? restart_interval : nmcu;
    const int p1 = 1 << al, m1 = -(1 << al);
    for (int64_t start = 0; start < nmcu; start += per) {
        const int64_t k_int = start / per;
        if (k_int >= int64_t(parts.size())) return kNoRestart;
        const auto& buf = parts[k_int];
        const int64_t limit = int64_t(buf.size() - 8) * 8;
        Bits br{buf.data(), 0};
        int pred[4] = {0, 0, 0, 0};
        int eobrun = 0;
        const int64_t stop = start + per < nmcu ? start + per : nmcu;
        for (int64_t mcu = start; mcu < stop; ++mcu) {
            for (int64_t bi = mcu_start[mcu]; bi < mcu_start[mcu + 1]; ++bi) {
                if (br.pos > limit) return kEndsEarly;
                const int ci = int(blocks[bi] >> 48);
                int16_t* co = static_cast<int16_t*>(coefs[ci]) +
                              (blocks[bi] & ((int64_t(1) << 48) - 1)) * 64;
                if (!progressive) {
                    int s = br.huff(dc_lut[ci]);
                    if (s < 0) return kBadCode;
                    if (s) s = extend(int(br.get(s)), s);
                    pred[ci] += s;
                    co[0] = int16_t(pred[ci]);
                    for (int k = 1; k < 64; ++k) {
                        const int rs = br.huff(ac_lut[ci]);
                        if (rs < 0) return kBadCode;
                        const int r = rs >> 4;
                        s = rs & 15;
                        if (s) {
                            k += r;
                            co[kNaturalOrder[k]] =
                                int16_t(extend(int(br.get(s)), s));
                        } else if (r != 15) {
                            break;
                        } else {
                            k += 15;
                        }
                    }
                } else if (ss == 0) {  // DC scans
                    if (ah == 0) {
                        int s = br.huff(dc_lut[ci]);
                        if (s < 0) return kBadCode;
                        if (s) s = extend(int(br.get(s)), s);
                        pred[ci] += s;
                        co[0] = int16_t(int(uint32_t(pred[ci]) << al));
                    } else if (br.get(1)) {
                        co[0] = int16_t(co[0] | p1);
                    }
                } else if (ah == 0) {  // AC first scan
                    if (eobrun > 0) {
                        --eobrun;
                        continue;
                    }
                    for (int k = ss; k <= se; ++k) {
                        const int rs = br.huff(ac_lut[ci]);
                        if (rs < 0) return kBadCode;
                        const int r = rs >> 4, s = rs & 15;
                        if (s) {
                            k += r;
                            co[kNaturalOrder[k]] = int16_t(int(
                                uint32_t(extend(int(br.get(s)), s)) << al));
                        } else if (r == 15) {
                            k += 15;
                        } else {
                            eobrun = (1 << r) - 1;
                            if (r) eobrun += int(br.get(r));
                            break;
                        }
                    }
                } else {  // AC refinement
                    int k = ss;
                    if (eobrun == 0) {
                        for (; k <= se; ++k) {
                            const int rs = br.huff(ac_lut[ci]);
                            if (rs < 0) return kBadCode;
                            int r = rs >> 4, s = rs & 15;
                            if (s) {
                                s = br.get(1) ? p1 : m1;
                            } else if (r != 15) {
                                eobrun = 1 << r;
                                if (r) eobrun += int(br.get(r));
                                break;
                            }
                            while (k <= se) {
                                int16_t* z = co + kNaturalOrder[k];
                                if (*z != 0) {
                                    if (br.get(1) && (*z & p1) == 0)
                                        *z = int16_t(*z + (*z >= 0 ? p1 : m1));
                                } else if (--r < 0) {
                                    break;
                                }
                                ++k;
                            }
                            if (s) co[kNaturalOrder[k]] = int16_t(s);
                        }
                    }
                    if (eobrun > 0) {
                        for (; k <= se; ++k) {
                            int16_t* z = co + kNaturalOrder[k];
                            if (*z != 0 && br.get(1) && (*z & p1) == 0)
                                *z = int16_t(*z + (*z >= 0 ? p1 : m1));
                        }
                        --eobrun;
                    }
                }
            }
        }
        if (br.pos > limit) return kEndsEarly;
    }
    return 0;
}

}  // extern "C"
