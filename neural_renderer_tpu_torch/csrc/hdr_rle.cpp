// Native RLE scanline decoder for Radiance .hdr (RGBE) files.
//
// Port (a copy) of neural_renderer_tpu/csrc/hdr_rle.cpp: the twin of the
// Python loop in scene/envmap.py::load_hdr. The per-run Python loop costs
// tens of seconds on 4k environment maps; this decodes the whole scanline
// section in one call. The Python decoder stays authoritative where no host
// compiler exists; tests/test_torch_exr.py holds both to the reference.
//
// Built at first use by utils/native.py::ensure_native_lib, like
// obj_parser.cpp and bvh_builder.cpp.

#include <cstdint>
#include <cstring>

extern "C" {

// Decode `height` RLE scanlines of `width` pixels starting at data[0].
// out_rgbe must hold height*width*4 bytes (per-pixel RGBE, pixel-major).
// Returns the number of input bytes consumed, or:
//   -1  truncated input
//   -2  malformed run / wrong scanline header (caller should fall back)
long long decode_hdr_rle(const uint8_t* data, long long size,
                         int width, int height, uint8_t* out_rgbe) {
    long long pos = 0;
    for (int y = 0; y < height; ++y) {
        if (pos + 4 > size) return -1;
        const uint8_t* h = data + pos;
        const bool is_rle = h[0] == 2 && h[1] == 2 && (h[2] & 0x80) == 0;
        const int scan_w = (int(h[2]) << 8) | int(h[3]);
        if (!is_rle || scan_w != width || width < 8 || width > 0x7FFF)
            return -2;  // flat or adaptive-RLE variants: Python path handles
        pos += 4;

        uint8_t* row = out_rgbe + (long long)y * width * 4;
        for (int c = 0; c < 4; ++c) {
            int x = 0;
            while (x < width) {
                if (pos >= size) return -1;
                const int count = data[pos++];
                if (count > 128) {           // run of one repeated byte
                    const int run = count - 128;
                    if (pos >= size) return -1;
                    if (x + run > width) return -2;
                    const uint8_t v = data[pos++];
                    for (int i = 0; i < run; ++i)
                        row[(x + i) * 4 + c] = v;
                    x += run;
                } else {                     // literal run
                    const int run = count;
                    if (run == 0 || x + run > width) return -2;
                    if (pos + run > size) return -1;
                    for (int i = 0; i < run; ++i)
                        row[(x + i) * 4 + c] = data[pos + i];
                    pos += run;
                    x += run;
                }
            }
        }
    }
    return pos;
}

}  // extern "C"
