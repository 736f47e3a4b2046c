// Native OBJ parser: the hot part of mesh loading. A copy of
// neural_renderer_tpu/csrc/obj_parser.cpp.
//
// Replicates neural_renderer_tpu_torch/scene/mesh_loader.py::_parse_obj_python
// exactly (that Python path stays as the fallback): "v "/"vt "/"vn "/"f "
// lines only (leading whitespace disqualifies, as with str.startswith),
// doubles parsed then rounded to f32, negative/absent index fixing against
// the final counts (faces are collected first and resolved after the whole
// file is read), (v,vt,vn)-triple vertex unification in first-appearance
// order, and fan triangulation. Any line the Python parser would raise on
// makes this return nonzero so the caller falls back to Python for the
// user-facing error. A host helper, built with the host compiler at first
// use (scene/mesh_loader.py).

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Key {
    int64_t v, t, n;
    bool operator==(const Key &o) const {
        return v == o.v && t == o.t && n == o.n;
    }
};

struct KeyHash {
    size_t operator()(const Key &k) const {
        uint64_t h = 0x9e3779b97f4a7c15ULL;
        for (uint64_t x : {(uint64_t)k.v, (uint64_t)k.t, (uint64_t)k.n}) {
            x ^= x >> 30; x *= 0xbf58476d1ce4e5b9ULL;
            x ^= x >> 27; x *= 0x94d049bb133111ebULL;
            x ^= x >> 31;
            h ^= x + 0x9e3779b97f4a7c15ULL + (h << 6) + (h >> 2);
        }
        return (size_t)h;
    }
};

// index fix (mesh_loader.py): 1-based -> 0-based, negative -> from end,
// 0 (absent) -> -1.
inline int64_t fix_index(int64_t i, int64_t n) {
    if (i > 0) return i - 1;
    if (i < 0) return n + i;
    return -1;
}

inline bool parse_double(const char *&p, const char *end, double *out) {
    char *ep = nullptr;
    double v = strtod(p, &ep);
    if (ep == p || ep > end) return false;
    // Python float() parity: no hex literals ("0x10"), and the token must
    // end at whitespace/EOL ("3x" raises there; strtod would salvage 3.0).
    for (const char *q = p; q < ep; q++)
        if (*q == 'x' || *q == 'X') return false;
    if (ep < end && !isspace((unsigned char)*ep)) return false;
    p = ep;
    *out = v;
    return true;
}

inline bool only_ws(const char *p, const char *end) {
    while (p < end) {
        if (!isspace((unsigned char)*p)) return false;
        p++;
    }
    return true;
}

}  // namespace

extern "C" {

// Returns 0 on success. All out buffers are malloc'd here; release with
// free_obj().
int parse_obj(const char *path,
              float **out_pos, float **out_uv, float **out_norm,
              uint8_t **out_norm_valid, uint32_t **out_idx,
              int64_t *n_verts, int64_t *n_tris, int64_t *n_faces,
              int32_t *has_tex, int32_t *has_norm) {
    FILE *f = fopen(path, "rb");
    if (!f) return 1;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    if (size < 0) { fclose(f); return 1; }
    std::vector<char> buf((size_t)size + 1);
    if (size > 0 && fread(buf.data(), 1, (size_t)size, f) != (size_t)size) {
        fclose(f);
        return 1;
    }
    fclose(f);
    buf[(size_t)size] = '\0';

    std::vector<float> pos3, tex2, nrm3;
    std::vector<int64_t> corners;    // raw (vi, ti, ni) triples, unfixed
    std::vector<int64_t> face_len;   // corners per face

    // ---- phase 1: line scan (Python's file loop) ----
    const char *p = buf.data();
    const char *file_end = buf.data() + size;
    while (p < file_end) {
        const char *line_end = (const char *)memchr(p, '\n', file_end - p);
        if (!line_end) line_end = file_end;
        const char *q = p;
        p = line_end + 1;

        if (q + 2 <= line_end && q[0] == 'v' && q[1] == ' ') {
            const char *c = q + 2;
            double x, y, z;
            if (!parse_double(c, line_end, &x) ||
                !parse_double(c, line_end, &y) ||
                !parse_double(c, line_end, &z)) return 2;
            pos3.push_back((float)x);
            pos3.push_back((float)y);
            pos3.push_back((float)z);
        } else if (q + 3 <= line_end && q[0] == 'v' && q[1] == 't' &&
                   q[2] == ' ') {
            const char *c = q + 3;
            double u, v = 0.0;
            if (!parse_double(c, line_end, &u)) return 2;
            if (!parse_double(c, line_end, &v)) {
                // No second float: Python defaults to 0.0 only when the
                // token is absent; a non-numeric token would raise there.
                if (!only_ws(c, line_end)) return 2;
                v = 0.0;
            }
            tex2.push_back((float)u);
            tex2.push_back((float)v);
        } else if (q + 3 <= line_end && q[0] == 'v' && q[1] == 'n' &&
                   q[2] == ' ') {
            const char *c = q + 3;
            double x, y, z;
            if (!parse_double(c, line_end, &x) ||
                !parse_double(c, line_end, &y) ||
                !parse_double(c, line_end, &z)) return 2;
            nrm3.push_back((float)x);
            nrm3.push_back((float)y);
            nrm3.push_back((float)z);
        } else if (q + 2 <= line_end && q[0] == 'f' && q[1] == ' ') {
            const char *c = q + 2;
            int64_t count = 0;
            while (c < line_end) {
                while (c < line_end && isspace((unsigned char)*c)) c++;
                if (c >= line_end) break;
                char *ep = nullptr;
                long long vi = strtoll(c, &ep, 10);
                if (ep == c) return 2;  // int(comps[0]) would raise
                c = ep;
                long long ti = 0, ni = 0;
                if (c < line_end && *c == '/') {
                    c++;
                    if (c < line_end && *c != '/' &&
                        !isspace((unsigned char)*c)) {
                        ti = strtoll(c, &ep, 10);
                        if (ep == c) return 2;  // int(comps[1]) would raise
                        c = ep;
                    }
                    if (c < line_end && *c == '/') {
                        c++;
                        if (c < line_end && *c != '/' &&
                            !isspace((unsigned char)*c)) {
                            ni = strtoll(c, &ep, 10);
                            if (ep == c) return 2;
                            c = ep;
                        }
                        // Components past [2] are ignored by the Python
                        // tok.split("/") indexing; skip them verbatim.
                        if (c < line_end && *c == '/') {
                            while (c < line_end &&
                                   !isspace((unsigned char)*c)) c++;
                        }
                    }
                }
                // Anything else glued to the token would make Python's
                // int() raise.
                if (c < line_end && !isspace((unsigned char)*c)) return 2;
                corners.push_back(vi);
                corners.push_back(ti);
                corners.push_back(ni);
                count++;
            }
            face_len.push_back(count);
        }
    }

    if (face_len.empty()) return 4;  // "No triangles found" — Python raises

    // ---- phase 2: unify + fan-triangulate with FINAL counts ----
    const int64_t npos = (int64_t)pos3.size() / 3;
    const int64_t ntex = (int64_t)tex2.size() / 2;
    const int64_t nnrm = (int64_t)nrm3.size() / 3;

    std::vector<float> upos, uuv, unrm;
    std::vector<uint8_t> uvalid;
    std::vector<uint32_t> idx;
    std::unordered_map<Key, uint32_t, KeyHash> cache;
    cache.reserve(corners.size() / 3);
    std::vector<uint32_t> face_ids;

    size_t ci = 0;
    for (int64_t fl : face_len) {
        face_ids.clear();
        for (int64_t k2 = 0; k2 < fl; k2++) {
            Key k{fix_index(corners[ci], npos),
                  fix_index(corners[ci + 1], ntex),
                  fix_index(corners[ci + 2], nnrm)};
            ci += 3;
            if (k.v < 0 || k.v >= npos || k.t >= ntex || k.n >= nnrm ||
                k.t < -1 || k.n < -1)
                return 2;  // Python would IndexError
            auto it = cache.find(k);
            uint32_t id;
            if (it != cache.end()) {
                id = it->second;
            } else {
                id = (uint32_t)(upos.size() / 3);
                cache.emplace(k, id);
                upos.push_back(pos3[k.v * 3 + 0]);
                upos.push_back(pos3[k.v * 3 + 1]);
                upos.push_back(pos3[k.v * 3 + 2]);
                if (k.t >= 0) {
                    uuv.push_back(tex2[k.t * 2 + 0]);
                    uuv.push_back(tex2[k.t * 2 + 1]);
                } else {
                    uuv.push_back(0.0f);
                    uuv.push_back(0.0f);
                }
                if (k.n >= 0) {
                    unrm.push_back(nrm3[k.n * 3 + 0]);
                    unrm.push_back(nrm3[k.n * 3 + 1]);
                    unrm.push_back(nrm3[k.n * 3 + 2]);
                    uvalid.push_back(1);
                } else {
                    unrm.push_back(0.0f);
                    unrm.push_back(0.0f);
                    unrm.push_back(0.0f);
                    uvalid.push_back(0);
                }
            }
            face_ids.push_back(id);
        }
        for (size_t k2 = 1; k2 + 1 < face_ids.size(); k2++) {
            idx.push_back(face_ids[0]);
            idx.push_back(face_ids[k2]);
            idx.push_back(face_ids[k2 + 1]);
        }
    }

    *n_verts = (int64_t)(upos.size() / 3);
    *n_tris = (int64_t)(idx.size() / 3);
    *n_faces = (int64_t)face_len.size();
    *has_tex = tex2.empty() ? 0 : 1;
    *has_norm = nrm3.empty() ? 0 : 1;

    auto dup = [](const void *src, size_t bytes) -> void * {
        void *d = malloc(bytes ? bytes : 1);
        if (d && bytes) memcpy(d, src, bytes);
        return d;
    };
    *out_pos = (float *)dup(upos.data(), upos.size() * sizeof(float));
    *out_uv = (float *)dup(uuv.data(), uuv.size() * sizeof(float));
    *out_norm = (float *)dup(unrm.data(), unrm.size() * sizeof(float));
    *out_norm_valid = (uint8_t *)dup(uvalid.data(), uvalid.size());
    *out_idx = (uint32_t *)dup(idx.data(), idx.size() * sizeof(uint32_t));
    if (!*out_pos || !*out_uv || !*out_norm || !*out_norm_valid || !*out_idx)
        return 3;
    return 0;
}

void free_obj(float *pos, float *uv, float *norm, uint8_t *norm_valid,
              uint32_t *idx) {
    free(pos);
    free(uv);
    free(norm);
    free(norm_valid);
    free(idx);
}

}  // extern "C"
