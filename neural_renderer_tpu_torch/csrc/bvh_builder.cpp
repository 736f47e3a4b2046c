// Binned-SAH BVH builder: native implementation of the contract in
// neural_renderer_tpu_torch/scene/bvh.py (which carries the numpy version).
// A copy of neural_renderer_tpu/csrc/bvh_builder.cpp.
//
// Triangles are reordered into leaf order via the returned permutation, and
// nodes are emitted in the flat layout (bounds, left/right, first/count,
// is_leaf) that the BVH walk reads. A host helper, not a GPU kernel: built
// with the host compiler at first use (scene/bvh.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kNumBins = 16;
constexpr float kTraversalCost = 1.0f;
constexpr float kIntersectCost = 1.5f;

struct Vec3 {
    float x, y, z;
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Box {
    Vec3 lo{std::numeric_limits<float>::infinity(),
            std::numeric_limits<float>::infinity(),
            std::numeric_limits<float>::infinity()};
    Vec3 hi{-std::numeric_limits<float>::infinity(),
            -std::numeric_limits<float>::infinity(),
            -std::numeric_limits<float>::infinity()};

    void extend(const Vec3& lo2, const Vec3& hi2) {
        lo = vmin(lo, lo2);
        hi = vmax(hi, hi2);
    }
    void extend(const Box& b) { extend(b.lo, b.hi); }

    float surface_area() const {
        float dx = std::max(hi.x - lo.x, 0.0f);
        float dy = std::max(hi.y - lo.y, 0.0f);
        float dz = std::max(hi.z - lo.z, 0.0f);
        return 2.0f * (dx * dy + dy * dz + dz * dx);
    }
};

struct Builder {
    const float* tri_min;
    const float* tri_max;
    int max_leaf_size;
    std::vector<int64_t> perm;
    std::vector<Vec3> centers;

    // Output arrays (caller-allocated, capacity 2*T).
    float* out_bmin;
    float* out_bmax;
    int* out_left;
    int* out_right;
    int* out_first;
    int* out_count;
    int* out_leaf;
    int node_count = 0;

    Vec3 tmin(int64_t i) const {
        return {tri_min[3 * i], tri_min[3 * i + 1], tri_min[3 * i + 2]};
    }
    Vec3 tmax(int64_t i) const {
        return {tri_max[3 * i], tri_max[3 * i + 1], tri_max[3 * i + 2]};
    }

    int alloc_node() {
        int id = node_count++;
        out_left[id] = -1;
        out_right[id] = -1;
        out_first[id] = 0;
        out_count[id] = 0;
        out_leaf[id] = 0;
        return id;
    }

    void set_bounds(int node, const Box& b) {
        out_bmin[3 * node] = b.lo.x;
        out_bmin[3 * node + 1] = b.lo.y;
        out_bmin[3 * node + 2] = b.lo.z;
        out_bmax[3 * node] = b.hi.x;
        out_bmax[3 * node + 1] = b.hi.y;
        out_bmax[3 * node + 2] = b.hi.z;
    }

    // Returns the chosen (axis, bin edge) split; mid computed by partition.
    // split_cost set to +inf when no valid SAH split exists.
    bool find_sah_split(int start, int end, const Box& node_box,
                        int* out_axis, float* out_edge_pos, float* out_cost) {
        int n = end - start;
        Box cbox;
        for (int i = start; i < end; ++i) {
            Vec3 c = centers[perm[i]];
            cbox.extend(c, c);
        }
        float parent_sa = node_box.surface_area();
        if (parent_sa <= 0.0f) return false;

        float best_cost = std::numeric_limits<float>::infinity();
        int best_axis = -1;
        float best_edge = 0.0f;

        for (int axis = 0; axis < 3; ++axis) {
            float cmin = axis == 0 ? cbox.lo.x : (axis == 1 ? cbox.lo.y : cbox.lo.z);
            float cmax = axis == 0 ? cbox.hi.x : (axis == 1 ? cbox.hi.y : cbox.hi.z);
            float extent = cmax - cmin;
            if (extent <= 1e-12f) continue;
            float scale = kNumBins / extent;

            Box bin_box[kNumBins];
            int bin_count[kNumBins] = {0};
            for (int i = start; i < end; ++i) {
                int64_t t = perm[i];
                const Vec3 c = centers[t];
                float cv = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
                int b = std::min(int((cv - cmin) * scale), kNumBins - 1);
                bin_count[b]++;
                bin_box[b].extend(tmin(t), tmax(t));
            }

            // Suffix sweep.
            Box right_box[kNumBins];
            Box acc;
            for (int b = kNumBins - 1; b >= 0; --b) {
                acc.extend(bin_box[b]);
                right_box[b] = acc;
            }
            // Prefix sweep + cost.
            Box left_acc;
            int left_count = 0;
            for (int b = 0; b < kNumBins - 1; ++b) {
                left_acc.extend(bin_box[b]);
                left_count += bin_count[b];
                int right_count = n - left_count;
                if (left_count == 0 || right_count == 0) continue;
                float cost = kTraversalCost + kIntersectCost *
                    (left_acc.surface_area() * left_count +
                     right_box[b + 1].surface_area() * right_count) / parent_sa;
                if (cost < best_cost) {
                    best_cost = cost;
                    best_axis = axis;
                    best_edge = cmin + (b + 1) / scale;
                }
            }
        }
        if (best_axis < 0) return false;
        *out_axis = best_axis;
        *out_edge_pos = best_edge;
        *out_cost = best_cost;
        return true;
    }

    void build_range(int node, int start, int end) {
        Box box;
        for (int i = start; i < end; ++i) {
            box.extend(tmin(perm[i]), tmax(perm[i]));
        }
        set_bounds(node, box);
        int n = end - start;

        int axis = -1;
        float edge = 0.0f, cost = 0.0f;
        bool have_split = n > 1 && find_sah_split(start, end, box, &axis, &edge, &cost);

        bool make_leaf;
        int mid = start;
        if (have_split && n <= max_leaf_size) {
            make_leaf = cost >= n * kIntersectCost;
        } else {
            make_leaf = !have_split && n <= max_leaf_size;
        }

        if (!make_leaf && have_split) {
            auto pred = [&](int64_t t) {
                const Vec3 c = centers[t];
                float cv = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
                return cv < edge;
            };
            int64_t* base = perm.data();
            int64_t* m = std::partition(base + start, base + end, pred);
            mid = int(m - base);
            if (mid == start || mid == end) {
                make_leaf = n <= max_leaf_size;
                if (!make_leaf) {
                    mid = start + n / 2;  // median fallback
                    std::nth_element(base + start, base + mid, base + end,
                                     [&](int64_t a, int64_t b) {
                                         float ca = axis == 0 ? centers[a].x
                                                  : (axis == 1 ? centers[a].y : centers[a].z);
                                         float cb = axis == 0 ? centers[b].x
                                                  : (axis == 1 ? centers[b].y : centers[b].z);
                                         return ca < cb;
                                     });
                }
            }
        } else if (!make_leaf) {
            // No valid SAH split but too big for a leaf: median on widest axis.
            Box cbox;
            for (int i = start; i < end; ++i) {
                Vec3 c = centers[perm[i]];
                cbox.extend(c, c);
            }
            float ex = cbox.hi.x - cbox.lo.x;
            float ey = cbox.hi.y - cbox.lo.y;
            float ez = cbox.hi.z - cbox.lo.z;
            axis = ex >= ey ? (ex >= ez ? 0 : 2) : (ey >= ez ? 1 : 2);
            mid = start + n / 2;
            std::nth_element(perm.data() + start, perm.data() + mid,
                             perm.data() + end,
                             [&](int64_t a, int64_t b) {
                                 float ca = axis == 0 ? centers[a].x
                                          : (axis == 1 ? centers[a].y : centers[a].z);
                                 float cb = axis == 0 ? centers[b].x
                                          : (axis == 1 ? centers[b].y : centers[b].z);
                                 return ca < cb;
                             });
        }

        if (make_leaf) {
            out_leaf[node] = 1;
            out_first[node] = start;
            out_count[node] = n;
            return;
        }

        int lchild = alloc_node();
        int rchild = alloc_node();
        out_left[node] = lchild;
        out_right[node] = rchild;
        build_range(lchild, start, mid);
        build_range(rchild, mid, end);
    }
};

}  // namespace

extern "C" int build_bvh_sah(const float* tri_min, const float* tri_max,
                             int num_tris, int max_leaf_size,
                             float* bounds_min, float* bounds_max,
                             int* left, int* right, int* first, int* count,
                             int* is_leaf, long long* perm_out) {
    if (num_tris <= 0 || max_leaf_size < 1) return -1;

    Builder b;
    b.tri_min = tri_min;
    b.tri_max = tri_max;
    b.max_leaf_size = max_leaf_size;
    b.out_bmin = bounds_min;
    b.out_bmax = bounds_max;
    b.out_left = left;
    b.out_right = right;
    b.out_first = first;
    b.out_count = count;
    b.out_leaf = is_leaf;

    b.perm.resize(num_tris);
    b.centers.resize(num_tris);
    for (int i = 0; i < num_tris; ++i) {
        b.perm[i] = i;
        b.centers[i] = {0.5f * (tri_min[3 * i] + tri_max[3 * i]),
                        0.5f * (tri_min[3 * i + 1] + tri_max[3 * i + 1]),
                        0.5f * (tri_min[3 * i + 2] + tri_max[3 * i + 2])};
    }

    int root = b.alloc_node();
    b.build_range(root, 0, num_tris);

    std::memcpy(perm_out, b.perm.data(), sizeof(int64_t) * num_tris);
    return b.node_count;
}
