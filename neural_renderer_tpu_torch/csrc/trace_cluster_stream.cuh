// The clustered walk of the closest-hit trace (TPU kernel
// neural_renderer_tpu/ops/trace_cluster.py::_stream_kernel) and of the
// dual-shell sweep (_sweep_stream_kernel), templated over the pair math:
// trace_cluster_stream.cu instantiates Möller–Trumbore in FP32 (TcsMt,
// mt.cuh), trace_cluster_stream_mxu.cu the matrix formulation with FP64
// mma.sync products (TcsMxu, mt_mxu.cuh); sweep_stream.cu and
// sweep_stream_mxu.cu the sweep's (SweepMt, SweepMxu, at the end: the same
// items, schedule and tile pipeline, no break).
//
// Work items. A worklist block (512 rays, one worklist row of clusters
// sorted by conservative entry t) is cut into 512 / W items of W = 32
// consecutive rays; each item is one CUDA block of 128 threads, and the
// items of one worklist block run on whatever SMs are free. An item walks
// its block's row front to back and breaks when
// !(bound > tmins[j] * 0.9999f - 1e-4f), where bound is the max over ITS
// OWN rays of min(best_t, exit_t). Rows are sorted ascending and an item's
// bound never rises, so an item that stops skips only clusters that could
// change none of its rays, and the block rule's count (the max over all
// 512 rays) is exactly the max of its items' counts: t, ids and the
// reported clusters swept per block equal the block-wide walk's (and the
// twin's) bit for bit, while short items stop early.
//
// Schedule. The grid holds every item; CUDA block i takes worklist block
// order[i / (512 / W)], where `order` sorts the blocks by descending count,
// stably (nr_trace_cluster_order, launched first). Blocks are dispatched
// in index order, so the longest worklists start first and the short ones
// fill the SMs behind them; blocks with count 0 come last and only write
// the miss.
//
// Tile pipeline. Cluster j + 1's 9 KB of triangles is staged with 4-byte
// cp.async into the other half of a double buffer while cluster j is
// swept. The 128 threads split the W rays' work: thread (s, r) takes ray r
// and the s-th of the 128 / W slices of the cluster's triangles (TcsMt), or
// warp (s, g) takes the 32 rays of group g and the s-th slice of the
// cluster's 8-triangle n-tiles (TcsMxu). Each thread keeps its slice's
// closest hit (t, id); the break reads per-ray minima through shared
// memory, and the final hit is the lexicographic (t, id) minimum over the
// slices: the smallest id wins among equal t, as in the twin.
//
// W = 32, TcsMt's triangle-major tile and TcsMxu's two feature chunks were
// the fastest of W = 32/64/128, the row-major tile and one chunk on the
// knot's camera and first-bounce rays (PERF.md, PR 8).
//
// Per cluster: one barrier once the staged tile has landed, one after the
// bound's partials are written (the matrix form adds one after building
// the triangle features). All are over the item's own four warps.
//
// Passengers. Rays with exit_t 0 (inactive, or off the mesh's box) never
// hold a bound; the block rule sweeps them as far as its count and the
// twin returns that walk's hit. A second launch takes every item that
// stopped short of its block's count and holds such a ray on to that
// count (nr_trace_cluster_passengers), so every ray, active or not, ends
// bit-exact to the block rule. It sweeps no more than the block rule.
#pragma once

#include "mt_mxu.cuh"

#define TCS_CLUSTER 256      // triangles per cluster
#define TCS_BLOCK_RAYS 512   // rays per worklist block
#define TCS_ITEM_RAYS 32     // rays per work item (W)
#define TCS_THREADS 128      // threads per item (four warps)
#define TCS_TRI_STRIDE 12    // floats per triangle in a triangle-major tile
// Shared memory per item beyond the dynamic tiles: part, hit_t, hit_id.
#define TCS_STATIC_SMEM (3 * TCS_THREADS * 4)

__device__ __forceinline__ void nr_cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void nr_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void nr_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copies of columns [col0, col0 + 256) of the [9, total]
// triangle array into `dst`: triangle-major (triangle q at dst[12 q], its
// nine values v0, e1, e2 then three unused) or row-major [9][256].
template <bool kTriMajor>
__device__ __forceinline__ void tcs_stage(float* dst,
                                          const float* __restrict__ tris,
                                          long long total, long long col0) {
  for (int e = threadIdx.x; e < 9 * TCS_CLUSTER; e += TCS_THREADS) {
    const int row = e / TCS_CLUSTER;
    const int col = e - row * TCS_CLUSTER;
    nr_cp_async4(kTriMajor ? dst + col * TCS_TRI_STRIDE + row : dst + e,
                 tris + row * total + col0 + col);
  }
}

// FP32 Möller–Trumbore (mt.cuh::nr_mt_t), one ray per thread. Thread
// (s, r) = (tid / W, tid % W) sweeps triangles [s, s + 1) * 256 / S of each
// cluster, reading each from the triangle-major tile as three 16-byte
// broadcast loads.
struct TcsMt {
  static constexpr bool kTriMajor = true;
  static constexpr bool kBreaks = true;
  static constexpr int kTileFloats = TCS_CLUSTER * TCS_TRI_STRIDE;
  static constexpr int kExtraBytes = 0;
  static constexpr int kTris = TCS_CLUSTER * TCS_ITEM_RAYS / TCS_THREADS;

  int mode;  // TraceMode: 0 ANY, 1 FORWARD_ONLY, 2 BACKWARD_ONLY
  float ox, oy, oz, dx, dy, dz, cap, best_t;
  int best_tri;

  __device__ __forceinline__ int ray() const {
    return threadIdx.x % TCS_ITEM_RAYS;
  }
  __device__ __forceinline__ int slot() const { return threadIdx.x; }

  __device__ __forceinline__ void load(const float* __restrict__ o,
                                       const float* __restrict__ d,
                                       int npad,
                                       const float* __restrict__ exit_t,
                                       long long ray0) {
    const long long r = ray0 + ray();
    ox = o[r];
    oy = o[npad + r];
    oz = o[2LL * npad + r];
    dx = d[r];
    dy = d[npad + r];
    dz = d[2LL * npad + r];
    cap = exit_t[r];
    best_t = NR_MISS;
    best_tri = 0;
  }

  __device__ __forceinline__ void sweep(const float* tile, unsigned char*,
                                        int cluster) {
    const int q0 = (threadIdx.x / TCS_ITEM_RAYS) * kTris;
    const int base = cluster * TCS_CLUSTER;
#pragma unroll 4
    for (int q = q0; q < q0 + kTris; ++q) {
      const float4* t4 = reinterpret_cast<const float4*>(tile) + 3 * q;
      const float4 a = t4[0], b = t4[1], c = t4[2];
      float det;
      float t = nr_mt_t(ox, oy, oz, dx, dy, dz, a.x, a.y, a.z, a.w, b.x,
                        b.y, b.z, b.w, c.x, &det);
      if (mode == 1 && !(det > 0.0f)) t = NR_MISS;
      if (mode == 2 && !(det < 0.0f)) t = NR_MISS;
      nr_hit_update(best_t, best_tri, t, base + q);
    }
  }

  // Start slice 0 from the closest hit written by pass 1.
  __device__ __forceinline__ void seed(const float* bt, const int* bi,
                                       long long ray0) {
    if (threadIdx.x < TCS_ITEM_RAYS) {
      best_t = bt[ray0 + ray()];
      best_tri = bi[ray0 + ray()];
    }
  }

  // Entry s * W + r of `part`: the slice's min(best_t, exit_t) of ray r.
  __device__ __forceinline__ void publish_bound(float* part) const {
    part[slot()] = fminf(best_t, cap);
  }

  __device__ __forceinline__ void publish_hit(float* pt, int* pi) {
    pt[slot()] = best_t;
    pi[slot()] = best_tri;
  }
};

// The matrix formulation's pairs of one cluster (mt_mxu.cuh), for the
// clustered trace and the clustered sweep: the 128 threads build the
// features of 256 / TCS_MXU_CHUNKS triangles at a time from the staged
// (row-major) tile into shared memory `extra`; then each warp runs six
// FP64 mma.sync products per 8x8 tile for its four 8-ray m-tiles `a` over
// n-tiles [j0, j0 + kSliceTiles) of the chunk, the FP32 epilogue per
// pair, and hands pair(m, id, t, det) each of the lane's two columns. Two
// chunks halve the feature buffer (24 KB, so five items fit on an SM
// instead of three) for one more barrier pair per cluster.
#define TCS_MXU_CHUNKS 2
#define TCS_MXU_CHUNK_TRIS (TCS_CLUSTER / TCS_MXU_CHUNKS)
#define TCS_MXU_FEAT_BYTES (TCS_MXU_CHUNK_TRIS / 8 * MXU_COMBOS * 32 * 8)

template <int kSliceTiles, class Pair>
__device__ __forceinline__ void tcs_mxu_pairs(const float* tile,
                                              unsigned char* extra,
                                              int cluster,
                                              const double (&a)[MXU_MT][3],
                                              int j0, Pair&& pair) {
  double(*feat)[MXU_COMBOS][32] =
      reinterpret_cast<double(*)[MXU_COMBOS][32]>(extra);
  const int lane = threadIdx.x & 31;
  for (int h = 0; h < TCS_MXU_CHUNKS; ++h) {
    if (h > 0) __syncthreads();  // the previous chunk's features consumed
    for (int q = threadIdx.x; q < TCS_MXU_CHUNK_TRIS; q += TCS_THREADS) {
      float v[9];
#pragma unroll
      for (int r = 0; r < 9; ++r)
        v[r] = tile[r * TCS_CLUSTER + h * TCS_MXU_CHUNK_TRIS + q];
      nr_mxu_features(v, feat[q >> 3], q & 7);
    }
    __syncthreads();  // the chunk's features are built
    for (int j = j0; j < j0 + kSliceTiles; ++j) {
      double b[MXU_COMBOS];
#pragma unroll
      for (int c = 0; c < MXU_COMBOS; ++c) b[c] = feat[j][c][lane];
      const int col = cluster * TCS_CLUSTER + h * TCS_MXU_CHUNK_TRIS +
                      8 * j + 2 * (lane & 3);
#pragma unroll
      for (int m = 0; m < MXU_MT; ++m) {
        const MxuAcc acc = nr_mxu_products(a[m], b);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float det;
          const float t = nr_mxu_pair(acc, i, &det);
          pair(m, col + i, t, det);
        }
      }
    }
  }
}

// The clustered trace in the matrix form: warp (s, g) takes the 32 rays of
// group g and the s-th slice of each chunk's n-tiles; each lane keeps its
// closest hit (t, id) per m-tile.
struct TcsMxu {
  static_assert(TCS_ITEM_RAYS % 32 == 0,
                "the matrix form takes 32 rays per warp");
  static constexpr bool kTriMajor = false;
  static constexpr bool kBreaks = true;
  static constexpr int kTileFloats = 9 * TCS_CLUSTER;
  static constexpr int kExtraBytes = TCS_MXU_FEAT_BYTES;
  static constexpr int kGroups = TCS_ITEM_RAYS / 32;
  // n-tiles of one chunk per warp
  static constexpr int kSliceTiles =
      TCS_MXU_CHUNK_TRIS / 8 * TCS_ITEM_RAYS / TCS_THREADS;

  int mode;  // TraceMode: 0 ANY, 1 FORWARD_ONLY, 2 BACKWARD_ONLY
  double a[MXU_MT][3];
  float cap[MXU_MT], best_t[MXU_MT];
  int best_tri[MXU_MT];

  __device__ __forceinline__ int warp() const { return threadIdx.x >> 5; }
  // Item-relative ray of the lane's row in m-tile m.
  __device__ __forceinline__ int ray(int m) const {
    return (warp() % kGroups) * 32 + m * 8 + ((threadIdx.x & 31) >> 2);
  }
  __device__ __forceinline__ int slot(int m) const {
    return (warp() / kGroups) * TCS_ITEM_RAYS + ray(m);
  }

  __device__ __forceinline__ void load(const float* __restrict__ o,
                                       const float* __restrict__ d,
                                       int npad,
                                       const float* __restrict__ exit_t,
                                       long long ray0) {
#pragma unroll
    for (int m = 0; m < MXU_MT; ++m) {
      const long long r = ray0 + ray(m);
      nr_mxu_ray(o[r], o[npad + r], o[2LL * npad + r], d[r], d[npad + r],
                 d[2LL * npad + r], a[m]);
      cap[m] = exit_t[r];
      best_t[m] = NR_MISS;
      best_tri[m] = 0;
    }
  }

  __device__ __forceinline__ void sweep(const float* tile,
                                        unsigned char* extra, int cluster) {
    tcs_mxu_pairs<kSliceTiles>(
        tile, extra, cluster, a, (warp() / kGroups) * kSliceTiles,
        [&](int m, int id, float t, float det) {
          if (mode == 1 && !(det > 0.0f)) t = NR_MISS;
          if (mode == 2 && !(det < 0.0f)) t = NR_MISS;
          nr_hit_update(best_t[m], best_tri[m], t, id);
        });
  }

  __device__ __forceinline__ void seed(const float* bt, const int* bi,
                                       long long ray0) {
    if (warp() < kGroups && (threadIdx.x & 3) == 0) {
#pragma unroll
      for (int m = 0; m < MXU_MT; ++m) {
        best_t[m] = bt[ray0 + ray(m)];
        best_tri[m] = bi[ray0 + ray(m)];
      }
    }
  }

  __device__ __forceinline__ void publish_bound(float* part) const {
#pragma unroll
    for (int m = 0; m < MXU_MT; ++m) {
      const float v = fminf(nr_quad_min(best_t[m]), cap[m]);
      if ((threadIdx.x & 3) == 0) part[slot(m)] = v;
    }
  }

  __device__ __forceinline__ void publish_hit(float* pt, int* pi) {
#pragma unroll
    for (int m = 0; m < MXU_MT; ++m) {
      nr_quad_hit(best_t[m], best_tri[m]);
      if ((threadIdx.x & 3) == 0) {
        pt[slot(m)] = best_t[m];
        pi[slot(m)] = best_tri[m];
      }
    }
  }
};

// The item's bound from part[s * W + r] = slice s's min(best_t, exit_t) of
// ray r: max over r of min over s. Every warp computes it from the same
// values, so the break is uniform across the item.
__device__ __forceinline__ float tcs_item_bound(const float* part) {
  constexpr int W = TCS_ITEM_RAYS;
  constexpr int kSlices = TCS_THREADS / W;
  const int lane = threadIdx.x & 31;
  float v = 0.0f;
#pragma unroll
  for (int i = 0; i < W / 32; ++i) {
    float mn = part[lane + 32 * i];
#pragma unroll
    for (int s = 1; s < kSlices; ++s)
      mn = fminf(mn, part[s * W + lane + 32 * i]);
    v = i == 0 ? mn : fmaxf(v, mn);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

// Walk row[j0, cnt) of a worklist (tmins trow): stage each cluster while
// the previous one is swept, break (with use_break) once the item's bound
// falls to the next cluster's key (only a pair math that can break, kBreaks:
// the trace's, not the sweep's). Returns the clusters' end index.
template <class M>
__device__ __forceinline__ int tcs_walk(M& m, float* tiles,
                                        unsigned char* extra,
                                        const float* __restrict__ tris,
                                        int ttot, const int* row,
                                        const float* trow, int j0, int cnt,
                                        int use_break, float* part) {
  if (j0 < cnt) {
    tcs_stage<M::kTriMajor>(tiles + (j0 & 1) * M::kTileFloats, tris, ttot,
                            (long long)row[j0] * TCS_CLUSTER);
    nr_cp_async_commit();
  }
  int j = j0;
  while (j < cnt) {
    if (j + 1 < cnt) {
      // The other buffer was last read before the previous iteration's
      // second barrier.
      tcs_stage<M::kTriMajor>(tiles + ((j + 1) & 1) * M::kTileFloats, tris,
                              ttot, (long long)row[j + 1] * TCS_CLUSTER);
      nr_cp_async_commit();
      nr_cp_async_wait<1>();
    } else {
      nr_cp_async_wait<0>();
    }
    __syncthreads();  // cluster j's tile has landed for every thread
    m.sweep(tiles + (j & 1) * M::kTileFloats, extra, row[j]);
    ++j;
    const bool test = M::kBreaks && use_break && j < cnt;
    if constexpr (M::kBreaks) {
      if (test) m.publish_bound(part);
    }
    __syncthreads();  // partials written; tile j and features consumed
    // The margin keeps the prune conservative between the slab entry t
    // and the Möller–Trumbore t.
    if (test && !(tcs_item_bound(part) > trow[j] * 0.9999f - 1e-4f))
      break;
  }
  nr_cp_async_wait<0>();  // a tile staged ahead of the break
  return j;
}

// Fold the slices' closest hits per ray and write the item's rays.
template <class M>
__device__ __forceinline__ void tcs_write(M& m, long long ray0,
                                          float* __restrict__ best_t_out,
                                          int* __restrict__ best_tri_out) {
  constexpr int W = TCS_ITEM_RAYS;
  __shared__ float hit_t[TCS_THREADS];
  __shared__ int hit_id[TCS_THREADS];
  m.publish_hit(hit_t, hit_id);
  __syncthreads();
  if (threadIdx.x < W) {
    float bt = hit_t[threadIdx.x];
    int bi = hit_id[threadIdx.x];
#pragma unroll
    for (int s = 1; s < TCS_THREADS / W; ++s)
      nr_hit_update(bt, bi, hit_t[s * W + threadIdx.x],
                    hit_id[s * W + threadIdx.x]);
    best_t_out[ray0 + threadIdx.x] = bt;
    best_tri_out[ray0 + threadIdx.x] = bi;
  }
}

// Pass 1: item blockIdx.x of worklist block order[blockIdx.x / (512 / W)]
// walks with its own break; item_swept receives its count.
template <class M>
__global__ void __launch_bounds__(TCS_THREADS)
nr_trace_cluster_items(const float* __restrict__ o,
                       const float* __restrict__ d, int npad,
                       const float* __restrict__ tris, int ttot,
                       const int* __restrict__ ids,
                       const float* __restrict__ tmins,
                       const int* __restrict__ counts, int k,
                       const float* __restrict__ exit_t, int mode,
                       int use_break, const int* __restrict__ order,
                       float* __restrict__ best_t_out,
                       int* __restrict__ best_tri_out,
                       int* __restrict__ item_swept) {
  constexpr int kItems = TCS_BLOCK_RAYS / TCS_ITEM_RAYS;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float part[TCS_THREADS];
  const int b = order[blockIdx.x / kItems];
  const int item = blockIdx.x % kItems;
  const long long ray0 =
      (long long)b * TCS_BLOCK_RAYS + item * TCS_ITEM_RAYS;
  M m;
  m.mode = mode;
  m.load(o, d, npad, exit_t, ray0);
  const int j = tcs_walk<M>(
      m, reinterpret_cast<float*>(smem),
      smem + 2 * M::kTileFloats * sizeof(float), tris, ttot,
      ids + (long long)b * k, tmins + (long long)b * k, 0, counts[b],
      use_break, part);
  tcs_write<M>(m, ray0, best_t_out, best_tri_out);
  if (threadIdx.x == 0) item_swept[(long long)b * kItems + item] = j;
}

// Pass 2, the passengers: rays with exit_t 0 (inactive, or off the mesh's
// box) never hold a bound, so the block rule sweeps them as far as its
// count, the max over the block's items, and the twin returns that walk's
// closest hit for them too. An item that stopped short of its block's
// count and holds such a ray sweeps on from its count to the block's,
// from its pass-1 result, with no break. Its other rays cannot change
// there (the break's argument), so every ray ends bit-exact to the block
// rule. (Gathering a block's passengers into dense rounds instead swept
// fewer rays but took longer on the knot's GT pass and training step;
// PERF.md has the measurement.)
template <class M>
__global__ void __launch_bounds__(TCS_THREADS)
nr_trace_cluster_passengers(const float* __restrict__ o,
                            const float* __restrict__ d, int npad,
                            const float* __restrict__ tris, int ttot,
                            const int* __restrict__ ids, int k,
                            const float* __restrict__ exit_t, int mode,
                            const int* __restrict__ order,
                            float* __restrict__ best_t_out,
                            int* __restrict__ best_tri_out,
                            const int* __restrict__ item_swept) {
  constexpr int kItems = TCS_BLOCK_RAYS / TCS_ITEM_RAYS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = order[blockIdx.x / kItems];
  const int item = blockIdx.x % kItems;
  const int* mine = item_swept + (long long)b * kItems;
  int block_count = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) block_count = max(block_count, mine[i]);
  const int j0 = mine[item];
  if (j0 >= block_count) return;
  const long long ray0 =
      (long long)b * TCS_BLOCK_RAYS + item * TCS_ITEM_RAYS;
  const bool rider =
      threadIdx.x < TCS_ITEM_RAYS && !(exit_t[ray0 + threadIdx.x] > 0.0f);
  if (!__syncthreads_or(rider)) return;
  M m;
  m.mode = mode;
  m.load(o, d, npad, exit_t, ray0);
  m.seed(best_t_out, best_tri_out, ray0);
  tcs_walk<M>(m, reinterpret_cast<float*>(smem),
              smem + 2 * M::kTileFloats * sizeof(float), tris, ttot,
              ids + (long long)b * k, nullptr, j0, block_count, 0, nullptr);
  tcs_write<M>(m, ray0, best_t_out, best_tri_out);
}

// The schedule: order[rank] = b, the nb worklist blocks ranked by
// descending count, ties by block index (a stable descending sort, as
// ops/trace_cluster.py::work_order). Thread b counts the blocks ahead of
// its own, the counts staged through shared memory.
__global__ void __launch_bounds__(TCS_THREADS)
nr_trace_cluster_order(const int* __restrict__ counts, int nb,
                       int* __restrict__ order) {
  __shared__ int chunk[TCS_THREADS];
  const int b = blockIdx.x * TCS_THREADS + threadIdx.x;
  const int mine = b < nb ? counts[b] : 0;
  int rank = 0;
  for (int base = 0; base < nb; base += TCS_THREADS) {
    __syncthreads();
    const int i = base + threadIdx.x;
    if (i < nb) chunk[threadIdx.x] = counts[i];
    __syncthreads();
    const int n = min(TCS_THREADS, nb - base);
    for (int q = 0; q < n; ++q) {
      const int c = chunk[q];
      rank += (c > mine) || (c == mine && base + q < b);
    }
  }
  if (b < nb) order[rank] = b;
}

// Launch the rank kernel over the nb worklist blocks.
inline void tcs_rank(const int* counts, int nb, int* order,
                     cudaStream_t stream) {
  nr_trace_cluster_order<<<(nb + TCS_THREADS - 1) / TCS_THREADS,
                           TCS_THREADS, 0, stream>>>(counts, nb, order);
}

// Rank the npad / 512 worklist blocks into `order` ([npad / 512] int32
// scratch), then launch both passes over every item. item_swept ([npad /
// W] int32 scratch) receives each item's clusters swept in pass 1, at
// b * (512 / W) + item. Both passes stay within the 48 KB of shared memory
// a launch takes without an opt-in attribute.
template <class M>
int nr_trace_cluster_items_launch(const float* o, const float* d, int npad,
                                  const float* tris, int ttot,
                                  const int* ids, const float* tmins,
                                  const int* counts, int k,
                                  const float* exit_t, int mode,
                                  int use_break, int* order,
                                  float* best_t, int* best_tri,
                                  int* item_swept, cudaStream_t stream) {
  constexpr int smem = 2 * M::kTileFloats * sizeof(float) + M::kExtraBytes;
  static_assert(smem + TCS_STATIC_SMEM <= 48 * 1024,
                "an item's shared memory needs an opt-in attribute");
  const int items = npad / TCS_ITEM_RAYS;
  if (items == 0) return static_cast<int>(cudaGetLastError());
  tcs_rank(counts, npad / TCS_BLOCK_RAYS, order, stream);
  nr_trace_cluster_items<M><<<items, TCS_THREADS, smem, stream>>>(
      o, d, npad, tris, ttot, ids, tmins, counts, k, exit_t, mode, use_break,
      order, best_t, best_tri, item_swept);
  if (use_break) {
    nr_trace_cluster_passengers<M><<<items, TCS_THREADS, smem, stream>>>(
        o, d, npad, tris, ttot, ids, k, exit_t, mode, order, best_t,
        best_tri, item_swept);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- The clustered dual-shell sweep (K1, K1-MXU) ----------------------
//
// The same walk with no break: every item sweeps its block's whole list,
// which holds outer clusters (id < outer) before inner ones in one id
// space. Per ray the thread folds its slice of each cluster into five
// accumulators: the outer shell's strict forward pair (m1f, m2f) and
// backward min, the inner shell's forward and backward mins (forward is
// det > 0). Outer or inner is decided once per cluster (uniform across the
// item) and the second forward crossing is a template argument, so
// neither is tested per pair. At the end the slices fold per ray through
// shared memory, the pair by the strict-pair multiset rule
// (nr_pair_merge), the rest by min: selections over the multiset of t's,
// so the result is the twin's bit for bit whatever the slicing.
//
// W = 64 for both, and two rays per thread for SweepMt: of W = 32, 64 and
// 128 (and two rays per thread at 64 and 128) the fastest or within 7% of
// it on every case measured: the sphere frame's camera and bounce
// sweeps, the knot's camera sweep and the whole 1080p camera sweep
// (PERF.md). Items of 32 rays stage each cluster once per 32 rays
// and cost the full frame 7%; items of 128 spread a 131,072-ray call over
// too few blocks and cost it 20-35%.
#define SWEEP_MT_ITEM_RAYS 64    // rays per item (W)
#define SWEEP_MT_RAYS 2          // rays per thread (R)
#define SWEEP_MXU_ITEM_RAYS 64   // rays per item (W)

// FP32 Möller–Trumbore: thread (s, l) = (tid / L, tid % L), L = W / R,
// takes rays l + i L (i < R) and triangles [s, s + 1) * 256 / S of each
// cluster, S = 128 / L slices (4 of 64 triangles), each triangle read
// from the triangle-major tile as three 16-byte broadcast loads and swept
// against its R rays: half the shared loads per pair of one ray a thread.
template <bool kFwd2>
struct SweepMt {
  static constexpr bool kTriMajor = true;
  static constexpr bool kBreaks = false;
  static constexpr bool kWithFwd2 = kFwd2;
  static constexpr int kTileFloats = TCS_CLUSTER * TCS_TRI_STRIDE;
  static constexpr int kExtraBytes = 0;
  static constexpr int kItemRays = SWEEP_MT_ITEM_RAYS;
  static constexpr int kRays = SWEEP_MT_RAYS;
  static constexpr int kLanes = kItemRays / kRays;
  static constexpr int kSlices = TCS_THREADS / kLanes;
  static constexpr int kTris = TCS_CLUSTER / kSlices;

  int outer;
  float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays];
  float m1f[kRays], m2f[kRays], m1b[kRays], i1f[kRays], i1b[kRays];

  __device__ __forceinline__ int ray(int i) const {
    return threadIdx.x % kLanes + i * kLanes;
  }
  __device__ __forceinline__ int slot(int i) const {
    return (threadIdx.x / kLanes) * kItemRays + ray(i);
  }

  __device__ __forceinline__ void load(const float* __restrict__ o,
                                       const float* __restrict__ d,
                                       int npad, long long ray0) {
#pragma unroll
    for (int i = 0; i < kRays; ++i) {
      const long long r = ray0 + ray(i);
      ox[i] = o[r];
      oy[i] = o[npad + r];
      oz[i] = o[2LL * npad + r];
      dx[i] = d[r];
      dy[i] = d[npad + r];
      dz[i] = d[2LL * npad + r];
      m1f[i] = m2f[i] = m1b[i] = i1f[i] = i1b[i] = NR_MISS;
    }
  }

  // pair(i, t, det) for each pair of the thread's rays and slice.
  template <class Pair>
  __device__ __forceinline__ void pairs(const float* tile, Pair&& pair) {
    const int q0 = (threadIdx.x / kLanes) * kTris;
#pragma unroll 4
    for (int q = q0; q < q0 + kTris; ++q) {
      const float4* t4 = reinterpret_cast<const float4*>(tile) + 3 * q;
      const float4 a = t4[0], b = t4[1], c = t4[2];
#pragma unroll
      for (int i = 0; i < kRays; ++i) {
        float det;
        const float t = nr_mt_t(ox[i], oy[i], oz[i], dx[i], dy[i], dz[i],
                                a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                                c.x, &det);
        pair(i, t, det);
      }
    }
  }

  __device__ __forceinline__ void sweep(const float* tile, unsigned char*,
                                        int cluster) {
    if (cluster < outer) {
      pairs(tile, [&](int i, float t, float det) {
        nr_sweep_outer(kFwd2, t, det, m1f[i], m2f[i], m1b[i]);
      });
    } else {
      pairs(tile, [&](int i, float t, float det) {
        nr_sweep_inner(t, det, i1f[i], i1b[i]);
      });
    }
  }

  // Row q of `acc` [5][S * W], entry s * W + r: slice s's accumulator q
  // (m1f, m1b, i1f, i1b, m2f) of ray r.
  __device__ __forceinline__ void publish(float* acc) {
    constexpr int n = kSlices * kItemRays;
#pragma unroll
    for (int i = 0; i < kRays; ++i) {
      acc[slot(i)] = m1f[i];
      acc[n + slot(i)] = m1b[i];
      acc[2 * n + slot(i)] = i1f[i];
      acc[3 * n + slot(i)] = i1b[i];
      acc[4 * n + slot(i)] = m2f[i];
    }
  }
};

// The matrix form: warp (s, g) takes the 32 rays of group g (W / 32
// groups) and the s-th of the S = 4 / (W / 32) slices of each chunk's
// n-tiles (tcs_mxu_pairs; at W = 64 two halves of 8 n-tiles); the lane
// folds its two columns per n-tile into its rays' accumulators, then the
// ray's quad merges them.
template <bool kFwd2>
struct SweepMxu {
  static_assert(SWEEP_MXU_ITEM_RAYS % 32 == 0,
                "the matrix form takes 32 rays per warp");
  static constexpr bool kTriMajor = false;
  static constexpr bool kBreaks = false;
  static constexpr bool kWithFwd2 = kFwd2;
  static constexpr int kTileFloats = 9 * TCS_CLUSTER;
  static constexpr int kExtraBytes = TCS_MXU_FEAT_BYTES;
  static constexpr int kItemRays = SWEEP_MXU_ITEM_RAYS;
  static constexpr int kGroups = kItemRays / 32;
  static constexpr int kSlices = TCS_THREADS / kItemRays;
  static constexpr int kSliceTiles = TCS_MXU_CHUNK_TRIS / 8 / kSlices;

  int outer;
  double a[MXU_MT][3];
  MxuSweep s;

  __device__ __forceinline__ int warp() const { return threadIdx.x >> 5; }
  __device__ __forceinline__ int ray(int m) const {
    return (warp() % kGroups) * 32 + m * 8 + ((threadIdx.x & 31) >> 2);
  }
  __device__ __forceinline__ int slot(int m) const {
    return (warp() / kGroups) * kItemRays + ray(m);
  }

  __device__ __forceinline__ void load(const float* __restrict__ o,
                                       const float* __restrict__ d,
                                       int npad, long long ray0) {
#pragma unroll
    for (int m = 0; m < MXU_MT; ++m) {
      const long long r = ray0 + ray(m);
      nr_mxu_ray(o[r], o[npad + r], o[2LL * npad + r], d[r], d[npad + r],
                 d[2LL * npad + r], a[m]);
    }
    nr_sweep_init(s);
  }

  __device__ __forceinline__ void sweep(const float* tile,
                                        unsigned char* extra, int cluster) {
    const int j0 = (warp() / kGroups) * kSliceTiles;
    if (cluster < outer) {
      tcs_mxu_pairs<kSliceTiles>(
          tile, extra, cluster, a, j0, [&](int m, int, float t, float det) {
            nr_sweep_outer(kFwd2, t, det, s.m1f[m], s.m2f[m], s.m1b[m]);
          });
    } else {
      tcs_mxu_pairs<kSliceTiles>(
          tile, extra, cluster, a, j0, [&](int m, int, float t, float det) {
            nr_sweep_inner(t, det, s.i1f[m], s.i1b[m]);
          });
    }
  }

  __device__ __forceinline__ void publish(float* acc) {
    constexpr int n = kSlices * kItemRays;
    nr_sweep_quad(s, kFwd2);
    if ((threadIdx.x & 3) == 0) {
#pragma unroll
      for (int m = 0; m < MXU_MT; ++m) {
        acc[slot(m)] = s.m1f[m];
        acc[n + slot(m)] = s.m1b[m];
        acc[2 * n + slot(m)] = s.i1f[m];
        acc[3 * n + slot(m)] = s.i1b[m];
        acc[4 * n + slot(m)] = s.m2f[m];
      }
    }
  }
};

// Item blockIdx.x of worklist block order[blockIdx.x / (512 / W)] sweeps
// the block's whole list, folds its slices per ray through shared memory
// (the tile buffers, consumed once the walk returns) and writes its rays'
// rows outer_fwd, outer_bwd, inner_fwd, inner_bwd[, outer_fwd2] of out.
template <class M>
__global__ void __launch_bounds__(TCS_THREADS)
nr_sweep_cluster_items(const float* __restrict__ o,
                       const float* __restrict__ d, int npad,
                       const float* __restrict__ tris, int ttot,
                       const int* __restrict__ ids,
                       const int* __restrict__ counts, int k, int outer,
                       const int* __restrict__ order,
                       float* __restrict__ out) {
  constexpr int W = M::kItemRays;
  constexpr int kItems = TCS_BLOCK_RAYS / W;
  constexpr int n = M::kSlices * W;
  static_assert(5 * n <= 2 * M::kTileFloats,
                "the slices' accumulators fit in the tile buffers");
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);
  const int b = order[blockIdx.x / kItems];
  const long long ray0 =
      (long long)b * TCS_BLOCK_RAYS + (blockIdx.x % kItems) * W;
  M m;
  m.outer = outer;
  m.load(o, d, npad, ray0);
  tcs_walk<M>(m, acc, smem + 2 * M::kTileFloats * sizeof(float), tris, ttot,
              ids + (long long)b * k, nullptr, 0, counts[b], 0, nullptr);
  m.publish(acc);
  __syncthreads();
  if (threadIdx.x < W) {
    const int r = threadIdx.x;
    float m1f = acc[r], m1b = acc[n + r], i1f = acc[2 * n + r];
    float i1b = acc[3 * n + r], m2f = acc[4 * n + r];
#pragma unroll
    for (int s = 1; s < M::kSlices; ++s) {
      const int e = s * W + r;
      if constexpr (M::kWithFwd2) {
        nr_pair_merge(m1f, m2f, acc[e], acc[4 * n + e]);
      } else {
        m1f = fminf(m1f, acc[e]);
      }
      m1b = fminf(m1b, acc[n + e]);
      i1f = fminf(i1f, acc[2 * n + e]);
      i1b = fminf(i1b, acc[3 * n + e]);
    }
    out[ray0 + r] = m1f;
    out[npad + ray0 + r] = m1b;
    out[2LL * npad + ray0 + r] = i1f;
    out[3LL * npad + ray0 + r] = i1b;
    if constexpr (M::kWithFwd2) out[4LL * npad + ray0 + r] = m2f;
  }
}

// Rank the npad / 512 worklist blocks into `order` ([npad / 512] int32
// scratch), then launch every item of the sweep with pair math M<fwd2>.
// Stays within the 48 KB of shared memory a launch takes without an
// opt-in attribute.
template <template <bool> class M>
int nr_sweep_cluster_items_launch(const float* o, const float* d, int npad,
                                  const float* tris, int ttot,
                                  const int* ids, const int* counts, int k,
                                  int outer, int with_fwd2, int* order,
                                  float* out, cudaStream_t stream) {
  constexpr int smem =
      2 * M<true>::kTileFloats * sizeof(float) + M<true>::kExtraBytes;
  static_assert(smem <= 48 * 1024,
                "an item's shared memory needs an opt-in attribute");
  const int nb = npad / TCS_BLOCK_RAYS;
  if (nb == 0) return static_cast<int>(cudaGetLastError());
  const int items = npad / M<true>::kItemRays;
  tcs_rank(counts, nb, order, stream);
  if (with_fwd2) {
    nr_sweep_cluster_items<M<true>><<<items, TCS_THREADS, smem, stream>>>(
        o, d, npad, tris, ttot, ids, counts, k, outer, order, out);
  } else {
    nr_sweep_cluster_items<M<false>><<<items, TCS_THREADS, smem, stream>>>(
        o, d, npad, tris, ttot, ids, counts, k, outer, order, out);
  }
  return static_cast<int>(cudaGetLastError());
}
