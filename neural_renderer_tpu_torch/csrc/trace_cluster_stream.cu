// Clustered closest-hit trace (replaces the TPU kernel
// neural_renderer_tpu/ops/trace_cluster.py::_stream_kernel).
//
// One block per 512-ray worklist block, one thread per ray. The block walks
// its own worklist row front to back (clusters sorted by conservative entry
// t), stages each listed cluster's [9, 256] triangle tile (9 KB) in shared
// memory and sweeps it with (best_t, best_tri) in registers. After each
// cluster the block takes bound = max over its rays of min(best_t, exit_t)
// (warp shuffles, then 16 partials through shared memory) and BREAKS when
// the next cluster's entry t lies beyond it: every thread reads the same
// partials, so the decision is uniform and no barrier is left waiting.
// exit_t is 0 for inactive rays and rays that miss the mesh AABB, so they
// never hold a block open. The break changes the work, never a result.
//
// Ties: smallest triangle id among equal t (the brute-force oracle's rule).
// Clusters are visited by entry t, not by id, so the update is
// t < best || (t == best && id < best_id). TraceMode: 0 ANY, 1 FORWARD_ONLY
// (det > 0), 2 BACKWARD_ONLY (det < 0). Blocks with count 0 write a miss
// with id 0.
//
// Bound: FP32 operations, ~45 per swept (ray, triangle) pair; `swept`
// (optional) reports the clusters each block swept before its break.
#include "mt.cuh"

#define TCS_BLOCK_RAYS 512
#define TCS_CLUSTER 256
#define TCS_WARPS (TCS_BLOCK_RAYS / 32)

__global__ void __launch_bounds__(TCS_BLOCK_RAYS)
trace_cluster_stream_kernel(const float* __restrict__ o,
                            const float* __restrict__ d, int npad,
                            const float* __restrict__ tris, int ttot,
                            const int* __restrict__ ids,
                            const float* __restrict__ tmins,
                            const int* __restrict__ counts, int k,
                            const float* __restrict__ exit_t, int mode,
                            int use_break, float* __restrict__ best_t_out,
                            int* __restrict__ best_tri_out,
                            int* __restrict__ swept) {
  __shared__ float tile[9][TCS_CLUSTER];
  __shared__ float partial[TCS_WARPS];
  const int b = blockIdx.x;
  const long long r = (long long)b * TCS_BLOCK_RAYS + threadIdx.x;
  const float ox = o[r], oy = o[npad + r], oz = o[2LL * npad + r];
  const float dx = d[r], dy = d[npad + r], dz = d[2LL * npad + r];
  const float cap = exit_t[r];
  float best_t = NR_MISS;
  int best_tri = 0;
  const int cnt = counts[b];
  const int* row = ids + (long long)b * k;
  const float* trow = tmins + (long long)b * k;
  int j = 0;
  while (j < cnt) {
    const int c = row[j];
    __syncthreads();  // previous tile and partials fully consumed
    nr_stage_tile<TCS_CLUSTER>(tile, tris, ttot, (long long)c * TCS_CLUSTER);
    __syncthreads();
    const int base = c * TCS_CLUSTER;
#pragma unroll 4
    for (int q = 0; q < TCS_CLUSTER; ++q) {
      float det;
      float t = nr_mt_t(ox, oy, oz, dx, dy, dz, tile[0][q], tile[1][q],
                        tile[2][q], tile[3][q], tile[4][q], tile[5][q],
                        tile[6][q], tile[7][q], tile[8][q], &det);
      if (mode == 1 && !(det > 0.0f)) t = NR_MISS;
      if (mode == 2 && !(det < 0.0f)) t = NR_MISS;
      const int id = base + q;
      if (t < best_t || (t == best_t && id < best_tri)) {
        best_t = t;
        best_tri = id;
      }
    }
    ++j;
    if (!use_break || j >= cnt) continue;
    float v = fminf(best_t, cap);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
    if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = v;
    __syncthreads();
    float bound = partial[0];
#pragma unroll
    for (int w = 1; w < TCS_WARPS; ++w) bound = fmaxf(bound, partial[w]);
    // The margin keeps the prune conservative between the slab entry t and
    // the Möller–Trumbore t.
    if (!(bound > trow[j] * 0.9999f - 1e-4f)) break;
  }
  best_t_out[r] = best_t;
  best_tri_out[r] = best_tri;
  if (swept != nullptr && threadIdx.x == 0) swept[b] = j;
}

extern "C" int trace_cluster_stream(const float* o, const float* d, int npad,
                                    const float* tris, int ttot,
                                    const int* ids, const float* tmins,
                                    const int* counts, int k,
                                    const float* exit_t, int mode,
                                    int use_break, float* best_t,
                                    int* best_tri, int* swept,
                                    cudaStream_t stream) {
  const int nb = npad / TCS_BLOCK_RAYS;
  if (nb > 0) {
    trace_cluster_stream_kernel<<<nb, TCS_BLOCK_RAYS, 0, stream>>>(
        o, d, npad, tris, ttot, ids, tmins, counts, k, exit_t, mode,
        use_break, best_t, best_tri, swept);
  }
  return static_cast<int>(cudaGetLastError());
}

NR_ERROR_STRING_ENTRY
