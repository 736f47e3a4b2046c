// Clustered closest-hit trace, matrix formulation (replaces the mxu=True
// body of the TPU kernel neural_renderer_tpu/ops/trace_cluster.py::
// _stream_kernel, `_sweep_cluster` :156-191, NR_TRACE_MXU=1).
//
// One block of 16 warps per 512-ray worklist block, walking its own
// worklist row front to back (clusters sorted by conservative entry t). For
// each cluster the block builds the features of its 256 triangles in two
// 128-triangle steps into shared memory (csrc/mt_mxu.cuh); each warp runs
// six FP64 mma.sync products per 8x8 tile for its four 8-ray m-tiles, the
// FP32 epilogue per pair, and folds the lane's two columns into the lane's
// best (t, id) per ray. After each cluster the block takes bound = max over
// its rays of min(best_t, exit_t) (quad min, warp max, 16 partials through
// shared memory) and BREAKS when the next cluster's entry t lies beyond it,
// with csrc/trace_cluster_stream.cu's margin: every thread reads the same
// partials, so the decision is uniform. exit_t is 0 for inactive rays and
// rays that miss the mesh AABB. The break changes the work, never a result.
//
// Ties: smallest triangle id among equal t (the brute-force oracle's rule;
// clusters go by entry t, so the update compares ids). TraceMode: 0 ANY,
// 1 FORWARD_ONLY (det > 0), 2 BACKWARD_ONLY (det < 0). Blocks with count 0
// write a miss with id 0.
//
// Bound: the FP64 tensor products, the function's 38 flops per swept (ray,
// triangle) pair (48 as issued) at 67 TFLOP/s (H100 SXM); `swept`
// (optional) reports the clusters each block swept before its break.
#include "mt_mxu.cuh"

#define TCM_CLUSTER 256

__global__ void __launch_bounds__(MXU_BLOCK_RAYS)
trace_cluster_stream_mxu_kernel(const float* __restrict__ o,
                                const float* __restrict__ d, int npad,
                                const float* __restrict__ tris, int ttot,
                                const int* __restrict__ ids,
                                const float* __restrict__ tmins,
                                const int* __restrict__ counts, int k,
                                const float* __restrict__ exit_t, int mode,
                                int use_break,
                                float* __restrict__ best_t_out,
                                int* __restrict__ best_tri_out,
                                int* __restrict__ swept) {
  __shared__ MxuTile tile;
  __shared__ float partial[MXU_WARPS];
  const int lane = threadIdx.x & 31;
  double a[MXU_MT][3];
  nr_mxu_rays(o, d, npad, a);
  float cap[MXU_MT], best_t[MXU_MT];
  int best_tri[MXU_MT];
#pragma unroll
  for (int m = 0; m < MXU_MT; ++m) {
    cap[m] = exit_t[nr_mxu_ray_index(m)];
    best_t[m] = NR_MISS;
    best_tri[m] = 0;
  }
  const int cnt = counts[blockIdx.x];
  const int* row = ids + (long long)blockIdx.x * k;
  const float* trow = tmins + (long long)blockIdx.x * k;
  int jc = 0;
  while (jc < cnt) {
    const int c = row[jc];
    for (int half = 0; half < TCM_CLUSTER; half += MXU_TILE) {
      __syncthreads();  // previous tile and partials fully consumed
      nr_mxu_stage(&tile, tris, ttot, (long long)c * TCM_CLUSTER + half);
      __syncthreads();
      for (int j = 0; j < MXU_TILE / 8; ++j) {
        double b[MXU_COMBOS];
        nr_mxu_load_b(&tile, j, b);
        const int col = c * TCM_CLUSTER + half + 8 * j + 2 * (lane & 3);
#pragma unroll
        for (int m = 0; m < MXU_MT; ++m) {
          const MxuAcc acc = nr_mxu_products(a[m], b);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float det;
            float t = nr_mxu_pair(acc, i, &det);
            if (mode == 1 && !(det > 0.0f)) t = NR_MISS;
            if (mode == 2 && !(det < 0.0f)) t = NR_MISS;
            nr_hit_update(best_t[m], best_tri[m], t, col + i);
          }
        }
      }
    }
    ++jc;
    if (!use_break || jc >= cnt) continue;
    float v = 0.0f;
#pragma unroll
    for (int m = 0; m < MXU_MT; ++m)
      v = fmaxf(v, fminf(nr_quad_min(best_t[m]), cap[m]));
#pragma unroll
    for (int s = 4; s < 32; s <<= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
    if (lane == 0) partial[threadIdx.x >> 5] = v;
    __syncthreads();
    float bound = partial[0];
#pragma unroll
    for (int w = 1; w < MXU_WARPS; ++w) bound = fmaxf(bound, partial[w]);
    // The margin keeps the prune conservative between the slab entry t and
    // the Möller–Trumbore t.
    if (!(bound > trow[jc] * 0.9999f - 1e-4f)) break;
  }
#pragma unroll
  for (int m = 0; m < MXU_MT; ++m) {
    nr_quad_hit(best_t[m], best_tri[m]);
    if ((lane & 3) == 0) {
      const long long r = nr_mxu_ray_index(m);
      best_t_out[r] = best_t[m];
      best_tri_out[r] = best_tri[m];
    }
  }
  if (swept != nullptr && threadIdx.x == 0) swept[blockIdx.x] = jc;
}

extern "C" int trace_cluster_stream_mxu(const float* o, const float* d,
                                        int npad, const float* tris,
                                        int ttot, const int* ids,
                                        const float* tmins, const int* counts,
                                        int k, const float* exit_t, int mode,
                                        int use_break, float* best_t,
                                        int* best_tri, int* swept,
                                        cudaStream_t stream) {
  const int nb = npad / MXU_BLOCK_RAYS;
  if (nb > 0) {
    trace_cluster_stream_mxu_kernel<<<nb, MXU_BLOCK_RAYS, 0, stream>>>(
        o, d, npad, tris, ttot, ids, tmins, counts, k, exit_t, mode,
        use_break, best_t, best_tri, swept);
  }
  return static_cast<int>(cudaGetLastError());
}

NR_ERROR_STRING_ENTRY
