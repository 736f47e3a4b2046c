// Dense closest-hit trace, matrix formulation (replaces the TPU kernel
// neural_renderer_tpu/ops/trace_mxu.py::_mxu_kernel, NR_TRACE_MXU=1).
//
// One block of 16 warps per 512 rays (the TPU kernel's block, so the skip
// flag means the same thing); each warp owns 32 rays as four 8-ray m-tiles
// and keeps their A fragments in registers. The block builds the features
// of 128 triangles at a time into shared memory (24 KB, B-fragment order,
// csrc/mt_mxu.cuh); each warp then runs, per 8-triangle n-tile, six FP64
// mma.sync products for each of its m-tiles with the B fragments loaded
// once, and the FP32 epilogue per pair. Each lane keeps the best (t, id) of
// its ray over its columns; the ray's quad reduces once at the end: min t,
// the smallest id among equal t. A block whose skip flag is 0 writes misses
// without touching a triangle. TraceMode: 0 ANY, 1 FORWARD_ONLY (det > 0),
// 2 BACKWARD_ONLY (det < 0).
//
// Bound (ops/bounds.py): the FP64 tensor products, the function's 38 flops
// per (ray, triangle) pair of the live blocks (48 as issued, k4
// granularity) at 67 TFLOP/s (H100 SXM), against the epilogue's 9 FP32
// operations (5 arithmetic, 4 FP64-to-FP32 conversions). The design reads
// each B fragment once per n-tile for all four m-tiles, so shared-memory
// traffic stays under the tensor work.
#include "mt_mxu.cuh"

__global__ void __launch_bounds__(MXU_BLOCK_RAYS)
trace_dense_mxu_kernel(const float* __restrict__ o,
                       const float* __restrict__ d, int npad,
                       const float* __restrict__ tris, int ttot,
                       const int* __restrict__ block_mask, int mode,
                       float* __restrict__ out) {
  __shared__ MxuTile tile;
  const int lane = threadIdx.x & 31;
  if (block_mask[blockIdx.x] == 0) {  // uniform across the block
    const long long r = (long long)blockIdx.x * MXU_BLOCK_RAYS + threadIdx.x;
    out[r] = NR_MISS;
    out[npad + r] = __int_as_float(0);
    return;
  }
  double a[MXU_MT][3];
  nr_mxu_rays(o, d, npad, a);
  float best_t[MXU_MT];
  int best_tri[MXU_MT];
#pragma unroll
  for (int m = 0; m < MXU_MT; ++m) {
    best_t[m] = NR_MISS;
    best_tri[m] = 0;
  }
  for (int base = 0; base < ttot; base += MXU_TILE) {
    __syncthreads();  // previous tile fully consumed
    nr_mxu_stage(&tile, tris, ttot, base);
    __syncthreads();
    for (int j = 0; j < MXU_TILE / 8; ++j) {
      double b[MXU_COMBOS];
      nr_mxu_load_b(&tile, j, b);
      const int col = base + 8 * j + 2 * (lane & 3);
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
#pragma unroll
  for (int m = 0; m < MXU_MT; ++m) {
    nr_quad_hit(best_t[m], best_tri[m]);
    if ((lane & 3) == 0) {
      const long long r = nr_mxu_ray_index(m);
      out[r] = best_t[m];
      out[npad + r] = __int_as_float(best_tri[m]);
    }
  }
}

extern "C" int trace_dense_mxu(const float* o, const float* d, int npad,
                               const float* tris, int ttot,
                               const int* block_mask, int mode, float* out,
                               cudaStream_t stream) {
  const int nb = npad / MXU_BLOCK_RAYS;
  if (nb > 0) {
    trace_dense_mxu_kernel<<<nb, MXU_BLOCK_RAYS, 0, stream>>>(
        o, d, npad, tris, ttot, block_mask, mode, out);
  }
  return static_cast<int>(cudaGetLastError());
}

NR_ERROR_STRING_ENTRY
