// Dense closest-hit trace, matrix formulation (replaces the TPU kernel
// neural_renderer_tpu/ops/trace_mxu.py::_mxu_kernel, NR_TRACE_MXU=1).
//
// Per ray the closest hit (t, the smallest id among equal t) of [3, Npad]
// rays against [9, T] triangles, TraceMode 0 ANY, 1 FORWARD_ONLY (det > 0),
// 2 BACKWARD_ONLY (det < 0); rays of a 512-ray block whose skip flag is 0
// report a miss with id 0 without touching a triangle.
//
// Three launches (csrc/mt_mxu.cuh, "the dense kernels"): the triangles'
// features once into the scratch `feat`; the walk, one CTA per DX_RAYS rays
// and triangle slice, each lane keeping the best (t, id) of its two rows (a
// strict < suffices: it visits its ids in increasing order) and its quad
// reducing them at the end by (t, id); with more than one slice, a fold of
// the slices' partial rows per ray.
//
// Bound (ops/bounds.py): the FP64 tensor products, the function's 38 flops
// per (ray, triangle) pair of the live blocks (48 as issued, k4
// granularity) at 67 TFLOP/s (H100 SXM), against the FP32 epilogue. The
// prefilter leaves the epilogue and its four FP64-to-FP32 conversions to
// the few pair slots where some pair may hit, so the products and the
// prefilter's FP32 operations remain.
#include "mt_mxu.cuh"

template <int kMode>
__global__ void __launch_bounds__(DX_THREADS)
trace_dense_mxu_kernel(const float* __restrict__ o,
                       const float* __restrict__ d, int npad,
                       const double* __restrict__ feat, int nchunks,
                       const int* __restrict__ block_mask, int slices,
                       float* __restrict__ out) {
  __shared__ __align__(16) double buf[2 * DX_CHUNK * DX_FRAG];
  const long long ray0 = (long long)blockIdx.x * DX_RAYS;
  const int s = blockIdx.y;
  if (block_mask[ray0 / NR_SKIP_RAYS] == 0) {  // uniform across the CTA
    if (slices == 1) {
      for (int i = threadIdx.x; i < DX_RAYS; i += DX_THREADS) {
        out[ray0 + i] = NR_MISS;
        out[npad + ray0 + i] = __int_as_float(0);
      }
    }
    return;  // with slices the fold writes the miss
  }
  DxRays a;
  nr_dx_rays(o, d, npad, nr_dx_ray(ray0), a);
  float bt[2] = {NR_MISS, NR_MISS};  // rows g and g + 8
  int bi[2] = {0, 0};
  nr_dx_walk<kMode>(
      feat, nr_slice_chunk(s, nchunks, slices),
      nr_slice_chunk(s + 1, nchunks, slices), a, buf,
      [&](int e, int id, float t, float det) {
        if (kMode == 1 && !(det > 0.0f)) t = NR_MISS;
        if (kMode == 2 && !(det < 0.0f)) t = NR_MISS;
        if (t < bt[e >> 1]) {
          bt[e >> 1] = t;
          bi[e >> 1] = id;
        }
      });
  float* dst = out + (long long)s * 2 * npad;  // a slice's partial rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    nr_quad_hit(bt[h], bi[h]);
    if ((threadIdx.x & 3) == 0) {
      const long long r = nr_dx_ray(ray0) + 8 * h;
      dst[r] = bt[h];
      dst[npad + r] = __int_as_float(bi[h]);
    }
  }
}

// The launch shape the wrapper allocates for (nr_dx_shape).
extern "C" int trace_dense_mxu_shape(int npad, int ttot, int* slices,
                                     long long* feat_doubles) {
  return nr_dx_shape(npad, ttot, slices, feat_doubles);
}

// feat: [T / 8][DX_FRAG] f64 scratch; part: [slices][2][npad] f32 scratch
// (unused with one slice). T must be a multiple of DX_CHUNK_TRIS.
extern "C" int trace_dense_mxu(const float* o, const float* d, int npad,
                               const float* tris, int ttot,
                               const int* block_mask, int mode, int slices,
                               double* feat, float* part, float* out,
                               cudaStream_t stream) {
  if (ttot % DX_CHUNK_TRIS != 0 || slices < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ctas = npad / DX_RAYS;
  if (ctas == 0) return static_cast<int>(cudaGetLastError());
  if (ttot > 0) {
    nr_dx_features<<<(ttot + DX_THREADS - 1) / DX_THREADS, DX_THREADS, 0,
                     stream>>>(tris, ttot, feat);
  }
  const dim3 grid(ctas, slices);
  const int nchunks = ttot / DX_CHUNK_TRIS;
  float* dst = slices == 1 ? out : part;
  if (mode == 1) {
    trace_dense_mxu_kernel<1><<<grid, DX_THREADS, 0, stream>>>(
        o, d, npad, feat, nchunks, block_mask, slices, dst);
  } else if (mode == 2) {
    trace_dense_mxu_kernel<2><<<grid, DX_THREADS, 0, stream>>>(
        o, d, npad, feat, nchunks, block_mask, slices, dst);
  } else {
    trace_dense_mxu_kernel<0><<<grid, DX_THREADS, 0, stream>>>(
        o, d, npad, feat, nchunks, block_mask, slices, dst);
  }
  nr_dense_fold_launch<2>(part, npad, slices, block_mask, out, stream);
  return static_cast<int>(cudaGetLastError());
}

NR_ERROR_STRING_ENTRY
