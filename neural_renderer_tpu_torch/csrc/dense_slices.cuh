// Shared code of the dense kernels, every ray against every triangle: the
// launch shape and the fold of triangle slices, used by the FP32 kernels
// K3 (trace_dense.cu) and K4 (sweep_dense.cu, both through mt_dense.cuh),
// the matrix-form kernels K8 and K4-MXU (mt_mxu.cuh) and the trace-kernel
// ablation's (ablate_*.cu).
//
// Slices. A launch whose rays fill fewer than the card's CTA slots splits
// the triangles into `slices` ranges of whole chunks (blockIdx.y); each
// slice writes its rows to a partial buffer and nr_dense_fold merges them
// per ray: the closest hit by (t, smallest id), the sweep's rows by the
// strict-pair rule and mins. These are selections, so the grouping does
// not change a bit. nr_dense_slices picks the count: enough slices that
// the launch reaches `ctas_per_sm` CTAs on every SM, at most one per
// chunk. Each dense library exports it as `<name>_shape`, and its wrapper
// sizes the partial buffer from it (ops/trace_pallas.py::dense_scratch).
#pragma once

#include "mt.cuh"

#define NR_SKIP_RAYS 512  // rays per skip flag

// The triangle slices of a launch of npad rays against ttot triangles in
// CTAs of cta_rays rays and chunks of chunk_tris triangles, on the
// current device.
static inline int nr_dense_slices(int npad, int ttot, int cta_rays,
                                  int chunk_tris, int ctas_per_sm,
                                  int* slices) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ctas = npad / cta_rays > 1 ? npad / cta_rays : 1;
  const int want = (sms * ctas_per_sm + ctas - 1) / ctas;
  const int most = ttot / chunk_tris > 1 ? ttot / chunk_tris : 1;
  *slices = want < most ? want : most;
  return 0;
}

// Slice s's first chunk of nchunks (slice s takes [chunk(s), chunk(s + 1))).
__device__ __forceinline__ int nr_slice_chunk(int s, int nchunks,
                                              int slices) {
  return (int)((long long)s * nchunks / slices);
}

// The slices' partial rows [slices][kRows][npad] -> out [kRows, npad]:
// kRows 2 the closest hit (t, id bitcast), 4 or 5 the sweep's rows
// outer_fwd, outer_bwd, inner_fwd, inner_bwd[, outer_fwd2]. Rays of a
// dead skip block get the miss (id 0); without skip flags (block_mask
// null) every ray is live. `miss`: the closest hit's miss value, which
// the fold starts from (1e30; the ablation's bf16 tile math has its own).
template <int kRows>
__global__ void __launch_bounds__(256)
nr_dense_fold(const float* __restrict__ part, int npad, int slices,
              const int* __restrict__ block_mask, float miss,
              float* __restrict__ out) {
  const long long r = (long long)blockIdx.x * 256 + threadIdx.x;
  if (r >= npad) return;
  const bool live =
      block_mask == nullptr || block_mask[r / NR_SKIP_RAYS] != 0;
  if constexpr (kRows == 2) {
    float bt = miss;
    int bi = 0;
    for (int s = 0; live && s < slices; ++s)
      nr_hit_update(bt, bi, part[2LL * s * npad + r],
                    __float_as_int(part[(2LL * s + 1) * npad + r]));
    out[r] = bt;
    out[npad + r] = __int_as_float(bi);
  } else {
    float m1f = NR_MISS, m2f = NR_MISS, m1b = NR_MISS, i1f = NR_MISS,
          i1b = NR_MISS;
    for (int s = 0; live && s < slices; ++s) {
      const float* p = part + (long long)s * kRows * npad + r;
      if (kRows == 5) {
        nr_pair_merge(m1f, m2f, p[0], p[4LL * npad]);
      } else {
        m1f = fminf(m1f, p[0]);
      }
      m1b = fminf(m1b, p[npad]);
      i1f = fminf(i1f, p[2LL * npad]);
      i1b = fminf(i1b, p[3LL * npad]);
    }
    out[r] = m1f;
    out[npad + r] = m1b;
    out[2LL * npad + r] = i1f;
    out[3LL * npad + r] = i1b;
    if (kRows == 5) out[4LL * npad + r] = m2f;
  }
}

// Launch nr_dense_fold<kRows> on the stream when there is more than one
// slice.
template <int kRows>
void nr_dense_fold_launch(const float* part, int npad, int slices,
                          const int* block_mask, float* out,
                          cudaStream_t stream, float miss = NR_MISS) {
  if (slices > 1) {
    nr_dense_fold<kRows><<<(npad + 255) / 256, 256, 0, stream>>>(
        part, npad, slices, block_mask, miss, out);
  }
}
