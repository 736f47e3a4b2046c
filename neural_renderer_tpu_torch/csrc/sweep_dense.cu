// Dense dual-shell sweep (replaces the TPU kernel
// neural_renderer_tpu/ops/trace_pallas.py::_sweep_kernel).
//
// tris = [outer | inner], each shell padded to whole 256-triangle tiles with
// degenerate triangles that the det cull rejects. One block per 512 rays, one
// thread per ray; a block whose skip flag is 0 (no ray meets the shells'
// padded root AABB) writes 1e30 to every row without touching a triangle.
// Live blocks stage every tile in shared memory; outer tiles fold the strict
// forward pair (m1f, m2f) and the backward min, inner tiles the forward and
// backward mins, all in registers. The strict pair is a selection over the
// multiset of t's, so folding triangle by triangle equals the twin's
// per-tile merge bit for bit. Rows: outer_fwd, outer_bwd, inner_fwd,
// inner_bwd[, outer_fwd2].
//
// Bound: FP32 operations, ~45 per (ray, triangle) pair of the live blocks.
#include "mt.cuh"

#define SD_BLOCK_RAYS 512
#define SD_TILE 256

__global__ void __launch_bounds__(SD_BLOCK_RAYS)
sweep_dense_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   int npad, const float* __restrict__ tris, int ttot,
                   int outer_cols, const int* __restrict__ block_mask,
                   int with_fwd2, float* __restrict__ out) {
  __shared__ float tile[9][SD_TILE];
  const int b = blockIdx.x;
  const long long r = (long long)b * SD_BLOCK_RAYS + threadIdx.x;
  float m1f = NR_MISS, m2f = NR_MISS, m1b = NR_MISS;
  float i1f = NR_MISS, i1b = NR_MISS;
  if (block_mask[b] != 0) {  // uniform across the block
    const float ox = o[r], oy = o[npad + r], oz = o[2LL * npad + r];
    const float dx = d[r], dy = d[npad + r], dz = d[2LL * npad + r];
    for (int base = 0; base < ttot; base += SD_TILE) {
      __syncthreads();  // previous tile fully consumed
      nr_stage_tile<SD_TILE>(tile, tris, ttot, base);
      __syncthreads();
      if (base < outer_cols) {
#pragma unroll 4
        for (int q = 0; q < SD_TILE; ++q) {
          float det;
          const float t = nr_mt_t(ox, oy, oz, dx, dy, dz, tile[0][q],
                                  tile[1][q], tile[2][q], tile[3][q],
                                  tile[4][q], tile[5][q], tile[6][q],
                                  tile[7][q], tile[8][q], &det);
          const float tf = det > 0.0f ? t : NR_MISS;
          const float tb = det < 0.0f ? t : NR_MISS;
          if (with_fwd2) {
            // _strict_pair_update: m2 = min of values strictly above m1.
            const float n1 = fminf(m1f, tf);
            m2f = fminf(m1f > n1 ? m1f : m2f, tf > n1 ? tf : NR_MISS);
            m1f = n1;
          } else {
            m1f = fminf(m1f, tf);
          }
          m1b = fminf(m1b, tb);
        }
      } else {
#pragma unroll 4
        for (int q = 0; q < SD_TILE; ++q) {
          float det;
          const float t = nr_mt_t(ox, oy, oz, dx, dy, dz, tile[0][q],
                                  tile[1][q], tile[2][q], tile[3][q],
                                  tile[4][q], tile[5][q], tile[6][q],
                                  tile[7][q], tile[8][q], &det);
          i1f = fminf(i1f, det > 0.0f ? t : NR_MISS);
          i1b = fminf(i1b, det < 0.0f ? t : NR_MISS);
        }
      }
    }
  }
  out[r] = m1f;
  out[npad + r] = m1b;
  out[2LL * npad + r] = i1f;
  out[3LL * npad + r] = i1b;
  if (with_fwd2) out[4LL * npad + r] = m2f;
}

extern "C" int sweep_dense(const float* o, const float* d, int npad,
                           const float* tris, int ttot, int outer_cols,
                           const int* block_mask, int with_fwd2, float* out,
                           cudaStream_t stream) {
  const int nb = npad / SD_BLOCK_RAYS;
  if (nb > 0) {
    sweep_dense_kernel<<<nb, SD_BLOCK_RAYS, 0, stream>>>(
        o, d, npad, tris, ttot, outer_cols, block_mask, with_fwd2, out);
  }
  return static_cast<int>(cudaGetLastError());
}

NR_ERROR_STRING_ENTRY
