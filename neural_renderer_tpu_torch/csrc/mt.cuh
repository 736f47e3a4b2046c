// Shared device code of the trace kernels: Möller–Trumbore in the exact
// operation order of ops/trace_pallas.py::_mt_tile_t. Compiled with
// -fmad=false (ops/cuda_build.py) so no product is fused into an add and the
// result rounds op by op like the PyTorch twin: the kernels are bit-exact.
#pragma once

#include <cuda_runtime.h>

#define NR_MIN_T 1e-6f
#define NR_TRI_EPS 1e-8f
#define NR_MISS 1e30f

// How Möller–Trumbore takes 1/det: an IEEE divide (the production math), the
// correctly rounded reciprocal __frcp_rn (the same value), or the
// approximate rcp.approx.ftz.f32 (about 1 ulp per the PTX ISA). The last two
// are variants of the trace-kernel ablation (csrc/mt_variants.cuh).
enum NrRcp { NR_RCP_DIV, NR_RCP_RN, NR_RCP_APPROX };

template <int kRcp>
__device__ __forceinline__ float nr_rcp(float x) {
  if constexpr (kRcp == NR_RCP_RN) {
    return __frcp_rn(x);
  } else if constexpr (kRcp == NR_RCP_APPROX) {
    float y;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
  } else {
    return 1.0f / x;
  }
}

// Returns t (NR_MISS where the pair is rejected) and writes det, whose sign
// carries the facing: FORWARD (facing < 0) == det > 0.
template <int kRcp = NR_RCP_DIV>
__device__ __forceinline__ float nr_mt_t(
    float ox, float oy, float oz, float dx, float dy, float dz,
    float v0x, float v0y, float v0z, float e1x, float e1y, float e1z,
    float e2x, float e2y, float e2z, float* det_out) {
  float px = dy * e2z - dz * e2y;
  float py = dz * e2x - dx * e2z;
  float pz = dx * e2y - dy * e2x;
  float det = e1x * px + e1y * py + e1z * pz;
  *det_out = det;
  bool ok = fabsf(det) >= NR_TRI_EPS;
  float inv_det = nr_rcp<kRcp>(ok ? det : 1.0f);
  float tx = ox - v0x;
  float ty = oy - v0y;
  float tz = oz - v0z;
  float u = (tx * px + ty * py + tz * pz) * inv_det;
  ok = ok && (u >= 0.0f) && (u <= 1.0f);
  float qx = ty * e1z - tz * e1y;
  float qy = tz * e1x - tx * e1z;
  float qz = tx * e1y - ty * e1x;
  float v = (dx * qx + dy * qy + dz * qz) * inv_det;
  ok = ok && (v >= 0.0f) && (u + v <= 1.0f);
  float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  ok = ok && (t > NR_TRI_EPS) && (t > NR_MIN_T);
  return ok ? t : NR_MISS;
}

// Fold one pair into the outer shell's sweep accumulators: the strict
// forward pair (or min) and the backward min. Forward is det > 0, backward
// det < 0 (facing = -det).
__device__ __forceinline__ void nr_sweep_outer(int with_fwd2, float t,
                                               float det, float& m1f,
                                               float& m2f, float& m1b) {
  const float tf = det > 0.0f ? t : NR_MISS;
  if (with_fwd2) {
    // _strict_pair_update: m2 = min of values strictly above m1.
    const float n1 = fminf(m1f, tf);
    m2f = fminf(m1f > n1 ? m1f : m2f, tf > n1 ? tf : NR_MISS);
    m1f = n1;
  } else {
    m1f = fminf(m1f, tf);
  }
  m1b = fminf(m1b, det < 0.0f ? t : NR_MISS);
}

// Fold one pair into the inner shell's: the forward and backward mins.
__device__ __forceinline__ void nr_sweep_inner(float t, float det,
                                               float& i1f, float& i1b) {
  i1f = fminf(i1f, det > 0.0f ? t : NR_MISS);
  i1b = fminf(i1b, det < 0.0f ? t : NR_MISS);
}

// Fold the strict two-min pair (b1, b2) into (m1, m2): m2 stays the min of
// the values strictly above m1 (`_strict_pair_update` over a multiset).
__device__ __forceinline__ void nr_pair_merge(float& m1, float& m2, float b1,
                                              float b2) {
  const float n1 = fminf(m1, b1);
  m2 = fminf(m1 > n1 ? m1 : m2, b1 > n1 ? b1 : b2);
  m1 = n1;
}

// Closest hit: keep (t, id) unless the candidate is nearer, or as near
// with a smaller id (the brute-force oracle's rule).
__device__ __forceinline__ void nr_hit_update(float& bt, int& bi, float t,
                                              int id) {
  if (t < bt || (t == bt && id < bi)) {
    bt = t;
    bi = id;
  }
}

// Stage columns [col0, col0 + width) of a [9, total] row-major triangle
// array into tile[9][width]; all threads of the block take part.
template <int WIDTH>
__device__ __forceinline__ void nr_stage_tile(float (*tile)[WIDTH],
                                              const float* __restrict__ tris,
                                              long long total, long long col0) {
  for (int e = threadIdx.x; e < 9 * WIDTH; e += blockDim.x) {
    int row = e / WIDTH;
    int col = e - row * WIDTH;
    tile[row][col] = tris[row * total + col0 + col];
  }
}

// Asynchronous copies from global into shared memory (cp.async): 4 bytes,
// or 16 with both addresses 16-byte aligned; commit the copies started so
// far as one group, and wait until at most N groups are in flight.
__device__ __forceinline__ void nr_cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void nr_cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void nr_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void nr_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

#define NR_ERROR_STRING_ENTRY                                   \
  extern "C" const char* nr_error_string(int e) {               \
    return cudaGetErrorString(static_cast<cudaError_t>(e));     \
  }
