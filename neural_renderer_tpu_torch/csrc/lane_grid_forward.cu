// Fused lane-grid shell-network forward (replaces the TPU kernel
// neural_renderer_tpu/ops/lane_grid_kernel.py::_forward_kernel).
//
// [12, N] inputs -> [16, N] outputs: lane hash-grid encode (P points x L
// levels x 4 features, 8 trilinear corners) + degree-4 SH + 4 bias-free
// LeakyReLU layers of width 128 + a 16-row output layer. bf16 operands, f32
// accumulation, hidden activations re-rounded to bf16. A 128-ray block with
// no active ray writes zeros (the TPU kernel's skip granularity).
//
// Layout: persistent blocks of 256 threads (two 128-ray groups), one thread
// per ray. The hidden weights [4][128 in][128 out] and the output weight
// [128 in][16 out], bf16, sit in dynamic shared memory (132 KB), loaded once
// per block. Each thread owns one column of the feature buffer
// h[128][256] (bf16, 64 KB): it writes its encoded features there, and each
// layer reads the column into registers, then overwrites it with the layer's
// output. No thread touches another's column, so the layers need no block
// barrier.
//
// Bound: operations, 67,584 multiply-adds per ray in the MLP. This version
// runs them as FP32 FMAs (explicit __fmaf_rn; the file is compiled with
// -fmad=false so the encode rounds op by op like the PyTorch twin).
#include <stdint.h>

#include "lane_grid.cuh"
#include "mt.cuh"

#define LG_THREADS 256
#define LG_SMEM_W (4 * LG_WIDTH * LG_WIDTH * 2)
#define LG_SMEM_WOUT (LG_WIDTH * LG_OUT * 2)
#define LG_SMEM_H (LG_WIDTH * LG_THREADS * 2)
#define LG_SMEM (LG_SMEM_W + LG_SMEM_WOUT + LG_SMEM_H)

// Eight bf16 values of a 16-byte word (little-endian: element 0 in the low
// half of .x) times hv, accumulated into acc[0..7].
__device__ __forceinline__ void fma8(float* acc, uint4 w, float hv) {
  const uint32_t v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    acc[2 * e] = __fmaf_rn(__uint_as_float(v[e] << 16), hv, acc[2 * e]);
    acc[2 * e + 1] =
        __fmaf_rn(__uint_as_float(v[e] & 0xFFFF0000u), hv, acc[2 * e + 1]);
  }
}

__global__ void __launch_bounds__(LG_THREADS, 1)
lane_grid_forward_kernel(const float* __restrict__ x, int npad,
                         const int* __restrict__ block_mask,
                         const float* __restrict__ tables,
                         const uint16_t* __restrict__ w_hidden,
                         const uint16_t* __restrict__ w_out,
                         const float* __restrict__ scales, int n_points,
                         int n_levels, int sublanes, int entry_pack,
                         int encoded_dims, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* sw = reinterpret_cast<uint16_t*>(smem);
  uint16_t* swo = reinterpret_cast<uint16_t*>(smem + LG_SMEM_W);
  uint16_t* sh = reinterpret_cast<uint16_t*>(smem + LG_SMEM_W + LG_SMEM_WOUT);

  {  // weights -> shared memory, 16 bytes per thread per step
    const uint4* src = reinterpret_cast<const uint4*>(w_hidden);
    uint4* dst = reinterpret_cast<uint4*>(sw);
    for (int i = threadIdx.x; i < LG_SMEM_W / 16; i += blockDim.x)
      dst[i] = src[i];
    const uint4* src2 = reinterpret_cast<const uint4*>(w_out);
    uint4* dst2 = reinterpret_cast<uint4*>(swo);
    for (int i = threadIdx.x; i < LG_SMEM_WOUT / 16; i += blockDim.x)
      dst2[i] = src2[i];
  }
  __syncthreads();

  const int tid = threadIdx.x;
  const uint32_t n_entries = (uint32_t)(sublanes * entry_pack * LG_GROUP);
  const int sub_shift = entry_pack == 2 ? 8 : 7;

  for (long long base = (long long)blockIdx.x * LG_THREADS; base < npad;
       base += (long long)gridDim.x * LG_THREADS) {
    const long long r = base + tid;
    if (r >= npad) continue;
    if (block_mask[r / LG_GROUP] == 0) {  // uniform within each warp
#pragma unroll
      for (int o = 0; o < LG_OUT; ++o) out[o * (long long)npad + r] = 0.0f;
      continue;
    }

    // ---- encode: features k = (p * L + level) * 4 + f, then 16 SH ----
    int k = 0;
    for (int p = 0; p < n_points; ++p) {
      const float px = x[(3 * p) * (long long)npad + r];
      const float py = x[(3 * p + 1) * (long long)npad + r];
      const float pz = x[(3 * p + 2) * (long long)npad + r];
      for (int level = 0; level < n_levels; ++level) {
        uint32_t idx[8];
        float wc[8];
        lg_corners(px, py, pz, scales[level], n_entries, idx, wc);
        const long long base_row =
            (long long)((p * n_levels + level) * 4) * sublanes;
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const uint32_t sub = idx[c] >> sub_shift;
          const uint32_t lane = idx[c] & (LG_GROUP - 1);
          const bool hi_half = (idx[c] & LG_GROUP) != 0;
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const long long row = base_row + (long long)f * sublanes + sub;
            const float g = __ldg(tables + row * LG_GROUP + lane);
            float val = g;
            if (entry_pack == 2) {
              const uint32_t u = __float_as_uint(g);
              val = hi_half ? __uint_as_float(u & 0xFFFF0000u)
                            : __uint_as_float(u << 16);
            }
            acc[f] = acc[f] + val * wc[c];
          }
        }
#pragma unroll
        for (int f = 0; f < 4; ++f)
          sh[(k + f) * LG_THREADS + tid] = f32_to_bf16_bits(acc[f]);
        k += 4;
      }
    }
    {
      const long long d0 = (3 * n_points) * (long long)npad + r;
      float shv[16];
      lg_sh16(x[d0], x[d0 + npad], x[d0 + 2LL * npad], shv);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        sh[(k + j) * LG_THREADS + tid] = f32_to_bf16_bits(shv[j]);
      for (int j = encoded_dims; j < LG_WIDTH; ++j)
        sh[j * LG_THREADS + tid] = 0;
    }

    // ---- MLP: out[o] = sum_i W[o][i] * h[i], f32 accumulation ----
    uint32_t hc[LG_WIDTH / 2];
    for (int layer = 0; layer < 4; ++layer) {
#pragma unroll
      for (int i2 = 0; i2 < LG_WIDTH / 2; ++i2)
        hc[i2] = (uint32_t)sh[(2 * i2) * LG_THREADS + tid] |
                 ((uint32_t)sh[(2 * i2 + 1) * LG_THREADS + tid] << 16);
      const uint16_t* wl = sw + layer * LG_WIDTH * LG_WIDTH;
      for (int chunk = 0; chunk < LG_WIDTH / 32; ++chunk) {
        float acc[32];
#pragma unroll
        for (int q = 0; q < 32; ++q) acc[q] = 0.0f;
#pragma unroll
        for (int i = 0; i < LG_WIDTH; ++i) {
          const float hv = (i & 1) ? __uint_as_float(hc[i >> 1] & 0xFFFF0000u)
                                   : bf16_bits_to_f32(hc[i >> 1] & 0xFFFFu);
          const uint4* wrow =
              reinterpret_cast<const uint4*>(wl + i * LG_WIDTH + chunk * 32);
#pragma unroll
          for (int q = 0; q < 4; ++q) fma8(acc + 8 * q, wrow[q], hv);
        }
#pragma unroll
        for (int q = 0; q < 32; ++q) {
          const float a = acc[q];
          const float act = a > 0.0f ? a : 0.01f * a;
          sh[(chunk * 32 + q) * LG_THREADS + tid] = f32_to_bf16_bits(act);
        }
      }
    }
#pragma unroll
    for (int i2 = 0; i2 < LG_WIDTH / 2; ++i2)
      hc[i2] = (uint32_t)sh[(2 * i2) * LG_THREADS + tid] |
               ((uint32_t)sh[(2 * i2 + 1) * LG_THREADS + tid] << 16);
    float acc[LG_OUT];
#pragma unroll
    for (int q = 0; q < LG_OUT; ++q) acc[q] = 0.0f;
#pragma unroll
    for (int i = 0; i < LG_WIDTH; ++i) {
      const float hv = (i & 1) ? __uint_as_float(hc[i >> 1] & 0xFFFF0000u)
                               : bf16_bits_to_f32(hc[i >> 1] & 0xFFFFu);
      const uint4* wrow = reinterpret_cast<const uint4*>(swo + i * LG_OUT);
      fma8(acc, wrow[0], hv);
      fma8(acc + 8, wrow[1], hv);
    }
#pragma unroll
    for (int o = 0; o < LG_OUT; ++o) out[o * (long long)npad + r] = acc[o];
  }
}

extern "C" int lane_grid_forward(const float* x, int npad,
                                 const int* block_mask, const float* tables,
                                 const uint16_t* w_hidden,
                                 const uint16_t* w_out, const float* scales,
                                 int n_points, int n_levels, int sublanes,
                                 int entry_pack, int encoded_dims, float* out,
                                 cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        lane_grid_forward_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, LG_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int blocks_needed = (npad + LG_THREADS - 1) / LG_THREADS;
  const int grid = blocks_needed < sms ? blocks_needed : sms;
  if (grid > 0) {
    lane_grid_forward_kernel<<<grid, LG_THREADS, LG_SMEM, stream>>>(
        x, npad, block_mask, tables, w_hidden, w_out, scales, n_points,
        n_levels, sublanes, entry_pack, encoded_dims, out);
  }
  return static_cast<int>(cudaGetLastError());
}

NR_ERROR_STRING_ENTRY
