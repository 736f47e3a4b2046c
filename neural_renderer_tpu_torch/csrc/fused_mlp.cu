// Fused MLP of the tcnn-layout shell network (replaces the TPU kernel
// neural_renderer_tpu/ops/fused_network.py::_mlp_kernel).
//
// [N, 128] bf16 input rows (112 encoded features, zero-padded) -> [16, N]
// f32 outputs, channel-major: four bias-free hidden layers of width 128 with
// LeakyReLU 0.01, each hidden activation re-rounded to bf16, and a linear
// 16-row output layer. bf16 operands, f32 accumulation.
//
// Layout: persistent blocks of 8 warps. The hidden weights [4][128 out][128
// in] and the output weight [16 out][128 in], bf16, sit in dynamic shared
// memory with rows padded from 128 to 136 elements (143,616 bytes), loaded
// once per block; the padding puts the 32 lanes' B-fragment loads in 32
// distinct banks. Each warp takes 32 rows (two m16 tiles) at a time and runs
// every layer on the tensor cores with mma.sync.m16n8k16 (bf16 x bf16 ->
// f32). The activations never leave registers: the f32 accumulators of two
// neighbouring n8 tiles, activated and rounded to bf16 pairs, are exactly
// the A fragment of the next layer's k16 tile.
//
// Bound: operations, 65,536 multiply-adds per row (layer 0 at its 112
// real inputs) on the bf16 tensor cores, against 256 bytes in and 64 bytes
// out per row.
#include <stdint.h>

#include "lane_grid.cuh"
#include "mt.cuh"

#define FM_THREADS 256
#define FM_WARPS (FM_THREADS / 32)
#define FM_ROWS 32                  // rows per warp per step
#define FM_STRIDE 68                // 32-bit words per weight row in smem
#define FM_HIDDEN_ROWS (4 * LG_WIDTH)
#define FM_SMEM ((FM_HIDDEN_ROWS + LG_OUT) * FM_STRIDE * 4)

__global__ void __launch_bounds__(FM_THREADS, 1)
fused_mlp_kernel(const uint32_t* __restrict__ x, int n,
                 const uint4* __restrict__ w_hidden,
                 const uint4* __restrict__ w_out, float* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t sw[];
  {  // weights -> shared memory, 16 bytes per thread per step
    uint4* dst = reinterpret_cast<uint4*>(sw);
    for (int i = threadIdx.x; i < FM_HIDDEN_ROWS * 16; i += blockDim.x)
      dst[(i >> 4) * (FM_STRIDE / 4) + (i & 15)] = w_hidden[i];
    for (int i = threadIdx.x; i < LG_OUT * 16; i += blockDim.x)
      dst[(FM_HIDDEN_ROWS + (i >> 4)) * (FM_STRIDE / 4) + (i & 15)] =
          w_out[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;  // fragment row group, column pair
  const long long step = (long long)gridDim.x * FM_WARPS * FM_ROWS;

  for (long long row0 = ((long long)blockIdx.x * FM_WARPS + warp) * FM_ROWS;
       row0 < n; row0 += step) {
    // A fragments of layer 0 from the input rows: tile mt, k-tile kt.
    uint32_t a[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const long long rl = row0 + mt * 16 + g, rh = rl + 8;
      const bool okl = rl < n, okh = rh < n;
      const uint32_t* xl = x + rl * (LG_WIDTH / 2);
      const uint32_t* xh = x + rh * (LG_WIDTH / 2);
#pragma unroll
      for (int kt = 0; kt < 8; ++kt) {
        a[mt][kt][0] = okl ? __ldg(xl + kt * 8 + tig) : 0u;
        a[mt][kt][1] = okh ? __ldg(xh + kt * 8 + tig) : 0u;
        a[mt][kt][2] = okl ? __ldg(xl + kt * 8 + 4 + tig) : 0u;
        a[mt][kt][3] = okh ? __ldg(xh + kt * 8 + 4 + tig) : 0u;
      }
    }

#pragma unroll 1
    for (int layer = 0; layer < 4; ++layer) {
      const uint32_t* wl = sw + layer * LG_WIDTH * FM_STRIDE;
      uint32_t nxt[2][8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // outputs 16 j .. 16 j + 15
        float c[2][2][4] = {};
#pragma unroll
        for (int kt = 0; kt < 8; ++kt) {
          const uint32_t* w0 = wl + (j * 16 + g) * FM_STRIDE + kt * 8 + tig;
          const uint32_t* w1 = w0 + 8 * FM_STRIDE;
          const uint32_t b00 = w0[0], b01 = w0[4], b10 = w1[0], b11 = w1[4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(c[mt][0], a[mt][kt], b00, b01);
            mma_bf16(c[mt][1], a[mt][kt], b10, b11);
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          nxt[mt][j][0] = act_pair(c[mt][0][0], c[mt][0][1]);
          nxt[mt][j][1] = act_pair(c[mt][0][2], c[mt][0][3]);
          nxt[mt][j][2] = act_pair(c[mt][1][0], c[mt][1][1]);
          nxt[mt][j][3] = act_pair(c[mt][1][2], c[mt][1][3]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int kt = 0; kt < 8; ++kt)
#pragma unroll
          for (int q = 0; q < 4; ++q) a[mt][kt][q] = nxt[mt][kt][q];
    }

    // Output layer: 16 outputs, linear.
    const uint32_t* wo = sw + FM_HIDDEN_ROWS * FM_STRIDE;
    float c[2][2][4] = {};
#pragma unroll
    for (int kt = 0; kt < 8; ++kt) {
      const uint32_t* w0 = wo + g * FM_STRIDE + kt * 8 + tig;
      const uint32_t* w1 = w0 + 8 * FM_STRIDE;
      const uint32_t b00 = w0[0], b01 = w0[4], b10 = w1[0], b11 = w1[4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16(c[mt][0], a[mt][kt], b00, b01);
        mma_bf16(c[mt][1], a[mt][kt], b10, b11);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const long long rl = row0 + mt * 16 + g, rh = rl + 8;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const long long o = nt * 8 + tig * 2;
        if (rl < n) {
          out[o * n + rl] = c[mt][nt][0];
          out[(o + 1) * n + rl] = c[mt][nt][1];
        }
        if (rh < n) {
          out[o * n + rh] = c[mt][nt][2];
          out[(o + 1) * n + rh] = c[mt][nt][3];
        }
      }
    }
  }
}

extern "C" int fused_mlp(const uint32_t* x, int n, const uint4* w_hidden,
                         const uint4* w_out, float* out,
                         cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        FM_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long per_block = (long long)FM_WARPS * FM_ROWS;
  const long long blocks_needed = (n + per_block - 1) / per_block;
  const int grid = (int)(blocks_needed < sms ? blocks_needed : sms);
  if (grid > 0) {
    fused_mlp_kernel<<<grid, FM_THREADS, FM_SMEM, stream>>>(x, n, w_hidden,
                                                           w_out, out);
  }
  return static_cast<int>(cudaGetLastError());
}

NR_ERROR_STRING_ENTRY
