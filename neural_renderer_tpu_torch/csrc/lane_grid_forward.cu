// Fused lane-grid shell-network forward (replaces the TPU kernel
// neural_renderer_tpu/ops/lane_grid_kernel.py::_forward_kernel).
//
// [12, N] inputs -> [16, N] outputs: lane hash-grid encode (P points x L
// levels x 4 features, 8 trilinear corners) + degree-4 SH + 4 bias-free
// LeakyReLU layers of width 128 + a 16-row output layer. bf16 operands, f32
// accumulation, hidden activations re-rounded to bf16. A 128-ray block with
// no active ray writes zeros (the TPU kernel's skip granularity).
//
// Bound: operations, 65,536 multiply-adds per ray in the MLP on the bf16
// tensor cores; beside them 192 scattered 16-byte table reads per ray from
// L2 (786 KB of packed tables at S=16 stay resident there).
//
// Layout: persistent blocks of 8 warps. The hidden weights [4][128 in][128
// out] and the output weight [128 in][16 out], bf16, sit in shared memory
// with padded rows (lane_grid.cuh), loaded once per block. Each warp takes
// 32 rays (two m16 tiles) at a time:
//   1. encode, one ray per lane: the tables are feature-interleaved, so one
//      16-byte load fetches the 4 features of a corner; the 8 corner loads
//      of a level are issued before any is used. The lane writes its ray's
//      128 bf16 features into a column of the warp's channel-major staging
//      tile (10 KB);
//   2. after __syncwarp, ldmatrix.trans turns the tile into layer 0's A
//      fragments;
//   3. every layer runs on the tensor cores with mma.sync.m16n8k16 (bf16 x
//      bf16 -> f32), B fragments by ldmatrix.trans from the [in][out]
//      weights. Activations stay in registers: the f32 accumulators of two
//      neighbouring n8 tiles, activated and rounded to bf16 pairs, are the
//      next layer's A fragment (as in fused_mlp.cu).
// The encode keeps the twin's expression order (corners summed c = 0..7,
// -fmad=false), so the features are bit-exact; the tensor cores sum the
// products in another order than the twin's f32 matmul.
#include <stdint.h>

#include "lane_grid.cuh"
#include "mt.cuh"

#define LG_THREADS (LG_WARPS * 32)

// The A fragments a[2 m16 tiles][8 k16 tiles][4] of a warp's 32 rays from a
// channel-major staging tile st[128][LG_TS] (channel k, ray m): the tile
// is A transposed, so ldmatrix.trans gives A's fragments.
__device__ __forceinline__ void lg_tile_fragments(uint32_t (*a)[8][4],
                                                  const uint16_t* st,
                                                  int lane) {
  const int blk = lane >> 3, row = lane & 7;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int kt = 0; kt < 8; ++kt)
      ldsm_x4_trans(a[mt][kt], st + (16 * kt + row + (blk >> 1) * 8) *
                                        LG_TS +
                                    16 * mt + (blk & 1) * 8);
}

__global__ void __launch_bounds__(LG_THREADS, 1)
lane_grid_forward_kernel(const float* __restrict__ x, int npad,
                         const int* __restrict__ block_mask,
                         const uint4* __restrict__ tables,
                         const uint16_t* __restrict__ w_hidden,
                         const uint16_t* __restrict__ w_out,
                         const float* __restrict__ scales, int n_points,
                         int n_levels, int sublanes, int entry_pack,
                         int encoded_dims, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* sw = reinterpret_cast<uint16_t*>(smem);
  uint16_t* swo = reinterpret_cast<uint16_t*>(smem + LG_SMEM_W);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint16_t* st = reinterpret_cast<uint16_t*>(
      smem + LG_SMEM_W + LG_SMEM_WOUT + warp * LG_SMEM_TILE);
  lg_load_weights(w_hidden, w_out, sw, swo);
  __syncthreads();

  const int g = lane >> 2, tig = lane & 3;
  const int blk = lane >> 3, row = lane & 7;
  const uint32_t n_entries = (uint32_t)(sublanes * entry_pack * LG_GROUP);
  const long long step = (long long)gridDim.x * LG_WARPS * LG_TILE_RAYS;

  for (long long r0 = ((long long)blockIdx.x * LG_WARPS + warp) *
                      LG_TILE_RAYS;
       r0 < npad; r0 += step) {
    if (block_mask[r0 / LG_GROUP] == 0) {  // uniform over the warp
#pragma unroll
      for (int o = 0; o < LG_OUT; ++o) out[o * (long long)npad + r0 + lane] =
          0.0f;
      continue;
    }
    lg_encode_column(x, npad, r0 + lane, true, tables, scales, n_points,
                     n_levels, entry_pack, n_entries, encoded_dims, st, lane);
    __syncwarp();
    uint32_t a[2][8][4];
    lg_tile_fragments(a, st, lane);
    __syncwarp();

#pragma unroll 1
    for (int layer = 0; layer < 4; ++layer) {
      const uint16_t* wl = sw + layer * LG_WIDTH * LG_WS;
      uint32_t nxt[2][8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // outputs 16 j .. 16 j + 15
        float c[2][2][4] = {};
#pragma unroll
        for (int kt = 0; kt < 8; ++kt) {
          uint32_t b[4];
          ldsm_x4_trans(b, wl + (16 * kt + row + (blk & 1) * 8) * LG_WS +
                               16 * j + (blk >> 1) * 8);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(c[mt][0], a[mt][kt], b[0], b[1]);
            mma_bf16(c[mt][1], a[mt][kt], b[2], b[3]);
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
    float c[2][2][4] = {};
#pragma unroll
    for (int kt = 0; kt < 8; ++kt) {
      uint32_t b[4];
      ldsm_x4_trans(b, swo + (16 * kt + row + (blk & 1) * 8) * LG_WOS +
                           (blk >> 1) * 8);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16(c[mt][0], a[mt][kt], b[0], b[1]);
        mma_bf16(c[mt][1], a[mt][kt], b[2], b[3]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const long long rl = r0 + mt * 16 + g, rh = rl + 8;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const long long o = nt * 8 + tig * 2;
        out[o * npad + rl] = c[mt][nt][0];
        out[(o + 1) * npad + rl] = c[mt][nt][1];
        out[o * npad + rh] = c[mt][nt][2];
        out[(o + 1) * npad + rh] = c[mt][nt][3];
      }
    }
  }
}

// npad: a multiple of 128; x [12, npad] f32; block_mask [npad / 128];
// tables feature-interleaved (lane_grid_kernel.interleave_features).
extern "C" int lane_grid_forward(const float* x, int npad,
                                 const int* block_mask, const uint4* tables,
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
  if (npad % LG_GROUP != 0) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int per_block = LG_WARPS * LG_TILE_RAYS;
  const int blocks_needed = (npad + per_block - 1) / per_block;
  const int grid = blocks_needed < sms ? blocks_needed : sms;
  if (grid > 0) {
    lane_grid_forward_kernel<<<grid, LG_THREADS, LG_SMEM, stream>>>(
        x, npad, block_mask, tables, w_hidden, w_out, scales, n_points,
        n_levels, sublanes, entry_pack, encoded_dims, out);
  }
  return static_cast<int>(cudaGetLastError());
}

NR_ERROR_STRING_ENTRY
