// Device code shared by the shell-network kernels (lane_grid_forward.cu,
// lane_grid_backward.cu, fused_mlp.cu): bf16 conversions, the bf16
// tensor-core product, ldmatrix and the weights' shared-memory layout, the
// trilinear corners of one (point, level) of the lane hash grid, the
// degree-4 SH encoding and the encode of one ray into a warp's staging
// tile, in the PyTorch twin's expression order (models/lane_grid.py,
// models/encoding.py). The files are compiled with -fmad=false, so each
// product and sum rounds separately, as in the twin.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#define LG_WIDTH 128
#define LG_OUT 16
#define LG_GROUP 128

// Shared-memory layout of the lane-grid kernels (K2, K6). The weights are
// [in][out] bf16 with rows padded so that the 8 rows of an ldmatrix 8x8
// block fall in distinct banks: hidden rows of 128 outputs at a stride of
// 136 elements (272 B), output-layer rows of 16 at 24 (48 B). A warp's
// staging tile holds 128 channels x 32 rays, channel-major, at a stride of
// 40 elements (80 B).
#define LG_WS 136
#define LG_WOS 24
#define LG_TS 40
#define LG_TILE_RAYS 32
#define LG_WARPS 8
#define LG_SMEM_W (4 * LG_WIDTH * LG_WS * 2)
#define LG_SMEM_WOUT (LG_WIDTH * LG_WOS * 2)
#define LG_SMEM_TILE (LG_WIDTH * LG_TS * 2)
#define LG_SMEM (LG_SMEM_W + LG_SMEM_WOUT + LG_WARPS * LG_SMEM_TILE)

__device__ __forceinline__ float bf16_bits_to_f32(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

__device__ __forceinline__ uint16_t f32_to_bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// Element e (0 or 1) of a word holding two bf16 values, element 0 in the
// low half.
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

// c[0..3] += A (16x16, row-major fragment a[0..3]) x B (16x8, col-major
// fragment b0, b1), f32 accumulation.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// LeakyReLU of two neighbouring columns, rounded to a bf16 pair (column 0
// in the low half), as the twin rounds each hidden activation.
__device__ __forceinline__ uint32_t act_pair(float lo, float hi) {
  lo = lo > 0.0f ? lo : 0.01f * lo;
  hi = hi > 0.0f ? hi : 0.01f * hi;
  return (uint32_t)f32_to_bf16_bits(lo) |
         ((uint32_t)f32_to_bf16_bits(hi) << 16);
}

// Four 8x8 bf16 blocks from shared memory; lane t gives the address of row
// t % 8 of block t / 8. Plain: lane (g, tig) gets row g, columns 2 tig and
// 2 tig + 1 of each block. .trans: the blocks transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const uint16_t* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r,
                                              const uint16_t* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Loads the [4][128 in][128 out] hidden weights and the [128 in][16 out]
// output weight (bf16, global) into their padded shared-memory rows, 16
// bytes per thread per step.
__device__ __forceinline__ void lg_load_weights(const uint16_t* w_hidden,
                                                const uint16_t* w_out,
                                                uint16_t* sw, uint16_t* swo) {
  const uint4* src = reinterpret_cast<const uint4*>(w_hidden);
  for (int i = threadIdx.x; i < 4 * LG_WIDTH * 16; i += blockDim.x)
    *reinterpret_cast<uint4*>(sw + (i >> 4) * LG_WS + (i & 15) * 8) = src[i];
  const uint4* src2 = reinterpret_cast<const uint4*>(w_out);
  for (int i = threadIdx.x; i < LG_WIDTH * 2; i += blockDim.x)
    *reinterpret_cast<uint4*>(swo + (i >> 1) * LG_WOS + (i & 1) * 8) =
        src2[i];
}

// Table index and trilinear weight of the 8 corners of point (px, py, pz)
// at grid scale sc; corner c = dx + 2 dy + 4 dz. Hash: tcnn's coherent
// prime xor, masked to the table's n_entries (a power of two).
__device__ __forceinline__ void lg_corners(float px, float py, float pz,
                                           float sc, uint32_t n_entries,
                                           uint32_t* idx, float* wc) {
  const float sx = px * sc + 0.5f;
  const float sy = py * sc + 0.5f;
  const float sz = pz * sc + 0.5f;
  const float cx0 = floorf(sx), cy0 = floorf(sy), cz0 = floorf(sz);
  const float wx = sx - cx0, wy = sy - cy0, wz = sz - cz0;
  const int ix = (int)cx0, iy = (int)cy0, iz = (int)cz0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int dx = c & 1, dy = (c >> 1) & 1, dz = c >> 2;
    const float wcx = dx ? wx : (1.0f - wx);
    const float wcy = dy ? wy : (1.0f - wy);
    const float wcz = dz ? wz : (1.0f - wz);
    wc[c] = wcx * wcy * wcz;
    const uint32_t h = ((uint32_t)(ix + dx) * 1u) ^
                       ((uint32_t)(iy + dy) * 2654435761u) ^
                       ((uint32_t)(iz + dz) * 805459861u);
    idx[c] = h & (n_entries - 1u);
  }
}

// Degree-4 real SH of the direction stored in [0, 1]^3.
__device__ __forceinline__ void lg_sh16(float x0, float x1, float x2,
                                        float* shv) {
  const float dxv = x0 * 2.0f - 1.0f;
  const float dyv = x1 * 2.0f - 1.0f;
  const float dzv = x2 * 2.0f - 1.0f;
  const float xy = dxv * dyv, xz = dxv * dzv, yz = dyv * dzv;
  const float x2s = dxv * dxv, y2 = dyv * dyv, z2 = dzv * dzv;
  shv[0] = 0.28209479177387814f;
  shv[1] = -0.48860251190291987f * dyv;
  shv[2] = 0.48860251190291987f * dzv;
  shv[3] = -0.48860251190291987f * dxv;
  shv[4] = 1.0925484305920792f * xy;
  shv[5] = -1.0925484305920792f * yz;
  shv[6] = 0.94617469575755997f * z2 - 0.31539156525251999f;
  shv[7] = -1.0925484305920792f * xz;
  shv[8] = 0.54627421529603959f * x2s - 0.54627421529603959f * y2;
  shv[9] = 0.59004358992664352f * dyv * (-3.0f * x2s + y2);
  shv[10] = 2.8906114426405538f * xy * dzv;
  shv[11] = 0.45704579946446572f * dyv * (1.0f - 5.0f * z2);
  shv[12] = 0.3731763325901154f * dzv * (5.0f * z2 - 3.0f);
  shv[13] = 0.45704579946446572f * dxv * (1.0f - 5.0f * z2);
  shv[14] = 1.4453057213202769f * dzv * (x2s - y2);
  shv[15] = 0.59004358992664352f * dxv * (-x2s + 3.0f * y2);
}

// Word entry of table index idx in a feature-interleaved table: at
// entry_pack 2 two entries share a word (bit 7 of idx selects the half);
// at 1 every entry has its own.
__device__ __forceinline__ uint32_t lg_word_entry(uint32_t idx,
                                                  int entry_pack) {
  return entry_pack == 2 ? (((idx >> 8) << 7) | (idx & (LG_GROUP - 1)))
                         : idx;
}

// Encodes ray r (column `lane` of the warp's staging tile st) from x
// [12, ld]: features k = (p * L + level) * 4 + f, then 16 SH, zero to 128,
// as bf16. tables: feature-interleaved, [P * L][entries / entry_pack] of
// 16 bytes (the four features' words of one entry: two bf16 halves each at
// entry_pack 2, one f32 each at 1). An invalid ray gets a zero column.
__device__ __forceinline__ void lg_encode_column(
    const float* __restrict__ x, long long ld, long long r, bool valid,
    const uint4* __restrict__ tables, const float* __restrict__ scales,
    int n_points, int n_levels, int entry_pack, uint32_t n_entries,
    int encoded_dims, uint16_t* st, int lane) {
  uint16_t* col = st + lane;
  const uint32_t n_words = n_entries / (uint32_t)entry_pack;
  int k = 0;
  for (int p = 0; p < n_points; ++p) {
    float px = 0.0f, py = 0.0f, pz = 0.0f;
    if (valid) {
      px = x[(3 * p) * ld + r];
      py = x[(3 * p + 1) * ld + r];
      pz = x[(3 * p + 2) * ld + r];
    }
    for (int level = 0; level < n_levels; ++level, k += 4) {
      if (!valid) {
#pragma unroll
        for (int f = 0; f < 4; ++f) col[(k + f) * LG_TS] = 0;
        continue;
      }
      // The 8 corner loads (16 bytes: the 4 features of one word entry)
      // are issued before any is used; corners are summed in the twin's
      // order c = 0..7.
      uint32_t idx[8];
      float wc[8];
      lg_corners(px, py, pz, scales[level], n_entries, idx, wc);
      const uint4* tg = tables + (long long)(p * n_levels + level) * n_words;
      uint4 v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) v[c] = __ldg(tg + lg_word_entry(idx[c],
                                                                  entry_pack));
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const uint32_t w[4] = {v[c].x, v[c].y, v[c].z, v[c].w};
        const bool upper = (idx[c] & LG_GROUP) != 0;
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          float val = __uint_as_float(w[f]);
          if (entry_pack == 2) val = upper ? bf16_hi(w[f]) : bf16_lo(w[f]);
          acc[f] = acc[f] + val * wc[c];
        }
      }
#pragma unroll
      for (int f = 0; f < 4; ++f)
        col[(k + f) * LG_TS] = f32_to_bf16_bits(acc[f]);
    }
  }
  float shv[16];
  if (valid) {
    const long long d0 = (3 * n_points) * ld + r;
    lg_sh16(x[d0], x[d0 + ld], x[d0 + 2 * ld], shv);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
    col[(k + j) * LG_TS] = valid ? f32_to_bf16_bits(shv[j]) : 0;
  for (int j = encoded_dims; j < LG_WIDTH; ++j) col[j * LG_TS] = 0;
}
