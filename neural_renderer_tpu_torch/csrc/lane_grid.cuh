// Device code shared by the lane-grid network kernels (lane_grid_forward.cu,
// lane_grid_backward.cu): bf16 conversions, the trilinear corners of one
// (point, level) of the lane hash grid and the degree-4 SH encoding, in the
// PyTorch twin's expression order (models/lane_grid.py, models/encoding.py).
// The files are compiled with -fmad=false, so each product and sum rounds
// separately, as in the twin.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#define LG_WIDTH 128
#define LG_OUT 16
#define LG_GROUP 128

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
