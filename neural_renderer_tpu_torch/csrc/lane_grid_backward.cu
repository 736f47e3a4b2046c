// Backward of the fused lane-grid network in training layout (replaces the
// TPU kernel neural_renderer_tpu/ops/lane_grid_train_kernel.py::_bwd_kernel).
//
// Inputs: x [12, n] f32, the output cotangent g [16, n] f32, the f32 master
// tables feature-interleaved as [P*L][rows*128] entries of 4 f32 (the
// training layout, entry = row * 128 + lane) and the bf16 weights. Outputs,
// summed over the n rays: table gradients in the same interleaved layout
// (the wrapper permutes them back into the masters' shape) and MLP weight
// gradients dW0..dW3 [128, 128] and dWout [16, 128] f32 (with respect to
// the bf16 weights). The input cotangent is not computed: inputs are data.
//
// Rounding points (the PyTorch twin, ops/lane_grid_train_kernel.py::
// backward_twin, rounds at the same places): the forward is recomputed with
// bf16 activations and the LeakyReLU masks of its f32 pre-activations; g is
// rounded to bf16; each layer's delta is masked, then rounded to bf16; dW
// sums products of bf16 operands in f32; d_enc stays f32; each table
// contribution is bf16(d_enc * corner weight), added in f32. Every sum of
// products that is rounded to bf16 or decides a mask (pre-activations,
// deltas, d_enc) is the exact sum rounded once to f32, as the twin takes
// it. mma.sync gives it to within LB_TOL of the sum of the products'
// magnitudes, which a second mma on |A| and |B| gives. An element whose bf16
// rounding, sign or table contribution that interval leaves open is summed
// again exactly (f64, from the staging tile): 1-2% of the activations and
// deltas and ~10% of the d_enc features (scripts/lane_grid_numerics.py
// measures both the rates and the mma error). So the bf16 values and masks
// are the twin's, and the gradients differ from its only by the order of
// the f32 dW and table sums. Without that step a flipped bf16 rounding in
// one layer moves the next layers' activations and masks, and one ray's
// gradient moves by a large part of itself.

// The TPU kernel carries every gradient accumulator (1.5 MiB of tables,
// 67,584 MLP entries) in VMEM across a sequential grid. Blocks of a GPU run
// in parallel and in no order and have at most 227 KB of shared memory, so
// the sums are split into two passes:
//   1. lane_grid_backward_rays: persistent blocks of 8 warps with the bf16
//      weights in shared memory, as in lane_grid_forward.cu; a warp takes
//      32 rays at a time. It recomputes the forward on the tensor cores
//      (mma.sync.m16n8k16) with the LeakyReLU masks kept as bits in
//      registers (a pre-activation's C-fragment position is its delta's),
//      then runs the delta chain delta_{l-1} = bf16(mask . delta_l) W_l on
//      the tensor cores too, B fragments read with plain ldmatrix from the
//      same [in][out] copy the forward reads with ldmatrix.trans. Each
//      layer's input stays in the warp's staging tile (A fragments are read
//      from it with ldmatrix.trans) until its output is decided: the open
//      elements of all 32 lanes go through a per-warp queue in shared
//      memory, so each lane sums about as many again as the others. Then
//      the output replaces the input and goes to scratch ([rows, stride]
//      bf16, rays contiguous: h0..h4, db0..db3 and g), 16 bytes per store.
//      d_enc = W0^T db0 stays f32: one shuffle puts the 4 features of one
//      (point, level) of one ray in one lane, which adds bf16(d_enc * w_c)
//      to each corner's entry with one float4 atomicAdd (192 per ray at 3
//      points x 8 levels x 8 corners).
//   2. lane_grid_backward_dw: dW_l = db_l^T h_l summed over rays, a bf16
//      GEMM with M = 128 (16 for the output layer), N = 128 and K = rays on
//      mma.sync. ds rows are A row-major and hs rows B column-major as they
//      lie; 32-ray slices of both are staged with cp.async, double
//      buffered. The ray axis is split over blocks; each block adds its
//      tile to dW with one f32 atomicAdd per entry.
// f32 atomics reorder the sums from run to run.
//
// Bound: operations. Per ray 3 x 65,536 multiply-adds on the bf16 tensor
// cores (forward recompute, the delta chain, the dW products). On top come
// 192 table reads and 192 vector atomics per ray, and 2,336 bytes of
// scratch written and read again.
#include <stdint.h>

#include "lane_grid.cuh"
#include "mt.cuh"

#define LB_THREADS (LG_WARPS * 32)
#define LB_SLICE 32   // rays per staged slice of the dW pass
#define LB_DS 40      // staging row stride of the dW pass (bf16)
// A warp's queue of elements to sum exactly, in shared memory after the
// staging tiles: ray | channel << 5 | (forward) sign << 15.
#define LB_QUEUE 256
#define LB_SMEM (LG_SMEM + LG_WARPS * LB_QUEUE * 2)
// For d_enc the same 512 bytes hold 64 tasks, then their 64 f32 sums.
#define LB_ENC_TASKS 64

__device__ __forceinline__ float bf16_round(float v) {
  return bf16_bits_to_f32(f32_to_bf16_bits(v));
}

// Writes the bf16 pairs of one m16n16 block of a layer's output, held as
// the next layer's A fragment w[mt][q] of channels 16 j .. 16 j + 15, into
// the channel-major staging tile.
__device__ __forceinline__ void lg_stage_pairs(uint16_t* st, const uint32_t* w,
                                               int mt, int j, int lane) {
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int ch = 16 * j + 2 * tig + (q >> 1) * 8;
    const int ray = 16 * mt + g + (q & 1) * 8;
    st[ch * LG_TS + ray] = (uint16_t)(w[q] & 0xFFFFu);
    st[(ch + 1) * LG_TS + ray] = (uint16_t)(w[q] >> 16);
  }
}

// Copies `rows` channel rows of the staging tile to dst[row * ld + r0 ..],
// 16 bytes per lane per step (ld and r0 multiples of 8).
__device__ __forceinline__ void lg_store_tile(uint16_t* dst, long long ld,
                                              long long r0,
                                              const uint16_t* st, int rows,
                                              int lane) {
  for (int q = lane; q < rows * 4; q += 32) {
    const int row = q >> 2, part = q & 3;
    *reinterpret_cast<uint4*>(dst + row * ld + r0 + part * 8) =
        *reinterpret_cast<const uint4*>(st + row * LG_TS + part * 8);
  }
}

// How far a tensor-core f32 sum of up to 128 bf16 products may lie from
// the exact sum, relative to the sum of the products' magnitudes: 8 mma
// steps that each truncate at most 2^-23 of it, twice over. Measured
// (scripts/lane_grid_numerics.py): at most 2^-20.2 on an H100.
#define LB_TOL 1.9073486328125e-06f  // 2^-19

__device__ __forceinline__ uint32_t abs_pair(uint32_t w) {
  return w & 0x7FFF7FFFu;
}

// The bf16 a hidden activation or a delta rounds to: LeakyReLU of the
// pre-activation v, or v masked by the forward's sign bit m.
__device__ __forceinline__ uint16_t act_bits(float v) {
  return f32_to_bf16_bits(v > 0.0f ? v : 0.01f * v);
}
__device__ __forceinline__ uint16_t delta_bits(float v, uint32_t m) {
  return f32_to_bf16_bits(m ? v : 0.01f * v);
}

// C = A x B over k_tiles k16 tiles for the 16 output channels 16 j .. 16 j
// + 15 of one layer, and cabs = |A| x |B|, the scale of C's rounding error.
// A: the warp's 32 rays in the staging tile st (read with ldmatrix.trans
// each time, which keeps 64 registers free for the layer's outputs). TRANS:
// B from the [in][out] weight w (row stride ws) by ldmatrix.trans, outputs
// = out channels (the forward); else by plain ldmatrix, outputs = in
// channels (the delta chain and d_enc).
template <bool TRANS>
__device__ __forceinline__ void lb_products(const uint16_t* st,
                                            const uint16_t* w, int ws,
                                            int j, int k_tiles, int lane,
                                            float (*c)[4], float (*cabs)[4]) {
  const int blk = lane >> 3, row = lane & 7;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) c[mt * 2 + nt][q] = cabs[mt * 2 + nt][q] =
          0.0f;
#pragma unroll
  for (int kt = 0; kt < 8; ++kt) {
    if (kt >= k_tiles) break;
    uint32_t b[4];
    if (TRANS)
      ldsm_x4_trans(b, w + (16 * kt + row + (blk & 1) * 8) * ws + 16 * j +
                           (blk >> 1) * 8);
    else
      ldsm_x4(b, w + (16 * j + row + (blk >> 1) * 8) * ws + 16 * kt +
                     (blk & 1) * 8);
    const uint32_t bb[4] = {abs_pair(b[0]), abs_pair(b[1]), abs_pair(b[2]),
                            abs_pair(b[3])};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      uint32_t a[4];
      ldsm_x4_trans(a, st + (16 * kt + row + (blk >> 1) * 8) * LG_TS +
                           16 * mt + (blk & 1) * 8);
      const uint32_t aa[4] = {abs_pair(a[0]), abs_pair(a[1]), abs_pair(a[2]),
                              abs_pair(a[3])};
      mma_bf16(c[mt * 2], a, b[0], b[1]);
      mma_bf16(c[mt * 2 + 1], a, b[2], b[3]);
      mma_bf16(cabs[mt * 2], aa, bb[0], bb[1]);
      mma_bf16(cabs[mt * 2 + 1], aa, bb[2], bb[3]);
    }
  }
}

// The f32 rounding of the exact sum of k products st[i][ray] * w[i * w_in]:
// the product of two bf16 values is exact in f32, and f64 holds their sum
// to ~1e-14 whatever its order (four chains here).
__device__ __forceinline__ float lb_exact(const uint16_t* st, int ray,
                                          const uint16_t* w, int w_in,
                                          int k) {
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  for (int i = 0; i < k; i += 4)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      acc[u] += (double)(bf16_bits_to_f32(st[(i + u) * LG_TS + ray]) *
                         bf16_bits_to_f32(w[(i + u) * w_in]));
  return (float)((acc[0] + acc[1]) + (acc[2] + acc[3]));
}

// Element e of a thread's 128 C-fragment values of one layer (the bit
// layout of the masks and flags: bit (j & 1) * 16 + mt * 8 + nt * 4 + q of
// word j / 2) -> its ray in the tile and its channel.
__device__ __forceinline__ void lb_element(int e, int lane, int* ray,
                                           int* ch) {
  const int j = 2 * (e >> 5) + ((e >> 4) & 1), mt = (e >> 3) & 1;
  const int nt = (e >> 2) & 1, q = e & 3;
  *ray = 16 * mt + (lane >> 2) + (q >> 1) * 8;
  *ch = 16 * j + 8 * nt + 2 * (lane & 3) + (q & 1);
}

// Pops the lowest flagged element of fl[0..3], or returns -1.
__device__ __forceinline__ int lb_pop(uint32_t* fl) {
  int e = -1;
#pragma unroll
  for (int wi = 0; wi < 4; ++wi)
    if (e < 0 && fl[wi] != 0u) {
      e = wi * 32 + __ffs(fl[wi]) - 1;
      fl[wi] &= fl[wi] - 1u;
    }
  return e;
}

// Sums the warp's flagged elements (fl[0..3] of every lane) exactly, spread
// evenly over the lanes through the warp's queue q: a lane pushes its
// elements, then each lane takes every 32nd. The computing lane keeps the
// result's bf16 bits in fixes (bits | channel << 16 | ray << 24) for
// lb_stage. FWD: the element is a pre-activation of the [in][out] weight w
// (columns: outputs, k inputs) and the owner gets its sign back in mk[0..3];
// else a delta (w's rows: outputs), masked by the bit of mk[0..3] its owner
// puts in the queue entry.
template <bool FWD>
__device__ __forceinline__ int lb_resum(uint32_t* fl, uint32_t* mk,
                                        const uint16_t* st,
                                        const uint16_t* w, int ws, int k,
                                        uint16_t* q, uint32_t* fixes,
                                        int lane) {
  int nfix = 0;
  while (true) {
    const int cnt =
        __popc(fl[0]) + __popc(fl[1]) + __popc(fl[2]) + __popc(fl[3]);
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += t;
    }
    const int total = __shfl_sync(0xFFFFFFFFu, incl, 31);
    if (total == 0) break;
    const int first = incl - cnt;
    int slot = first;
    while (slot < LB_QUEUE) {
      const int e = lb_pop(fl);
      if (e < 0) break;
      int ray, ch;
      lb_element(e, lane, &ray, &ch);
      uint32_t m = 0;  // a delta's mask, from its owner
#pragma unroll
      for (int wi = 0; wi < 4; ++wi)
        if (!FWD && wi == (e >> 5)) m = (mk[wi] >> (e & 31)) & 1u;
      q[slot++] = (uint16_t)(ray | (ch << 5) | (m << 15));
    }
    __syncwarp();
    const int n_tasks = total < LB_QUEUE ? total : LB_QUEUE;
    for (int t = lane; t < n_tasks; t += 32) {
      const uint32_t task = q[t];
      const int ray = task & 31, ch = (task >> 5) & 127;
      uint16_t bits;
      if (FWD) {
        const float v = lb_exact(st, ray, w + ch, ws, k);
        bits = act_bits(v);
        q[t] = (uint16_t)(task | (v > 0.0f ? 0x8000u : 0u));
      } else {
        const float v = lb_exact(st, ray, w + ch * ws, 1, k);
        bits = delta_bits(v, (task >> 15) & 1u);
      }
      fixes[nfix++] = bits | ((uint32_t)ch << 16) | ((uint32_t)ray << 24);
    }
    __syncwarp();
    if (FWD) {
      for (int t = first; t < slot; ++t) {  // signs back to their owners
        const uint32_t task = q[t];
        const int ray = task & 31, ch = (task >> 5) & 127;
        const int e = ((ch >> 5) << 5) | (((ch >> 4) & 1) << 4) |
                      ((ray >> 4) << 3) | (((ch >> 3) & 1) << 2) |
                      (((ray >> 3) & 1) << 1) | (ch & 1);
        const uint32_t bit = 1u << (e & 31);
#pragma unroll
        for (int wi = 0; wi < 4; ++wi)
          if (wi == (e >> 5))
            mk[wi] = (task & 0x8000u) ? (mk[wi] | bit) : (mk[wi] & ~bit);
      }
      __syncwarp();
    }
  }
  return nfix;
}

// Writes a layer's output to the staging tile: the tensor-core values nxt,
// then the nfix exactly summed ones (bf16 bits | channel << 16 | ray <<
// 24). Every lane must be done reading the tile's input first.
__device__ __forceinline__ void lb_stage(uint16_t* st, uint32_t (*nxt)[8][4],
                                         const uint32_t* fixes, int nfix,
                                         int lane) {
  __syncwarp();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j) lg_stage_pairs(st, nxt[mt][j], mt, j, lane);
  for (int i = 0; i < nfix; ++i)
    st[((fixes[i] >> 16) & 0xFFu) * LG_TS + (fixes[i] >> 24)] =
        (uint16_t)(fixes[i] & 0xFFFFu);
  __syncwarp();
}

// One forward layer of the recompute: the staging tile holds its input h
// and receives h' = bf16(LeakyReLU(h W)); mk[0..3]
// receive the pre-activations' signs. Where the tensor-core sum cannot
// decide the bf16 rounding or the sign (within LB_TOL of |h| |W|), the
// element is summed exactly, so h' and the masks are those of the exact
// sums rounded once to f32, as the twin takes them.
__device__ __forceinline__ void lb_forward_layer(const uint16_t* wl,
                                                 uint32_t* mk, uint16_t* st,
                                                 uint16_t* q, uint32_t* fixes,
                                                 int lane) {
  uint32_t nxt[2][8][4];
  uint32_t fl[4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float c[4][4], cabs[4][4];
    lb_products<true>(st, wl, LG_WS, j, 8, lane, c, cabs);
    uint32_t bits = 0, flags = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v = c[t][q], e = LB_TOL * cabs[t][q];
        if (v > 0.0f) bits |= 1u << (t * 4 + q);
        if (act_bits(v - e) != act_bits(v + e) ||
            ((v - e) > 0.0f) != ((v + e) > 0.0f))
          flags |= 1u << (t * 4 + q);
      }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        nxt[mt][j][2 * nt] = act_pair(c[mt * 2 + nt][0], c[mt * 2 + nt][1]);
        nxt[mt][j][2 * nt + 1] =
            act_pair(c[mt * 2 + nt][2], c[mt * 2 + nt][3]);
      }
    if (j & 1) {
      mk[j >> 1] |= bits << 16;
      fl[j >> 1] |= flags << 16;
    } else {
      mk[j >> 1] = bits;
      fl[j >> 1] = flags;
    }
  }
  const int nfix =
      lb_resum<true>(fl, mk, st, wl, LG_WS, LG_WIDTH, q, fixes, lane);
  lb_stage(st, nxt, fixes, nfix, lane);
}

// One layer of the delta chain: the staging tile holds the delta of the
// layer's outputs (k_tiles k16 tiles of channels) and receives
// bf16(mask . (delta W^T)) over the layer's inputs, w the [in][out] weight
// (row stride ws), mk[0..3] the forward's signs of those inputs. Undecided
// roundings are summed exactly, as in lb_forward_layer.
__device__ __forceinline__ void lb_delta_layer(const uint16_t* w, int ws,
                                               int k_tiles,
                                               uint32_t* mk, uint16_t* st,
                                               uint16_t* q, uint32_t* fixes,
                                               int lane) {
  uint32_t nxt[2][8][4];
  uint32_t fl[4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float c[4][4], cabs[4][4];
    lb_products<false>(st, w, ws, j, k_tiles, lane, c, cabs);
    const uint32_t bits = mk[j >> 1] >> ((j & 1) * 16);
    uint32_t flags = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t m = (bits >> (t * 4 + q)) & 1u;
        const float v = c[t][q], e = LB_TOL * cabs[t][q];
        if (delta_bits(v - e, m) != delta_bits(v + e, m))
          flags |= 1u << (t * 4 + q);
      }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int t = mt * 2 + nt;
        const uint32_t m = bits >> (t * 4);
        nxt[mt][j][2 * nt] = (uint32_t)delta_bits(c[t][0], m & 1u) |
                             ((uint32_t)delta_bits(c[t][1], (m >> 1) & 1u)
                              << 16);
        nxt[mt][j][2 * nt + 1] =
            (uint32_t)delta_bits(c[t][2], (m >> 2) & 1u) |
            ((uint32_t)delta_bits(c[t][3], (m >> 3) & 1u) << 16);
      }
    if (j & 1)
      fl[j >> 1] |= flags << 16;
    else
      fl[j >> 1] = flags;
  }
  const int nfix = lb_resum<false>(fl, mk, st, w, ws,
                                    16 * k_tiles, q, fixes, lane);
  lb_stage(st, nxt, fixes, nfix, lane);
}

__global__ void __launch_bounds__(LB_THREADS, 1)
lane_grid_backward_rays(const float* __restrict__ x,
                        const float* __restrict__ g, int n, int stride,
                        const uint4* __restrict__ tables,
                        const uint16_t* __restrict__ w_hidden,
                        const uint16_t* __restrict__ w_out,
                        const float* __restrict__ scales, int n_points,
                        int n_levels, int rows, int encoded_dims,
                        uint16_t* __restrict__ hs, uint16_t* __restrict__ ds,
                        float4* __restrict__ d_tables) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* sw = reinterpret_cast<uint16_t*>(smem);
  uint16_t* swo = reinterpret_cast<uint16_t*>(smem + LG_SMEM_W);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint16_t* st = reinterpret_cast<uint16_t*>(
      smem + LG_SMEM_W + LG_SMEM_WOUT + warp * LG_SMEM_TILE);
  uint16_t* q = reinterpret_cast<uint16_t*>(smem + LG_SMEM) + warp * LB_QUEUE;
  lg_load_weights(w_hidden, w_out, sw, swo);
  __syncthreads();

  const int gq = lane >> 2, tig = lane & 3;
  const uint32_t n_entries = (uint32_t)(rows * LG_GROUP);
  const int n_groups = n_points * n_levels;
  const long long ls = stride;
  const long long step = (long long)gridDim.x * LG_WARPS * LG_TILE_RAYS;
  uint32_t fixes[4 * 32];  // a layer's exactly summed elements

  for (long long r0 = ((long long)blockIdx.x * LG_WARPS + warp) *
                      LG_TILE_RAYS;
       r0 < stride; r0 += step) {
    const long long r = r0 + lane;
    // ---- forward recompute: encode -> h0 ----
    __syncwarp();
    lg_encode_column(x, n, r, r < n, tables, scales, n_points, n_levels, 1,
                     n_entries, encoded_dims, st, lane);
    __syncwarp();
    lg_store_tile(hs, ls, r0, st, LG_WIDTH, lane);

    // ---- forward recompute: hidden layers -> h1..h4 and the masks ----
    // mk[4 l .. 4 l + 3]: the signs of layer l's pre-activations in the
    // element layout of lb_element. Each layer shifts the words down and
    // writes 12..15, so that after four layers word 4 l + i is layer l's.
    uint32_t mk[16] = {};
#pragma unroll 1
    for (int layer = 0; layer < 4; ++layer) {
#pragma unroll
      for (int i = 0; i < 12; ++i) mk[i] = mk[i + 4];
      lb_forward_layer(sw + layer * LG_WIDTH * LG_WS, mk + 12, st, q, fixes,
                       lane);
      lg_store_tile(hs + (layer + 1) * LG_WIDTH * ls, ls, r0, st, LG_WIDTH,
                    lane);
    }

    // ---- backward: bf16(g) -> db3 through the output layer ----
    __syncwarp();
#pragma unroll
    for (int o = 0; o < LG_OUT; ++o)
      st[o * LG_TS + lane] =
          r < n ? f32_to_bf16_bits(g[o * (long long)n + r]) : (uint16_t)0;
    __syncwarp();
    lg_store_tile(ds + 4 * LG_WIDTH * ls, ls, r0, st, LG_OUT, lane);
    lb_delta_layer(swo, LG_WOS, 1, mk + 12, st, q, fixes, lane);
    lg_store_tile(ds + 3 * LG_WIDTH * ls, ls, r0, st, LG_WIDTH, lane);

    // ---- backward: db_l -> db_{l-1} through hidden layer l ----
#pragma unroll 1
    for (int layer = 3; layer >= 1; --layer) {
#pragma unroll
      for (int i = 15; i >= 4; --i) mk[i] = mk[i - 4];
      lb_delta_layer(sw + layer * LG_WIDTH * LG_WS, LG_WS, 8, mk + 12, st, q,
                     fixes, lane);
      lg_store_tile(ds + (layer - 1) * LG_WIDTH * ls, ls, r0, st, LG_WIDTH,
                    lane);
    }

    // ---- d_enc = W0^T db0 (f32) -> table gradients ----
    // C-fragment pair (tig, tig ^ 1) holds channels 16 j + 8 nt + 4 (tig >>
    // 1) .. + 3, i.e. the 4 features of group G = 4 j + 2 nt + (tig >> 1),
    // of rays gq and gq + 8; one exchange gives the even lane ray gq's four
    // and the odd lane ray gq + 8's. A feature whose contribution
    // bf16(d_enc * w_c) the tensor-core sum leaves open for some corner is
    // summed again exactly from db0 (the staging tile), spread over the
    // lanes through the queue: tasks ray | feature << 5, then their sums.
    const int j_groups = (4 * n_groups + 15) / 16;
    const bool odd = (tig & 1) != 0;
    float* res = reinterpret_cast<float*>(q + LB_ENC_TASKS);
#pragma unroll 1
    for (int j = 0; j < j_groups; ++j) {
      float c[4][4], cabs[4][4];
      lb_products<false>(st, sw, LG_WS, j, 8, lane, c, cabs);
      float d[4][4];
      uint32_t open = 0;  // bit 4 t + f: d[t][f] is summed again
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* cc = c[t];
        const float* ca = cabs[t];
        const float s0 = __shfl_xor_sync(0xFFFFFFFFu, odd ? cc[0] : cc[2], 1);
        const float s1 = __shfl_xor_sync(0xFFFFFFFFu, odd ? cc[1] : cc[3], 1);
        const float e0 = __shfl_xor_sync(0xFFFFFFFFu, odd ? ca[0] : ca[2], 1);
        const float e1 = __shfl_xor_sync(0xFFFFFFFFu, odd ? ca[1] : ca[3], 1);
        d[t][0] = odd ? s0 : cc[0];
        d[t][1] = odd ? s1 : cc[1];
        d[t][2] = odd ? cc[2] : s0;
        d[t][3] = odd ? cc[3] : s1;
        const float de[4] = {odd ? e0 : ca[0], odd ? e1 : ca[1],
                             odd ? ca[2] : e0, odd ? ca[3] : e1};
        const int grp = 4 * j + 2 * (t & 1) + (tig >> 1);
        const long long rr = r0 + 16 * (t >> 1) + gq + (odd ? 8 : 0);
        if (grp >= n_groups || rr >= n) continue;
        const int p = grp / n_levels, level = grp - p * n_levels;
        uint32_t idx[8];
        float wc[8];
        lg_corners(x[(3 * p) * (long long)n + rr],
                   x[(3 * p + 1) * (long long)n + rr],
                   x[(3 * p + 2) * (long long)n + rr], scales[level],
                   n_entries, idx, wc);
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const float lo = d[t][f] - LB_TOL * de[f];
          const float hi = d[t][f] + LB_TOL * de[f];
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (f32_to_bf16_bits(lo * wc[k]) != f32_to_bf16_bits(hi * wc[k]))
              open |= 1u << (4 * t + f);
        }
      }
      uint32_t rest = open;
      while (true) {
        const int cnt = __popc(rest);
        int incl = cnt;
#pragma unroll
        for (int dd = 1; dd < 32; dd <<= 1) {
          const int v = __shfl_up_sync(0xFFFFFFFFu, incl, dd);
          if (lane >= dd) incl += v;
        }
        const int total = __shfl_sync(0xFFFFFFFFu, incl, 31);
        if (total == 0) break;
        const int first = incl - cnt;
        int slot = first;
        uint32_t pushed = 0, m = rest;
        while (m != 0u && slot < LB_ENC_TASKS) {
          const int b = __ffs(m) - 1;
          m &= m - 1u;
          const int t = b >> 2;
          const int ray = 16 * (t >> 1) + gq + (odd ? 8 : 0);
          const int feature = 4 * (4 * j + 2 * (t & 1) + (tig >> 1)) + (b & 3);
          q[slot++] = (uint16_t)(ray | (feature << 5));
          pushed |= 1u << b;
        }
        rest &= ~pushed;
        __syncwarp();
        const int n_tasks = total < LB_ENC_TASKS ? total : LB_ENC_TASKS;
        for (int tt = lane; tt < n_tasks; tt += 32) {
          const uint32_t task = q[tt];
          res[tt] = lb_exact(st, task & 31, sw + (task >> 5) * LG_WS, 1,
                             LG_WIDTH);
        }
        __syncwarp();
        int s2 = first;
#pragma unroll
        for (int b = 0; b < 16; ++b)
          if ((pushed >> b) & 1u) d[b >> 2][b & 3] = res[s2++];
        __syncwarp();
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int grp = 4 * j + 2 * (t & 1) + (tig >> 1);
        const long long rr = r0 + 16 * (t >> 1) + gq + (odd ? 8 : 0);
        if (grp >= n_groups || rr >= n) continue;
        const int p = grp / n_levels, level = grp - p * n_levels;
        uint32_t idx[8];
        float wc[8];
        lg_corners(x[(3 * p) * (long long)n + rr],
                   x[(3 * p + 1) * (long long)n + rr],
                   x[(3 * p + 2) * (long long)n + rr], scales[level],
                   n_entries, idx, wc);
        float4* dt = d_tables + (long long)grp * n_entries;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          atomicAdd(dt + idx[k],
                    make_float4(bf16_round(d[t][0] * wc[k]),
                                bf16_round(d[t][1] * wc[k]),
                                bf16_round(d[t][2] * wc[k]),
                                bf16_round(d[t][3] * wc[k])));
      }
    }
  }
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(src));
}

// Grid (5 layers, ray splits) of 8 warps. A warp owns 32 rows (o) x 64
// columns (i) of the layer's dW: warp & 3 picks the rows, warp >> 2 the
// columns; for the 16-row output layer only warps 0 and 4 have rows.
__global__ void __launch_bounds__(LB_THREADS)
lane_grid_backward_dw(const uint16_t* __restrict__ hs,
                      const uint16_t* __restrict__ ds, int stride,
                      int slices_per_block, float* __restrict__ d_w) {
  __shared__ __align__(16) uint16_t sa[2][LG_WIDTH * LB_DS];
  __shared__ __align__(16) uint16_t sb[2][LG_WIDTH * LB_DS];
  const int layer = blockIdx.x;
  const int m_rows = layer < 4 ? LG_WIDTH : LG_OUT;
  const uint16_t* asrc = ds + (long long)layer * LG_WIDTH * stride;
  const uint16_t* bsrc = hs + (long long)layer * LG_WIDTH * stride;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int gq = lane >> 2, tig = lane & 3;
  const int blk = lane >> 3, row = lane & 7;
  const bool active = wm * 32 < m_rows;

  const long long slices = stride / LB_SLICE;
  const long long s0 = (long long)blockIdx.y * slices_per_block;
  const long long s1 = min(slices, s0 + slices_per_block);
  if (s0 >= s1) return;

  auto load = [&](long long s, int buf) {
    const long long c0 = s * LB_SLICE;
    for (int q = tid; q < (m_rows + LG_WIDTH) * 4; q += LB_THREADS) {
      const bool is_a = q < m_rows * 4;
      const int qq = is_a ? q : q - m_rows * 4;
      const int rrow = qq >> 2, part = qq & 3;
      const uint16_t* src = (is_a ? asrc : bsrc) + rrow * (long long)stride +
                            c0 + part * 8;
      uint16_t* dst = (is_a ? sa[buf] : sb[buf]) + rrow * LB_DS + part * 8;
      cp_async16(dst, src);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[2][8][4] = {};
  load(s0, 0);
  for (long long s = s0; s < s1; ++s) {
    const int buf = (int)((s - s0) & 1);
    if (s + 1 < s1) {
      load(s + 1, buf ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kt = 0; kt < LB_SLICE / 16; ++kt) {
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldsm_x4(af[mt], sa[buf] + (wm * 32 + 16 * mt + row + (blk & 1) * 8) *
                                        LB_DS +
                              16 * kt + (blk >> 1) * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          ldsm_x4(b, sb[buf] + (wn * 64 + 16 * np + row + (blk >> 1) * 8) *
                                   LB_DS +
                         16 * kt + (blk & 1) * 8);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(acc[mt][2 * np], af[mt], b[0], b[1]);
            mma_bf16(acc[mt][2 * np + 1], af[mt], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;
  float* out = d_w + (long long)layer * LG_WIDTH * LG_WIDTH;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = wm * 32 + 16 * mt + gq + (q >> 1) * 8;
        const int i = wn * 64 + 8 * nt + 2 * tig + (q & 1);
        if (o < m_rows) atomicAdd(out + o * LG_WIDTH + i, acc[mt][nt][q]);
      }
    }
  }
}

// x [12, n] and g [16, n] f32, contiguous; stride = n rounded up to
// LB_SLICE; hs [5 * 128, stride] (activations h0..h4) and ds [4 * 128 + 16,
// stride] (deltas db0..db3, then the bf16 g) bf16 scratch;
// tables and d_tables feature-interleaved [P*L][rows*128] x 4 f32; d_tables
// and d_w (4 x 128 x 128 + 16 x 128 f32) zeroed by the caller.
extern "C" int lane_grid_backward(const float* x, const float* g, int n,
                                  int stride, const uint4* tables,
                                  const uint16_t* w_hidden,
                                  const uint16_t* w_out, const float* scales,
                                  int n_points, int n_levels, int rows,
                                  int encoded_dims, uint16_t* hs,
                                  uint16_t* ds, float4* d_tables, float* d_w,
                                  cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        lane_grid_backward_rays, cudaFuncAttributeMaxDynamicSharedMemorySize,
        LB_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  if (stride % LB_SLICE != 0 || stride < n) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int per_block = LG_WARPS * LG_TILE_RAYS;
  const int blocks_needed = (stride + per_block - 1) / per_block;
  const int grid = blocks_needed < sms ? blocks_needed : sms;
  if (grid == 0) return 0;
  lane_grid_backward_rays<<<grid, LB_THREADS, LB_SMEM, stream>>>(
      x, g, n, stride, tables, w_hidden, w_out, scales, n_points, n_levels,
      rows, encoded_dims, hs, ds, d_tables);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // Split the ray axis so that about two dW blocks run per SM.
  const int slices = stride / LB_SLICE;
  int splits = (2 * sms + 4) / 5;
  if (splits > slices) splits = slices;
  const int per_split = (slices + splits - 1) / splits;
  splits = (slices + per_split - 1) / per_split;
  lane_grid_backward_dw<<<dim3(5, splits), LB_THREADS, 0, stream>>>(
      hs, ds, stride, per_split, d_w);
  return static_cast<int>(cudaGetLastError());
}

NR_ERROR_STRING_ENTRY
