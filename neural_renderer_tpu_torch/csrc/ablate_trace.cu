// The trace-kernel ablation's dense closest hit (replaces the TPU kernel
// scripts/ablate_trace_kernel.py::trace_variant :149, pallas_call :152;
// body make_kernel :110, tile math _mt_tile :47 and _probe_tile :100).
//
// The ablation splits the production trace kernel's gap to its bound into
// tile math, block shape and tile shape, so its `local` is the production
// trace: K3's walk (csrc/mt_dense.cuh; K3 itself is trace_dense.cu), here
// with no skip flags and a tile math and a shape per variant.
//
// Tile math (csrc/mt_variants.cuh, shared with the sweep family,
// ablate_sweep.cu, where each prefilter rule is argued): `local` DfMt,
// `recip` DfRecip, `recipx` DfRecipx, `nodiv` DfNodiv, `bf16` DfBf16 (the
// thread's two rays in a bf16x2, each staged chunk converted once). ANY
// mode, so no facing vote; each rule rejects only pairs its math rejects.
//
// Shape. The reference's (block, tile) are its rays a grid step and its
// triangles a register tile. Here they are the CTA's rays and the staged
// chunk: `block` rays a CTA (block / 2 threads of two rays) and tile / 2
// triangles a chunk, so that `local`'s (512, 128) is K3's own launch
// (512-ray CTAs, 64-triangle chunks) and the others scale from it: b256
// and b1024 256 and 1024 rays a CTA, t256, t512, t1024 chunks of 128, 256
// and 512 triangles (t1024's double buffer 2 x 512 x 12 x 4 B = 48 KiB,
// the static limit), b256t256 (256, 128), b1024t512 (1024, 256). A launch
// takes triangle slices (nr_dense_slices) until its CTAs reach 16 x 512 /
// block an SM: the rays in flight an SM of K3's launch, so that a block
// variant changes the CTA and not the work an SM holds. Per ray the
// closest hit: each thread keeps (t, id) of its two rays from the
// variant's miss value (bf16's is NR_BF16_MISS) with a strict < over
// increasing ids, which keeps the smallest id at the minimum t as the
// reference's lane reduction (:134-137) does; with more than one slice
// nr_dense_fold merges the slices by (t, smallest id) from the same miss
// value. One library holds every combination the reference's dispatch
// names (:397-418); the C entries refuse any other.
//
// The probe (`probe`, `t256probe`, `t512probe`) measures the rate of
// unfused FP32 instructions and has no hit for a rule to cut: it keeps its
// own loop, one thread per ray, a 9 x TILE tile staged between two
// barriers, NR_PROBE_CHAINS independent chains side by side; it writes its
// chains' minimum and id 0.
//
// Bound (ops/bounds.py): the variant's operations per (ray, triangle) pair
// (46, nodiv 47, the probe 50) at the card's rate of unfused FP32
// instructions (-fmad=false: one instruction per operation), bf16 at two
// per lane per clock; filtered, its rule's operations on every pair and
// the rest of its math on the pairs the rule leaves (bounds.dense_seconds
// with the variant's counts; `local`'s is K3's).
#include "mt_variants.cuh"

// The walk's shape at the reference's (block, tile).
template <int kBlock, int kTile>
using AtShape = DfShape<kBlock / DF_R, kTile / 2>;

template <class M, class S>
__global__ void __launch_bounds__(S::kThreads)
ablate_walk_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   int npad, const float* __restrict__ tris, int ttot,
                   int slices, float* __restrict__ out) {
  __shared__ __align__(16) float buf[2 * S::kBuf];
  const long long ray0 = (long long)blockIdx.x * S::kRays;
  const int s = blockIdx.y;
  DfRays r;
  df_load<S>(o, d, npad, ray0, r);
  float bt[DF_R];
  int bi[DF_R];
#pragma unroll
  for (int i = 0; i < DF_R; ++i) {
    bt[i] = M::kMiss;
    bi[i] = 0;
  }
  const int nchunks = ttot / S::kChunk;
  df_walk<0, M, S>(tris, ttot, nr_slice_chunk(s, nchunks, slices),
                   nr_slice_chunk(s + 1, nchunks, slices), M::rays(r), buf,
                   [&](int i, int id, float t, float) {
                     if (t < bt[i]) {
                       bt[i] = t;
                       bi[i] = id;
                     }
                   });
  float* dst = out + (long long)s * 2 * npad;  // a slice's partial rows
#pragma unroll
  for (int i = 0; i < DF_R; ++i) {
    dst[df_ray<S>(ray0, i)] = bt[i];
    dst[npad + df_ray<S>(ray0, i)] = __int_as_float(bi[i]);
  }
}

template <int BLOCK, int TILE>
__global__ void __launch_bounds__(BLOCK)
ablate_probe_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    int n, const float* __restrict__ tris, int ttot,
                    float* __restrict__ out) {
  static_assert(TILE % NR_PROBE_CHAINS == 0, "tile of whole probe groups");
  __shared__ float tile[9][TILE];
  const long long r = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const NrRay ray{o[r], o[n + r], o[2LL * n + r],
                  d[r], d[n + r], d[2LL * n + r]};
  float best = MtProbe::kMiss;
  for (int base = 0; base < ttot; base += TILE) {
    __syncthreads();  // previous tile fully consumed
    nr_stage_tile<TILE>(tile, tris, ttot, base);
    __syncthreads();
    for (int q = 0; q < TILE; q += NR_PROBE_CHAINS)
      best = MtProbe::chains<TILE>(ray, tile, q, best);
  }
  out[r] = best;
  out[n + r] = __int_as_float(0);
}

// The triangle slices of a walk launch at (block, tile).
static int walk_slices(int block, int tile, int npad, int ttot,
                       int* slices) {
  return nr_dense_slices(npad, ttot, block, tile / 2,
                         DF_CTAS_PER_SM * DfDense::kRays / block, slices);
}

// part: [slices][2][n] f32 scratch (unused with one slice).
template <class M, int B, int T>
static int walk_launch(const float* o, const float* d, int n,
                       const float* tris, int ttot, int slices, float* part,
                       float* out, cudaStream_t stream) {
  using S = AtShape<B, T>;
  if (n % B != 0 || ttot % T != 0 || slices < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(n / B, slices);
  ablate_walk_kernel<M, S><<<grid, S::kThreads, 0, stream>>>(
      o, d, n, tris, ttot, slices, slices == 1 ? out : part);
  nr_dense_fold_launch<2>(part, n, slices, nullptr, out, stream, M::kMiss);
  return static_cast<int>(cudaGetLastError());
}

template <int B, int T>
static int probe_launch(const float* o, const float* d, int n,
                        const float* tris, int ttot, float* out,
                        cudaStream_t stream) {
  if (n % B != 0 || ttot % T != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    ablate_probe_kernel<B, T><<<n / B, B, 0, stream>>>(o, d, n, tris, ttot,
                                                       out);
  }
  return static_cast<int>(cudaGetLastError());
}

// The walk shapes of ops/trace_ablation.py::TRACE_COMBOS (block, tile).
#define NR_WALK_SHAPES(X) \
  X(512, 128) X(256, 128) X(1024, 128) X(512, 256) X(512, 512) \
  X(256, 256) X(512, 1024) X(1024, 512)

// The launch shape the wrapper allocates for at (block, tile): the slices
// (walk_slices); the walk needs no scratch beyond the partial rows.
extern "C" int ablate_trace_shape(int block, int tile, int npad, int ttot,
                                  int* slices, long long* scratch_doubles) {
  *scratch_doubles = 0;
#define NR_SHAPE(B, T) \
  if (block == B && tile == T) return walk_slices(B, T, npad, ttot, slices);
  NR_WALK_SHAPES(NR_SHAPE)
#undef NR_SHAPE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Variant codes of ops/trace_ablation.py::VARIANT_CODES; the combinations
// of its TRACE_COMBOS. part: [slices][2][n] f32 scratch (unused with one
// slice; the probe takes neither).
extern "C" int ablate_trace(int variant, int block, int tile, const float* o,
                            const float* d, int n, const float* tris,
                            int ttot, int slices, float* part, float* out,
                            cudaStream_t stream) {
#define NR_WALK(V, M, B, T)                                              \
  if (variant == V && block == B && tile == T)                           \
    return walk_launch<M, B, T>(o, d, n, tris, ttot, slices, part, out, \
                                stream);
#define NR_PROBE(B, T)                                  \
  if (variant == 1 && block == B && tile == T)          \
    return probe_launch<B, T>(o, d, n, tris, ttot, out, stream);
  NR_WALK(0, DfMt, 512, 128)
  NR_PROBE(512, 128)
  NR_WALK(2, DfRecip, 512, 128)
  NR_WALK(3, DfRecipx, 512, 128)
  NR_WALK(4, DfNodiv, 512, 128)
  NR_WALK(5, DfBf16, 512, 128)
  NR_WALK(0, DfMt, 256, 128)     // b256
  NR_WALK(0, DfMt, 1024, 128)    // b1024
  NR_WALK(0, DfMt, 512, 256)     // t256
  NR_WALK(0, DfMt, 512, 512)     // t512
  NR_WALK(0, DfMt, 256, 256)     // b256t256
  NR_PROBE(512, 256)             // t256probe
  NR_WALK(4, DfNodiv, 512, 256)  // t256nodiv
  NR_WALK(0, DfMt, 512, 1024)    // t1024
  NR_WALK(0, DfMt, 1024, 512)    // b1024t512
  NR_PROBE(512, 512)             // t512probe
#undef NR_WALK
#undef NR_PROBE
  return static_cast<int>(cudaErrorInvalidValue);
}

NR_ERROR_STRING_ENTRY
