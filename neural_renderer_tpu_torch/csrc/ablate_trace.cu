// The trace-kernel ablation's dense closest hit (replaces the TPU kernel
// scripts/ablate_trace_kernel.py::trace_variant, body make_kernel :110,
// tile math _mt_tile :47 and _probe_tile :100).
//
// K3's first skeleton as a template over the tile math
// (csrc/mt_variants.cuh), the rays per block and the triangles per staged
// tile: one thread per ray, tiles staged in shared memory (9 x TILE floats,
// 36,864 B at 1024), (best_t, best_tri) in registers, a strict `<` over
// increasing ids, which keeps the smallest id at the minimum t as the
// reference's lane reduction (:134-137) does. ANY mode, no skip mask. The
// probe keeps only its chains' minimum (id 0). One library holds every
// combination the reference's dispatch names (:397-418); the C entry
// refuses any other.
//
// Bound (ops/bounds.py): the variant's operations per (ray, triangle) pair
// (46, nodiv 47, the probe 50) at the card's rate of unfused FP32
// instructions (-fmad=false: one instruction per operation), bf16 at two
// per lane per clock.
#include "mt_variants.cuh"

template <class M, int BLOCK, int TILE>
__global__ void __launch_bounds__(BLOCK)
ablate_trace_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    int n, const float* __restrict__ tris, int ttot,
                    float* __restrict__ out) {
  static_assert(TILE % NR_PROBE_CHAINS == 0, "tile of whole probe groups");
  __shared__ float tile[9][TILE];
  const long long r = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const NrRay ray{o[r], o[n + r], o[2LL * n + r],
                  d[r], d[n + r], d[2LL * n + r]};
  const typename M::RayState rs = M::ray(ray);
  float best_t = M::kMiss;
  int best_tri = 0;
  for (int base = 0; base < ttot; base += TILE) {
    __syncthreads();  // previous tile fully consumed
    nr_stage_tile<TILE>(tile, tris, ttot, base);
    __syncthreads();
    if constexpr (M::kProbe) {
      for (int q = 0; q < TILE; q += NR_PROBE_CHAINS)
        best_t = M::template chains<TILE>(rs, tile, q, best_t);
    } else {
#pragma unroll 2
      for (int q = 0; q < TILE; q += 2) {
        float t[2], det[2];
        M::template pair2<TILE>(rs, tile, q, t, det);
        if (t[0] < best_t) {
          best_t = t[0];
          best_tri = base + q;
        }
        if (t[1] < best_t) {
          best_t = t[1];
          best_tri = base + q + 1;
        }
      }
    }
  }
  out[r] = best_t;
  out[n + r] = __int_as_float(best_tri);
}

template <class M, int BLOCK, int TILE>
static int launch(const float* o, const float* d, int n, const float* tris,
                  int ttot, float* out, cudaStream_t stream) {
  if (n % BLOCK != 0 || ttot % TILE != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    ablate_trace_kernel<M, BLOCK, TILE><<<n / BLOCK, BLOCK, 0, stream>>>(
        o, d, n, tris, ttot, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// Variant codes of ops/trace_ablation.py::VARIANT_CODES; the combinations
// of its TRACE_COMBOS.
extern "C" int ablate_trace(int variant, int block, int tile, const float* o,
                            const float* d, int n, const float* tris,
                            int ttot, float* out, cudaStream_t stream) {
#define NR_COMBO(V, M, B, T) \
  if (variant == V && block == B && tile == T) \
    return launch<M, B, T>(o, d, n, tris, ttot, out, stream);
  NR_COMBO(0, MtLocal, 512, 128)
  NR_COMBO(1, MtProbe, 512, 128)
  NR_COMBO(2, MtRecip, 512, 128)
  NR_COMBO(3, MtRecipx, 512, 128)
  NR_COMBO(4, MtNodiv, 512, 128)
  NR_COMBO(5, MtBf16, 512, 128)
  NR_COMBO(0, MtLocal, 256, 128)     // b256
  NR_COMBO(0, MtLocal, 1024, 128)    // b1024
  NR_COMBO(0, MtLocal, 512, 256)     // t256
  NR_COMBO(0, MtLocal, 512, 512)     // t512
  NR_COMBO(0, MtLocal, 256, 256)     // b256t256
  NR_COMBO(1, MtProbe, 512, 256)     // t256probe
  NR_COMBO(4, MtNodiv, 512, 256)     // t256nodiv
  NR_COMBO(0, MtLocal, 512, 1024)    // t1024
  NR_COMBO(0, MtLocal, 1024, 512)    // b1024t512
  NR_COMBO(1, MtProbe, 512, 512)     // t512probe
#undef NR_COMBO
  return static_cast<int>(cudaErrorInvalidValue);
}

NR_ERROR_STRING_ENTRY
