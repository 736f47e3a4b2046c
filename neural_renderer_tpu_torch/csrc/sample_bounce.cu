// K10: the Disney bounce sampler in one kernel, one thread a ray. It
// replaces no Pallas kernel: the JAX package's sampler
// (neural_renderer_tpu/render/pathtrace.py::sample_bounce_directions) is
// plain jnp that XLA fuses on the TPU. Its PyTorch twin
// (render/pathtrace.py::sample_bounce_twin, ops/brdf.py, ops/rng.py,
// ops/camera.py, ops/linalg.py) runs as several hundred eager elementwise
// launches over [3, N] rows: 46.7 ms a 4K view frame (5.6 ns a ray), 261
// ms an evaluate batch of 1080p x 8, and 41 of the GT frame's 78.6 ms in
// the stage were launch gaps (H100, traced benchmark runs). So it was
// added.
//
// Bound: bytes. Every ray reads its hit and active flags and writes
// origin, direction, pdf, BRDF weight and the new active flag (43 B); a
// live ray (hit and active) reads besides its pixel and sample ids (int64),
// position, normal, albedo and material parameters ([3, N] f32 rows) and,
// after the first bounce, its stored incoming direction (64 + 12 B;
// ops/bounds.py::sample_bounce_work). At the view's 4K first bounce, a
// third of the rays live, that is 0.53 GB, 0.16 ms at 3.35 TB/s; its
// arithmetic (about 550 FP32 operations a live ray: the wang-hash draws,
// one lobe's sample, the mixture pdf and one Disney evaluation) takes
// 0.05 ms at the FP32 instruction rate. Rays that miss or are inactive read
// only their two flags and write zeros.
//
// Numbers: the twin's expressions in the twin's order, one IEEE FP32
// operation at a time (-fmad=false, ops/cuda_build.py), with the rounding
// of PyTorch's CUDA operators where it differs from the expression's text:
// a sum over the three rows adds a trailing 0 (the reduction's identity,
// which turns -0 into +0); `scalar / tensor` is the reciprocal times the
// scalar (Tensor.__rtruediv__); `tensor / python scalar` multiplies by the
// scalar's f32 reciprocal (PyTorch's div_true with a CPU scalar); clamps
// pass NaN through. Constants are the f32 roundings of the twin's Python
// floats. Only cosf, sinf, tanf, logf and powf may round otherwise than
// PyTorch's own calls of them; the GTR lobes' pdfs magnify an ulp of n.h
// about a thousandfold near their peaks (ROADMAP: "Bounce-sampler PDFs
// near GTR peaks").
//
// The lobe is a branch: only the chosen lobe's direction is computed (the
// twin computes all three and selects), then the three-lobe mixture pdf
// and the full Disney evaluation, as the twin.
#include <stdint.h>

#include "mt.cuh"

// Operands (ops/sample_bounce.py::pack_operands): the camera basis, fov_y,
// scene_scale and the global material row (scene/materials.py P_*).
#define SB_FORWARD 0
#define SB_RIGHT 3
#define SB_UP 6
#define SB_FOV_Y 9
#define SB_SCENE_SCALE 10
#define SB_MATERIAL 11
#define SB_P_SPECULAR_TINT (SB_MATERIAL + 6)
#define SB_P_ANISOTROPY (SB_MATERIAL + 7)
#define SB_P_SHEEN (SB_MATERIAL + 8)
#define SB_P_SHEEN_TINT (SB_MATERIAL + 9)
#define SB_P_CLEARCOAT (SB_MATERIAL + 10)
#define SB_P_CLEARCOAT_GLOSS (SB_MATERIAL + 11)
#define SB_P_IOR (SB_MATERIAL + 16)
#define SB_P_SPEC_TRANS (SB_MATERIAL + 17)
#define SB_OPERANDS (SB_MATERIAL + 18)

#define SB_THREADS 256

// f32 roundings of ops/brdf.py's and the twin's Python constants.
#define SB_INV_PI 0x1.45f306p-2f
#define SB_TWO_PI 0x1.921fb6p+2f
#define SB_THIRD 0x1.555556p-2f   // 1.0f / 3.0f
#define SB_EPS 0x1.79ca10p-67f    // 1e-20
#define SB_MIN_ALPHA 0x1.0624dep-10f  // 0.001

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return v3(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return v3(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ V3 scale(V3 a, float s) {
  return v3(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ V3 splat(float s) { return v3(s, s, s); }

// ops/linalg.py::dot, (a * b).sum(dim=0): PyTorch's reduction adds the
// three products in order and then its identity.
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return ((a.x * b.x + a.y * b.y) + a.z * b.z) + 0.0f;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}
// torch.clamp keeps NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float saturate(float x) {
  return isnan(x) ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}
__device__ __forceinline__ float lerp(float a, float b, float t) {
  return a * (1.0f - t) + b * t;
}
// lerp(ones, b, t): ones * (1 - t) is 1 - t exactly.
__device__ __forceinline__ V3 lerp_one(V3 b, float t) {
  return add(splat(1.0f - t), scale(b, t));
}
__device__ __forceinline__ V3 normalize(V3 v) {
  float n = clamp_min(sqrtf(clamp_min(dot(v, v), 0.0f)), SB_EPS);
  return v3(v.x / n, v.y / n, v.z / n);
}
__device__ __forceinline__ V3 reflect(V3 wi, V3 n) {
  return sub(wi, scale(n, 2.0f * dot(wi, n)));
}
__device__ __forceinline__ float luminance(V3 c) {
  return (0x1.b367a0p-3f * c.x + 0x1.6e2eb2p-1f * c.y) +
         0x1.27bb30p-4f * c.z;
}

// ops/rng.py: the counter-based wang hash, wrapping uint32 arithmetic.
__device__ __forceinline__ uint32_t wang_hash(uint32_t x) {
  x = (x ^ 61u) ^ (x >> 16);
  x = x * 9u;
  x = x ^ (x >> 4);
  x = x * 0x27D4EB2Du;
  x = x ^ (x >> 15);
  return x;
}
__device__ __forceinline__ float rand01(uint32_t& state) {
  state = wang_hash(state);
  return (float)(state & 0x00FFFFFFu) * (1.0f / 16777216.0f);
}

struct Mat {
  V3 base;
  float metallic, roughness, specular, specular_tint, anisotropy, sheen,
      sheen_tint, clearcoat, clearcoat_gloss, ior, spec_trans;
};

__device__ __forceinline__ float schlick_weight(float c) {
  float m = saturate(1.0f - c);
  return (m * m) * (m * m) * m;
}

__device__ __forceinline__ float fresnel_dielectric(float ci, float eta_i,
                                                    float eta_t) {
  float g2 = ((eta_t * eta_t) / (eta_i * eta_i) - 1.0f) + ci * ci;
  float g = sqrtf(clamp_min(g2, 0.0f));
  float a = (g - ci) / (g + ci);
  float b = (ci * (g + ci) - 1.0f) / (ci * (g - ci) + 1.0f);
  float f = ((0.5f * a) * a) * (1.0f + b * b);
  return g2 < 0.0f ? 1.0f : f;
}

__device__ __forceinline__ float gtr_1(float c, float alpha) {
  float a2 = alpha * alpha;
  float dense = (SB_INV_PI * (a2 - 1.0f)) /
                (logf(a2) * (1.0f + ((a2 - 1.0f) * c) * c));
  return alpha >= 1.0f ? SB_INV_PI : dense;
}

__device__ __forceinline__ float gtr_2(float c, float alpha) {
  float a2 = alpha * alpha;
  float denom = 1.0f + ((a2 - 1.0f) * c) * c;
  return (SB_INV_PI * a2) / (denom * denom);
}

// INV_PI / t is t.reciprocal() * INV_PI.
__device__ __forceinline__ float gtr_2_aniso(float hn, float hx, float hy,
                                             float ax, float ay) {
  float qx = hx / ax, qy = hy / ay;
  float q = (qx * qx + qy * qy) + hn * hn;
  return (1.0f / ((ax * ay) * (q * q))) * SB_INV_PI;
}

__device__ __forceinline__ float smith_ggx(float ndo, float alpha) {
  float a = alpha * alpha;
  float b = ndo * ndo;
  return 1.0f / (ndo + sqrtf(clamp_min((a + b) - a * b, 0.0f)));
}

__device__ __forceinline__ float smith_ggx_aniso(float ndo, float odx,
                                                 float ody, float ax,
                                                 float ay) {
  float x = odx * ax, y = ody * ay;
  return 1.0f / (ndo + sqrtf((x * x + y * y) + ndo * ndo));
}

__device__ __forceinline__ V3 tint(V3 base) {
  float lum = luminance(base);
  float safe = lum > 0.0f ? lum : 1.0f;
  return lum > 0.0f ? v3(base.x / safe, base.y / safe, base.z / safe)
                    : splat(1.0f);
}

__device__ __forceinline__ V3 spec_color(const Mat& m) {
  V3 spec_base = lerp_one(tint(m.base), m.specular_tint);
  V3 spec = scale(spec_base, m.specular * 0x1.47ae14p-4f);  // * 0.08
  return add(scale(spec, 1.0f - m.metallic), scale(m.base, m.metallic));
}

__device__ __forceinline__ void aniso_alphas(const Mat& m, float* ax,
                                             float* ay) {
  float aspect = sqrtf(clamp_min(1.0f - m.anisotropy * 0x1.ccccccp-1f,
                                 0.0f));  // 0.9
  float a = m.roughness * m.roughness;
  *ax = clamp_min(a / aspect, SB_MIN_ALPHA);
  *ay = clamp_min(a * aspect, SB_MIN_ALPHA);
}

__device__ __forceinline__ float clearcoat_alpha(const Mat& m) {
  return lerp(0x1.99999ap-4f, SB_MIN_ALPHA, m.clearcoat_gloss);  // 0.1
}

// ops/brdf.py::disney_eval, on the half vector wh = normalize(wi + wo).
__device__ V3 disney_eval(const Mat& m, V3 n, V3 wo, V3 wi, V3 t, V3 b,
                          V3 wh) {
  float n_dot_o = dot(wo, n), n_dot_i = dot(wi, n);
  if (n_dot_o * n_dot_i > 0.0f) {
    // diffuse
    float i_dot_h = dot(wi, wh);
    float fd90 = 0.5f + ((2.0f * m.roughness) * i_dot_h) * i_dot_h;
    float fi = schlick_weight(fabsf(n_dot_i));
    float fo = schlick_weight(fabsf(n_dot_o));
    float w = (1.0f * (1.0f - fi) + fd90 * fi) *
              (1.0f * (1.0f - fo) + fd90 * fo);
    V3 diffuse = scale(m.base, SB_INV_PI * w);
    // sheen
    V3 sheen_color = lerp_one(tint(m.base), m.sheen_tint);
    V3 sheen = scale(sheen_color, schlick_weight(i_dot_h) * m.sheen);
    // clearcoat
    float d_cc = gtr_1(dot(n, wh), clearcoat_alpha(m));
    float f_cc = lerp(0x1.47ae14p-5f, 1.0f, schlick_weight(n_dot_i));  // 0.04
    float g_cc = smith_ggx(n_dot_i, 0.25f) * smith_ggx(n_dot_o, 0.25f);
    float coat = (((0.25f * m.clearcoat) * d_cc) * f_cc) * g_cc;
    // specular: isotropic or anisotropic
    V3 spec = spec_color(m);
    float sw = schlick_weight(i_dot_h);
    V3 f = add(scale(spec, 1.0f - sw), scale(splat(1.0f), sw));
    float dg;
    if (m.anisotropy == 0.0f) {
      float alpha = clamp_min(m.roughness * m.roughness, SB_MIN_ALPHA);
      float d = gtr_2(dot(n, wh), alpha);
      float g = smith_ggx(n_dot_i, alpha) * smith_ggx(n_dot_o, alpha);
      dg = d * g;
    } else {
      float ax, ay;
      aniso_alphas(m, &ax, &ay);
      float d = gtr_2_aniso(dot(n, wh), fabsf(dot(wh, t)),
                            fabsf(dot(wh, b)), ax, ay);
      float g = smith_ggx_aniso(n_dot_i, fabsf(dot(wi, t)),
                                fabsf(dot(wi, b)), ax, ay) *
                smith_ggx_aniso(n_dot_o, fabsf(dot(wo, t)),
                                fabsf(dot(wo, b)), ax, ay);
      dg = d * g;
    }
    V3 gloss = scale(f, dg);
    float k = (1.0f - m.metallic) * (1.0f - m.spec_trans);
    return add(add(scale(add(diffuse, sheen), k), gloss), splat(coat));
  }
  if (!(m.spec_trans > 0.0f)) return splat(0.0f);
  // disney_microfacet_transmission_isotropic
  bool degenerate = (n_dot_o == 0.0f) || (n_dot_i == 0.0f);
  bool entering = n_dot_o > 0.0f;
  float eta_o = entering ? 1.0f : m.ior;
  float eta_i = entering ? m.ior : 1.0f;
  V3 th = normalize(add(wo, scale(wi, eta_i / eta_o)));
  float alpha = clamp_min(m.roughness * m.roughness, SB_MIN_ALPHA);
  float d = gtr_2(fabsf(dot(n, th)), alpha);
  float f = fresnel_dielectric(fabsf(n_dot_i), eta_o, eta_i);
  float g = smith_ggx(fabsf(n_dot_i), alpha) * smith_ggx(fabsf(n_dot_o),
                                                         alpha);
  float i_dot_h = dot(wi, th), o_dot_h = dot(wo, th);
  float s = eta_o * o_dot_h + eta_i * i_dot_h;
  float c = (((fabsf(o_dot_h) / clamp_min(fabsf(n_dot_o), SB_EPS)) *
              fabsf(i_dot_h)) /
             clamp_min(fabsf(n_dot_i), SB_EPS)) *
            (eta_o * eta_o) / clamp_min(s * s, SB_EPS);
  V3 r = scale(m.base, ((c * (1.0f - f)) * g) * d);
  if (degenerate) r = splat(0.0f);
  return scale(r, (1.0f - m.metallic) * m.spec_trans);
}

// ops/brdf.py::disney_pdf_3component, on the same half vector.
__device__ float disney_pdf(const Mat& m, V3 n, V3 wo, V3 wi, V3 t, V3 b,
                            V3 wh) {
  if (!(dot(wo, n) * dot(wi, n) > 0.0f)) return 0.0f;
  float pdf_diffuse = clamp_min(dot(n, wi), 0.0f) * SB_INV_PI;
  float n_dot_h = dot(n, wh), h_dot_o = dot(wh, wo);
  float pdf_specular;
  if (m.anisotropy == 0.0f) {
    float alpha = clamp_min(m.roughness * m.roughness, SB_MIN_ALPHA);
    pdf_specular = (gtr_2(n_dot_h, alpha) * n_dot_h) / (4.0f * h_dot_o);
  } else {
    float ax, ay;
    aniso_alphas(m, &ax, &ay);
    float c = fabsf(n_dot_h);
    float d = gtr_2_aniso(c, fabsf(dot(wh, t)), fabsf(dot(wh, b)), ax, ay);
    pdf_specular = (d * c) / (4.0f * fabsf(h_dot_o));
  }
  float pdf_clearcoat = (gtr_1(n_dot_h, clearcoat_alpha(m)) * n_dot_h) /
                        (4.0f * h_dot_o);
  return ((pdf_diffuse + pdf_specular) + pdf_clearcoat) * SB_THIRD;
}

// _local_to_world on ops/brdf.py::_frame_from_n's frame of n.
__device__ __forceinline__ V3 from_n_frame(V3 n, float hx, float hy,
                                           float hz) {
  bool use_z = fabsf(n.z) < 0x1.ff7ceep-1f;  // 0.999
  V3 up = v3(use_z ? 0.0f : 1.0f, 0.0f, use_z ? 1.0f : 0.0f);
  V3 t = normalize(cross(up, n));
  V3 b = cross(n, t);
  return normalize(add(add(scale(t, hx), scale(b, hy)), scale(n, hz)));
}

// The chosen lobe's direction (disney_sample_3component's wi).
__device__ V3 sample_lobe(const Mat& m, int component, V3 n, V3 wo, V3 t,
                          V3 b, float u1, float u2) {
  float phi = SB_TWO_PI * u1;
  if (component == 0) {  // sample_cosine_hemisphere
    float cos_t = sqrtf(u2);
    float sin_t = sqrtf(clamp_min(1.0f - u2, 0.0f));
    return from_n_frame(n, sin_t * cosf(phi), sin_t * sinf(phi), cos_t);
  }
  V3 h;
  if (component == 1 && m.anisotropy == 0.0f) {  // sample_ggx
    float alpha = clamp_min(m.roughness * m.roughness, SB_MIN_ALPHA);
    float cos_t = sqrtf(clamp_min(
        (1.0f - u2) / (1.0f + (alpha * alpha - 1.0f) * u2), 0.0f));
    float sin_t = 1.0f - cos_t * cos_t;
    h = from_n_frame(n, sin_t * cosf(phi), sin_t * sinf(phi), cos_t);
  } else if (component == 1) {  // sample_gtr_2_aniso_h
    float ax, ay;
    aniso_alphas(m, &ax, &ay);
    float s = sqrtf(clamp_min(
        u2 / clamp_min(1.0f - u2, 0x1.197998p-40f), 0.0f));  // 1e-12
    h = normalize(add(add(scale(t, (ax * cosf(phi)) * s),
                          scale(b, (ay * sinf(phi)) * s)),
                      n));
  } else {  // sample_gtr_1_h
    float alpha = clearcoat_alpha(m);
    float a2 = alpha * alpha;
    float cos2 = (1.0f - powf(a2, 1.0f - u2)) / (1.0f - a2);
    float cos_t = sqrtf(clamp_min(cos2, 0.0f));
    float sin_t = 1.0f - cos2;
    h = normalize(add(add(scale(t, sin_t * cosf(phi)),
                          scale(b, sin_t * sinf(phi))),
                      scale(n, cos_t)));
  }
  return reflect(neg(wo), h);
}

__device__ __forceinline__ V3 load3(const float* __restrict__ p, long long i,
                                    long long n) {
  return v3(p[i], p[n + i], p[2 * n + i]);
}
__device__ __forceinline__ void store3(float* __restrict__ p, long long i,
                                       long long n, V3 v) {
  p[i] = v.x;
  p[n + i] = v.y;
  p[2 * n + i] = v.z;
}

__global__ void __launch_bounds__(SB_THREADS)
nr_sample_bounce_kernel(long long n, const long long* __restrict__ pixel,
                        const long long* __restrict__ sample,
                        const float* __restrict__ position,
                        const float* __restrict__ normal,
                        const float* __restrict__ albedo,
                        const float* __restrict__ mparams,
                        const uint8_t* __restrict__ hit,
                        const uint8_t* __restrict__ active,
                        const float* __restrict__ incoming,
                        const float* __restrict__ ops, int width, int height,
                        uint32_t sample_offset, float* __restrict__ origin,
                        float* __restrict__ direction,
                        float* __restrict__ pdf_out,
                        float* __restrict__ weight,
                        uint8_t* __restrict__ active_out) {
  const long long i = (long long)blockIdx.x * SB_THREADS + threadIdx.x;
  if (i >= n) return;
  V3 o = splat(0.0f), wi = splat(0.0f), bw = splat(0.0f);
  float pdf = 0.0f;
  bool valid = false;
  if (hit[i] && active[i]) {
    const long long p = pixel[i];
    uint32_t state = wang_hash(
        (uint32_t)p * 9781u +
        (sample_offset + (uint32_t)sample[i] + 1u) * 6271u);
    V3 inc;
    if (incoming == nullptr) {
      // ops/camera.py::generate_primary_rays: the primary ray again, from
      // the stream's first two draws.
      float jx = rand01(state);
      float jy = rand01(state);
      float aspect = (float)((double)width / (double)height);
      float u = ((float)(p % width) + jx) / (float)width;
      float v = 1.0f - ((float)(p / width) + jy) / (float)height;
      u = u * 2.0f - 1.0f;
      v = v * 2.0f - 1.0f;
      float tan_half = tanf(__ldg(ops + SB_FOV_Y) * 0.5f);
      float su = (u * aspect) * tan_half, sv = v * tan_half;
      V3 fwd = v3(__ldg(ops + SB_FORWARD), __ldg(ops + SB_FORWARD + 1),
                  __ldg(ops + SB_FORWARD + 2));
      V3 right = v3(__ldg(ops + SB_RIGHT), __ldg(ops + SB_RIGHT + 1),
                    __ldg(ops + SB_RIGHT + 2));
      V3 up = v3(__ldg(ops + SB_UP), __ldg(ops + SB_UP + 1),
                 __ldg(ops + SB_UP + 2));
      V3 d = add(add(fwd, scale(right, su)), scale(up, sv));
      float len = sqrtf(dot(d, d));
      inc = v3(d.x / len, d.y / len, d.z / len);
    } else {
      inc = load3(incoming, i, n);
    }
    // linalg.safe_normalize(normal, min_len=0) and the face flip.
    V3 nr = load3(normal, i, n);
    float nl = sqrtf(clamp_min(dot(nr, nr), 0.0f));
    float nd = clamp_min(nl, SB_EPS);
    nr = nl > 0.0f ? v3(nr.x / nd, nr.y / nd, nr.z / nd) : v3(0.0f, 1.0f,
                                                               0.0f);
    if (dot(nr, inc) > 0.0f) nr = neg(nr);
    const V3 wo = neg(inc);
    // brdf.build_tangent_space
    bool use_x = (nr.x < 0x1.333334p-1f) && (nr.x > -0x1.333334p-1f);
    bool use_y = !use_x && (nr.y < 0x1.333334p-1f) &&
                 (nr.y > -0x1.333334p-1f);
    bool use_z = !use_x && !use_y;
    V3 basis = v3(use_x ? 1.0f : 0.0f, use_y ? 1.0f : 0.0f,
                  use_z ? 1.0f : 0.0f);
    const V3 t = normalize(cross(basis, nr));
    const V3 b = normalize(cross(nr, t));

    Mat m;
    m.base = load3(albedo, i, n);
    m.metallic = mparams[i];
    m.roughness = mparams[n + i];
    m.specular = mparams[2 * n + i];
    m.specular_tint = __ldg(ops + SB_P_SPECULAR_TINT);
    m.anisotropy = __ldg(ops + SB_P_ANISOTROPY);
    m.sheen = __ldg(ops + SB_P_SHEEN);
    m.sheen_tint = __ldg(ops + SB_P_SHEEN_TINT);
    m.clearcoat = __ldg(ops + SB_P_CLEARCOAT);
    m.clearcoat_gloss = __ldg(ops + SB_P_CLEARCOAT_GLOSS);
    m.ior = __ldg(ops + SB_P_IOR);
    m.spec_trans = __ldg(ops + SB_P_SPEC_TRANS);

    const float u1 = rand01(state);
    const float u2 = rand01(state);
    const float u3 = rand01(state);
    const int component = min((int)(u3 * 3.0f), 2);
    wi = sample_lobe(m, component, nr, wo, t, b, u1, u2);
    const V3 wh = normalize(add(wi, wo));
    bool lobe_ok = (component == 0) || (dot(wo, nr) * dot(wi, nr) > 0.0f);
    lobe_ok = lobe_ok && (m.spec_trans < 1.0f);
    pdf = lobe_ok ? disney_pdf(m, nr, wo, wi, t, b, wh) : 0.0f;
    if (pdf > 0.0f) {
      V3 f = disney_eval(m, nr, wo, wi, t, b, wh);
      bw = scale(f, fabsf(dot(nr, wi)) / pdf);
      valid = isfinite(bw.x) && isfinite(bw.y) && isfinite(bw.z);
    }
    if (valid) {
      o = add(load3(position, i, n),
              scale(nr, __ldg(ops + SB_SCENE_SCALE) * 0x1.0c6f7ap-20f));
    } else {
      wi = bw = splat(0.0f);
      pdf = 0.0f;
    }
  }
  store3(origin, i, n, o);
  store3(direction, i, n, wi);
  pdf_out[i] = pdf;
  store3(weight, i, n, bw);
  active_out[i] = valid ? 1 : 0;
}

// n rays; [3, n] f32 rows (incoming nullptr on the first bounce); hit and
// active as bytes; ops [SB_OPERANDS] f32 on the device.
extern "C" int nr_sample_bounce(long long n, const long long* pixel,
                                const long long* sample,
                                const float* position, const float* normal,
                                const float* albedo, const float* mparams,
                                const uint8_t* hit, const uint8_t* active,
                                const float* incoming, const float* ops,
                                int width, int height,
                                unsigned int sample_offset, float* origin,
                                float* direction, float* pdf, float* weight,
                                uint8_t* active_out, cudaStream_t stream) {
  if (n < 0 || width <= 0 || height <= 0) return cudaErrorInvalidValue;
  if (n > 0) {
    const long long blocks = (n + SB_THREADS - 1) / SB_THREADS;
    nr_sample_bounce_kernel<<<(unsigned int)blocks, SB_THREADS, 0, stream>>>(
        n, pixel, sample, position, normal, albedo, mparams, hit, active,
        incoming, ops, width, height, sample_offset, origin, direction, pdf,
        weight, active_out);
  }
  return static_cast<int>(cudaGetLastError());
}

NR_ERROR_STRING_ENTRY
