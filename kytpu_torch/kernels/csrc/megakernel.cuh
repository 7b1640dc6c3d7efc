// What the megakernels of both families share: K1, K2, K4
// (wavefront_fwd.cu) and the big-scene K5, K6 (bigscene_fwd.cu). The
// float32 constants of the JAX package, vector maths with NaN-propagating
// min/max, the integer hashes and the lane RNG of the three samplers (the
// "sobol" site words in a __constant__ table, one copy per source), the
// scene header and light tables of kernels/wavefront.py::pack_tables
// (`Scene`), the sphere occlusion root test, shading frames, the BSDFs,
// the light sampling and the texture lookups at a hit (the bilinear fetch
// itself is texture.cuh's). Each is a transcription of a function of
// kytpu_torch/kernels/wavefront.py's plain version, whose arithmetic the
// kernels keep to the last bit (they are built with --fmad=false and
// without fast math).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "texture.cuh"
#include "wavefront_tables.cuh"

// Everything here has internal linkage: each source that includes the
// header gets its own copy, its own site table included.
namespace {

using namespace kytpu;

// float32 values of the package's constants
constexpr float EPS = 1e-3f;          // SHAPE_EPSILON
constexpr float OFF = 1e-2f;          // RAY_OFFSET
constexpr float OFF2 = 1e-4f;         // float32(RAY_OFFSET**2)
constexpr float SHADOW_EPS = 2e-3f;   // SHADOW_EPSILON
constexpr float TWO_PI_F = 6.2831855f;
constexpr float INV_PI_F = 0.31830987f;
constexpr float INV_2PI_F = 0.15915494f;
constexpr float PI_OVER_2_F = 1.5707964f;
constexpr float PI_OVER_4_F = 0.7853982f;
constexpr float ENV_PDF = 0.05066059f;  // float32(1 / (2 pi^2))
constexpr float TINY_SIN2 = 0.00068523f;

struct V {
  float x, y, z;
};

__device__ __forceinline__ V vmk(float x, float y, float z) { return V{x, y, z}; }
__device__ __forceinline__ V operator+(V a, V b) { return V{a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V operator-(V a, V b) { return V{a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V operator-(V a) { return V{-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V operator*(V a, float s) { return V{a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V operator*(V a, V b) { return V{a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ float vdot(V a, V b) { return (a.x * b.x + a.y * b.y) + a.z * b.z; }
__device__ __forceinline__ V vcross(V a, V b) {
  return V{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ bool is_black(V a) { return a.x <= 0.f && a.y <= 0.f && a.z <= 0.f; }
__device__ __forceinline__ V ld3(const float* p) { return V{__ldg(p), __ldg(p + 1), __ldg(p + 2)}; }
// acc[col .. col + 2] += v (the replay backwards' per-thread accumulators)
__device__ __forceinline__ void add3(float* acc, int col, V v) {
  acc[col] = acc[col] + v.x;
  acc[col + 1] = acc[col + 1] + v.y;
  acc[col + 2] = acc[col + 2] + v.z;
}

// NaN-propagating min / max (fminf/fmaxf drop NaN)
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a || b != b) ? (a + b) : fmaxf(a, b);
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a || b != b) ? (a + b) : fminf(a, b);
}
__device__ __forceinline__ float vmax(V a) { return jmax(a.x, jmax(a.y, a.z)); }
__device__ __forceinline__ float safe_sqrt(float x) { return sqrtf(jmax(x, 0.f)); }
__device__ __forceinline__ float safe_div(float a, float b, float fb = 0.f) {
  return b != 0.f ? a / b : fb;
}
__device__ __forceinline__ float rsqrt_(float x) { return 1.0f / sqrtf(x); }

// c . v with the JAX package's trace-time folding of exact-zero constant
// factors (kernels/v3.py _cmul / V3.dot): zero terms are left out of the sum
__device__ __forceinline__ float cdot(V c, V v) {
  float r = 0.f;
  bool any = false;
  if (c.x != 0.f) { r = c.x * v.x; any = true; }
  if (c.y != 0.f) { float t = c.y * v.y; r = any ? r + t : t; any = true; }
  if (c.z != 0.f) { float t = c.z * v.z; r = any ? r + t : t; any = true; }
  return r;
}

// ---- integer hashes (uint32: wrapping multiplies, logical shifts) ----------

__device__ __forceinline__ float bits_to_unit(uint32_t x) {
  return (float)(x >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ uint32_t pix_hash(uint32_t pid, uint32_t seed) {
  uint32_t x = pid ^ (seed * 0x9E3779B9u);
  x ^= x >> 16;
  x *= 0x21F0AAADu;
  x ^= x >> 15;
  x *= 0x735A2D97u;
  return x ^ (x >> 15);
}

__device__ __forceinline__ uint32_t lowbias(uint32_t x) {
  x ^= x >> 17;
  x *= (uint32_t)(-315667899);
  x ^= x >> 11;
  x *= (uint32_t)(-1404298415);
  x ^= x >> 15;
  x *= 830770091u;
  return x ^ (x >> 14);
}

// ---- the "sobol" sampler's word maps (wavefront.py _Rng, sobol branch) ----

// Laine-Karras permutation (an Owen scramble of the reversed-bit tree)
__device__ __forceinline__ uint32_t lk_hash(uint32_t x, uint32_t seed) {
  x += seed;
  x ^= x * 0x6C50B47Cu;
  x ^= x * 0xB82F1E52u;
  x ^= x * 0xC7AFE638u;
  x ^= x * 0x8D22F6E6u;
  return x;
}

// the GF(2) superset transform; bit-reversed, a (0,2) partner of the
// radical inverse
__device__ __forceinline__ uint32_t superset_xor(uint32_t x) {
  x ^= (x >> 1) & 0x55555555u;
  x ^= (x >> 2) & 0x33333333u;
  x ^= (x >> 4) & 0x0F0F0F0Fu;
  x ^= (x >> 8) & 0x00FF00FFu;
  return x ^ ((x >> 16) & 0x0000FFFFu);
}

// splitmix64 words of each draw site (wavefront.py _site_seeds), filled by
// the host: the draw counter is the same on every lane at a given draw, so
// the lanes of a warp read one entry (a few where K1 and K2 refill a warp
// with lanes at other bounces). A bounce draws at most 4 sites (lobe pick,
// NEE, extension, roulette), so max_depth <= MAX_SOBOL_DEPTH.
constexpr int MAX_SOBOL_DEPTH = 64;  // MAX_SOBOL_DEPTH in wavefront.py
constexpr int MAX_SITES = 4 * MAX_SOBOL_DEPTH + 1;
__constant__ uint32_t c_sites[MAX_SITES][3];

enum Sampler { S_RANDOM = 0, S_HASH = 1, S_SOBOL = 2 };

// _Rng(hw=False): "random" keys by tile seed + lane position in the tile,
// "hash" by a per-lane key (mix = 0); "sobol" holds the reversed sample
// index in key and the pixel hash in mix
struct Rng {
  uint32_t key, mix, ctr;
  bool sobol;
  __device__ __forceinline__ float uniform() {
    ctr += 1;
    if (sobol) {
      const uint32_t i = __brev(lk_hash(key, mix ^ c_sites[ctr][0]));
      return bits_to_unit(__brev(lk_hash(i, mix ^ c_sites[ctr][1])));
    }
    return bits_to_unit(lowbias(key + mix + ctr * 668265263u));
  }
  // one 2D point: a (0,2) pair of one site under sobol, else two draws
  __device__ __forceinline__ void uniform2(float& u1, float& u2) {
    if (!sobol) {
      u1 = uniform();
      u2 = uniform();
      return;
    }
    ctr += 1;
    const uint32_t i = __brev(lk_hash(key, mix ^ c_sites[ctr][0]));
    u1 = bits_to_unit(__brev(lk_hash(i, mix ^ c_sites[ctr][1])));
    u2 = bits_to_unit(__brev(lk_hash(superset_xor(i), mix ^ c_sites[ctr][2])));
  }
};

// ---- scene tables ----------------------------------------------------------

// The tables of pack_tables. SH: they were staged in the block's shared
// memory (K1, K2 and K4 on a scene whose tables fit the budget), so they are
// read with plain loads; else they stay in device memory and are read
// through __ldg. Code that may meet either reads them through ldf/ldi/ld3f.
template <bool SH>
struct SceneT {
  const float* F;
  const int* I;
  int n_pl, n_sp, M, L, lobes, has_plastic, has_glass, has_delta, static_exp,
      env_i, any_azim, use_phits, single, texp, n_trec, n_tex, has_img;
  const float *PLF, *SPF, *MATF, *LTF, *TXF;
  const int *PLI, *SPI, *MATI, *LTI, *TXI;
  __device__ __forceinline__ float ldf(const float* p) const { return SH ? *p : __ldg(p); }
  __device__ __forceinline__ int ldi(const int* p) const { return SH ? *p : __ldg(p); }
  __device__ __forceinline__ V ld3f(const float* p) const {
    return V{ldf(p), ldf(p + 1), ldf(p + 2)};
  }
  __device__ void init(const float* f, const int* i) {
    F = f;
    I = i;
    n_pl = ldi(i + 0); n_sp = ldi(i + 1); M = ldi(i + 2); L = ldi(i + 3);
    lobes = ldi(i + 4); has_plastic = ldi(i + 5); has_glass = ldi(i + 6);
    has_delta = ldi(i + 7); static_exp = ldi(i + 8); env_i = ldi(i + 9);
    any_azim = ldi(i + 10); use_phits = ldi(i + 11); single = ldi(i + 12);
    texp = ldi(i + H_TEXP);
    n_trec = ldi(i + H_TREC);
    n_tex = ldi(i + H_TEX);
    has_img = ldi(i + H_IMG);
    PLI = i + HDR_I;
    SPI = PLI + PL_I * n_pl;
    MATI = SPI + SP_I * n_sp;
    LTI = MATI + MAT_I * M;
    TXI = LTI + LT_I * L;
    PLF = f + HDR_F;
    SPF = PLF + PL_F * n_pl;
    MATF = SPF + SP_F * n_sp;
    LTF = MATF + MAT_F * M;
    TXF = LTF + LT_F * L;
  }
  __device__ __forceinline__ bool has_lobe(int k) const { return (lobes >> k) & 1; }
};
using Scene = SceneT<false>;

// root of a sphere crossing in (eps, tmax), square-root free
__device__ __forceinline__ bool sphere_occludes(float neg_b, float discr, float tmax) {
  float a_c = neg_b - EPS, b_c = neg_b - tmax;
  float a2 = a_c * a_c, b2 = b_c * b_c;
  bool a_pos = a_c > 0.f, b_neg = b_c < 0.f;
  bool in1 = a_pos && (discr < a2) && (b_neg || (discr > b2));
  bool in2 = (a_pos || (discr > a2)) && b_neg && (discr < b2);
  return discr >= 0.f && (in1 || in2);
}

__device__ __forceinline__ V offset_origin(V p, V n, V d) {
  return p + n * (vdot(n, d) < 0.f ? -OFF : OFF);
}

__device__ __forceinline__ void make_frame(V n, V& s, V& t) {
  bool use_y = fabsf(n.x) > 0.99f;
  t = use_y ? vmk(-n.z, 0.f, n.x) : vmk(0.f, n.z, -n.y);
  t = t * rsqrt_(jmax(vdot(t, t), 1e-20f));
  s = vcross(t, n);
  s = s * rsqrt_(jmax(vdot(s, s), 1e-20f));
}
__device__ __forceinline__ V to_local(V s, V t, V n, V w) {
  return vmk(vdot(w, s), vdot(w, t), vdot(w, n));
}
__device__ __forceinline__ V to_world(V s, V t, V n, V w) {
  return (s * w.x + t * w.y) + n * w.z;
}

// ---- textures (wavefront.py _uv, _checker_even, _image_xy) -------------------

// (u, v) of hit hp on texture record rec's planar row: the baked anchor and
// dual basis, folding zero constants as kytpu's V3.dot does
template <class SC>
__device__ __forceinline__ void tex_uv(const SC& S, int rec, V hp, float& u, float& v) {
  const float* tf = S.TXF + TX_F * rec;
  const V rel = hp - S.ld3f(tf);
  u = cdot(S.ld3f(tf + 3), rel);
  v = cdot(S.ld3f(tf + 6), rel);
  if (S.ldf(tf + 9) != 0.f) {  // a disk's frame coordinates
    u = u + 0.5f;
    v = v + 0.5f;
  }
}

// the checker's "even"-cell mask at hp
template <class SC>
__device__ __forceinline__ bool checker_even(const SC& S, int rec, V hp) {
  float u, v;
  tex_uv(S, rec, hp, u, v);
  const float* tf = S.TXF + TX_F * rec;
  const int pu = (int)floorf(u * S.ldf(tf + 10)), pv = (int)floorf(v * S.ldf(tf + 11));
  return ((pu + pv) & 1) == 0;
}

// continuous texel coordinates of hp on an image row, in [-0.5, dim - 0.5)
template <class SC>
__device__ __forceinline__ void image_xy(const SC& S, int rec, V hp, float& x, float& y) {
  float u, v;
  tex_uv(S, rec, hp, u, v);
  const float* tf = S.TXF + TX_F * rec;
  const int* ti = S.TXI + TX_I * rec;
  const float su = u * S.ldf(tf + 10), sv = v * S.ldf(tf + 11);
  x = (su - floorf(su)) * (float)S.ldi(ti + 3) - 0.5f;
  y = (sv - floorf(sv)) * (float)S.ldi(ti + 4) - 0.5f;
}

// the taps and colour of image record rec at texel coordinates (x, y)
template <class SC>
__device__ __forceinline__ V image_lookup(const SC& S, int rec, float x, float y,
                                          const float* timg, Taps& taps) {
  const int* ti = S.TXI + TX_I * rec;
  taps = image_taps(S.ldi(ti + 2), S.ldi(ti + 3), S.ldi(ti + 4), x, y);
  float c[3];
  image_color(taps, S.ldi(ti + 5) != 0, timg, c);
  return vmk(c[0], c[1], c[2]);
}

// ---- BSDFs -----------------------------------------------------------------

__device__ float fresnel_dielectric(float ci, float eta) {
  ci = jmin(jmax(ci, -1.0f), 1.0f);
  bool entering = ci > 0.f;
  float ei = entering ? 1.0f : eta;
  float et = entering ? eta : 1.0f;
  float c = fabsf(ci);
  float si = safe_sqrt(1.0f - c * c);
  float st = ei / et * si;
  bool tir = st >= 1.0f;
  float m = jmin(st, 1.0f);
  float ct = safe_sqrt(1.0f - m * m);
  float r_par = safe_div(et * c - ei * ct, et * c + ei * ct);
  float r_per = safe_div(ei * c - et * ct, ei * c + et * ct);
  float fr = 0.5f * (r_par * r_par + r_per * r_per);
  return tir ? 1.0f : fr;
}

__device__ __forceinline__ float sin_from_phi_cos(float cos_phi, float u) {
  float s = safe_sqrt(1.0f - cos_phi * cos_phi);
  return u <= 0.5f ? s : -s;
}

__device__ void concentric_disk(float u1, float u2, float& px, float& py) {
  float x = 2.0f * u1 - 1.0f;
  float y = 2.0f * u2 - 1.0f;
  bool xd = fabsf(x) > fabsf(y);
  float r = xd ? x : y;
  float ratio = xd ? safe_div(y, x) : safe_div(x, y);
  float theta = xd ? PI_OVER_4_F * ratio : PI_OVER_2_F - PI_OVER_4_F * ratio;
  bool deg = x == 0.f && y == 0.f;
  float ct = cosf(theta);
  float st = safe_sqrt(1.0f - ct * ct);
  st = theta >= 0.f ? st : -st;
  px = deg ? 0.f : r * ct;
  py = deg ? 0.f : r * st;
}

__device__ __forceinline__ float ipow(float x, int n) {
  float r = 0.f;
  bool have = false;
  while (n) {
    if (n & 1) { r = have ? r * x : x; have = true; }
    n >>= 1;
    if (n) x = x * x;
  }
  return r;
}

// (cos^e, (e+2)/2pi, (e+1)/2pi)
template <class SC>
__device__ __forceinline__ void phong_pow(const SC& S, float cos_a, float exponent,
                                          float& powa, float& e2, float& e1) {
  if (S.static_exp) {
    powa = ipow(cos_a, S.static_exp);
    e2 = S.ldf(S.F + 2);
    e1 = S.ldf(S.F + 3);
  } else {
    powa = powf(cos_a, exponent);
    e2 = (exponent + 2.0f) * INV_2PI_F;
    e1 = (exponent + 1.0f) * INV_2PI_F;
  }
}

// d log f_phong / d e at a fixed direction (wavefront.py _kappa_dot): the
// exponent adjoint's one definition, for K2's "Bk"/"tuk" planes and K4
__device__ __forceinline__ float kappa_dot(float exponent, float cos_alpha) {
  return safe_div(1.0f, exponent + 2.0f) + logf(jmax(cos_alpha, 1e-12f));
}

// Lambert / Phong eval on frame-invariant dots -> (pdf, f_unit)
template <class SC>
__device__ void eval_dots(const SC& S, int kind, float exponent, float wo_z, float wi_z,
                          float cos_alpha, float& pdf, float& f_unit) {
  bool same = wo_z * wi_z > 0.f;
  pdf = 0.f;
  f_unit = 0.f;
  if (kind == LAMBERT) {
    f_unit = same ? INV_PI_F : 0.f;
    pdf = same ? fabsf(wi_z) * INV_PI_F : 0.f;
  } else if (kind == PHONG) {
    float powa, e2, e1;
    phong_pow(S, jmax(cos_alpha, 0.f), exponent, powa, e2, e1);
    f_unit = same ? e2 * powa : 0.f;
    pdf = e1 * powa;
  }
}

// local-frame sample of the lane's lobe -> f, wi, pdf, delta, the lobe's
// value per unit colour (f_unit) and whether glass refracted
template <class SC>
__device__ void bsdf_sample(const SC& S, int kind, V color, V color2, float eta,
                            float exponent, V wo, float u1, float u2, V& f, V& wi,
                            float& pdf, bool& delta, float& f_unit, bool& refract) {
  V mirror_wi = vmk(-wo.x, -wo.y, wo.z);
  delta = false;
  refract = false;
  if (kind == LAMBERT) {
    float px, py;
    concentric_disk(u1, u2, px, py);
    float lz = safe_sqrt((1.0f - px * px) - py * py);
    wi = vmk(px, py, wo.z < 0.f ? -lz : lz);
    bool same = wo.z * wi.z > 0.f;
    f = same ? color * INV_PI_F : vmk(0.f, 0.f, 0.f);
    pdf = same ? fabsf(wi.z) * INV_PI_F : 0.f;
    f_unit = same ? INV_PI_F : 0.f;
  } else if (kind == MIRROR) {
    float inv_m = 1.0f / jmax(fabsf(mirror_wi.z), 1e-12f);
    wi = mirror_wi;
    f = color * inv_m;
    pdf = 1.0f;
    delta = true;
    f_unit = inv_m;
  } else if (kind == GLASS) {
    float fr = fresnel_dielectric(wo.z, eta);
    bool take_refl = u1 < fr;
    bool into = wo.z > 0.f;
    float nz = into ? 1.0f : -1.0f;
    float eta_ratio = into ? 1.0f / eta : eta;
    float cos_i = (0.0f * wo.x + 0.0f * wo.y) + nz * wo.z;
    float sin2_i = jmax(1.0f - cos_i * cos_i, 0.f);
    float sin2_t = eta_ratio * eta_ratio * sin2_i;
    bool refr_ok = sin2_t < 1.0f;
    float cos_t = safe_sqrt(1.0f - jmin(sin2_t, 1.0f));
    float k = eta_ratio * cos_i - cos_t;
    V wt = vmk((-wo.x) * eta_ratio + 0.0f * k, (-wo.y) * eta_ratio + 0.0f * k,
               (-wo.z) * eta_ratio + nz * k);
    wi = take_refl ? mirror_wi : wt;
    float abs_cos_g = jmax(fabsf(wi.z), 1e-12f);
    float refl_unit = fr / abs_cos_g;
    float refr_unit = (1.0f - fr) / abs_cos_g;
    f = take_refl ? color * refl_unit : (refr_ok ? color2 * refr_unit : vmk(0.f, 0.f, 0.f));
    pdf = take_refl ? fr : (refr_ok ? 1.0f - fr : 0.f);
    delta = true;
    f_unit = take_refl ? refl_unit : (refr_ok ? refr_unit : 0.f);
    refract = !take_refl;
  } else {  // PHONG
    float phi = TWO_PI_F * u1;
    float cos_t_p = S.static_exp ? powf(u2, S.ldf(S.F + 1))
                                 : powf(u2, 1.0f / (exponent + 1.0f));
    float sin_t_p = safe_sqrt(1.0f - cos_t_p * cos_t_p);
    float cphi = cosf(phi);
    V lobe = vmk(cphi * sin_t_p, sin_from_phi_cos(cphi, u1) * sin_t_p, cos_t_p);
    V s_f, t_f;
    make_frame(mirror_wi, s_f, t_f);
    wi = to_world(s_f, t_f, mirror_wi, lobe);
    wi.z = wo.z < 0.f ? -wi.z : wi.z;
    float cos_alpha = jmax(vdot(mirror_wi, wi), 0.f);
    bool same = wo.z * wi.z > 0.f;
    float powa, e2, e1;
    phong_pow(S, cos_alpha, exponent, powa, e2, e1);
    float ph_val = same ? e2 * powa : 0.f;
    f = color * ph_val;
    pdf = e1 * powa;
    f_unit = ph_val;
  }
}

// ---- lights ----------------------------------------------------------------

struct LSample {
  V wi;
  float pdf, li_s, dist, phit;
};

__device__ __forceinline__ float env_pdf(float wz) {
  float sin_theta = safe_sqrt(1.0f - wz * wz);
  return sin_theta == 0.f ? 0.f : ENV_PDF / jmax(sin_theta, 1e-20f);
}

// sample_Li of light i from p (_light_sample); cphi/sphi: cos/sin(2 pi u2)
template <class SC>
__device__ LSample light_sample(const SC& S, int i, V p, V n_shade, float u1, float u2,
                                float cphi, float sphi) {
  const float* lf = S.LTF + LT_F * i;
  int kind = S.ldi(S.LTI + LT_I * i);
  LSample r;
  r.phit = 0.f;
  if (kind == L_POINT) {
    V vec = S.ld3f(lf) - p;
    float d2 = jmax(vdot(vec, vec), 1e-20f);
    r.dist = sqrtf(d2);
    r.wi = vec * (1.0f / r.dist);
    r.pdf = 1.0f;
    r.li_s = 1.0f / d2;
  } else if (kind == L_DIRECTION) {
    r.wi = -S.ld3f(lf + 3);
    r.pdf = 1.0f;
    r.li_s = 1.0f;
    r.dist = S.ldf(S.F);
  } else if (kind == L_RECT) {
    V p0 = S.ld3f(lf + 6), p1 = S.ld3f(lf + 9), p2 = S.ld3f(lf + 12), n_l = S.ld3f(lf + 15);
    float area = S.ldf(lf + 18);
    V lp = (p1 + (p0 - p1) * u1) + (p2 - p1) * u2;
    V vec = lp - p;
    float d2 = jmax(vdot(vec, vec), 1e-20f);
    r.dist = sqrtf(d2);
    r.wi = vec * (1.0f / r.dist);
    float cos_l = cdot(n_l, -r.wi);
    float pdf = safe_div(d2, fabsf(cos_l) * area);
    bool facing = cos_l > 0.f;
    r.li_s = facing ? 1.0f : 0.f;
    r.pdf = (facing && pdf > 0.f && isfinite(pdf)) ? pdf : 0.f;
  } else if (kind == L_SPHERE) {
    V c = S.ld3f(lf + 19);
    float rad = S.ldf(lf + 22);
    float r2 = rad * rad;
    V vec_c = c - p;
    float d2c = jmax(vdot(vec_c, vec_c), 1e-20f);
    float inv_dc = rsqrt_(d2c);
    float dist_c = d2c * inv_dc;
    float inv_d2c = inv_dc * inv_dc;
    float sin2_max = jmin(r2 * inv_d2c, 1.0f);
    float cos_max = safe_sqrt(1.0f - sin2_max);
    float cos_t = (cos_max - 1.0f) * u1 + 1.0f;
    float sin2 = 1.0f - cos_t * cos_t;
    bool tiny = sin2_max < TINY_SIN2;
    if (tiny) {
      sin2 = sin2_max * u1;
      cos_t = safe_sqrt(1.0f - sin2);
    }
    float sin_t = safe_sqrt(sin2);
    V to_c = vec_c * inv_dc;
    V s_f, t_f;
    make_frame(to_c, s_f, t_f);
    V wi_cone = (s_f * (-sin_t * cphi) + t_f * (-sin_t * sphi)) + to_c * cos_t;
    float depth2 = r2 - d2c * sin2;
    float ds = dist_c * cos_t - safe_sqrt(depth2);
    float q_cone = TWO_PI_F * (1.0f - cos_max);
    float pdf_cone = q_cone > 0.f ? 1.0f / q_cone : 0.f;
    bool outside = d2c > r2;
    bool ok_cone = depth2 > 0.f && q_cone > 0.f && outside;
    if (!S.ldi(S.LTI + LT_I * i + 1)) {
      r.wi = wi_cone;
      r.pdf = pdf_cone;
      r.li_s = ok_cone ? 1.0f : 0.f;
      r.dist = ds;
      r.phit = outside ? pdf_cone : 0.f;
      return r;
    }
    float z_u = 1.0f - 2.0f * u1;
    float r_u = safe_sqrt(1.0f - z_u * z_u);
    V dir_u = vmk(r_u * cphi, r_u * sphi, z_u);
    V lp_in = c + dir_u * rad;
    V vec_in = lp_in - p;
    float d2_in = jmax(vdot(vec_in, vec_in), 1e-20f);
    float inv_d_in = rsqrt_(d2_in);
    V wi_in = vec_in * inv_d_in;
    float pdf_in = safe_div(d2_in, S.ldf(lf + 23) * fabsf(vdot(n_shade, -wi_in)));
    pdf_in = isfinite(pdf_in) ? pdf_in : 0.f;
    bool ok_in = vdot(dir_u, -wi_in) > 0.f && pdf_in > 0.f;
    bool inside = !outside;
    r.wi = inside ? wi_in : wi_cone;
    r.pdf = inside ? pdf_in : pdf_cone;
    r.li_s = (inside ? ok_in : ok_cone) ? 1.0f : 0.f;
    r.dist = inside ? d2_in * inv_d_in : ds;
  } else {  // L_ENV: uniform-sphere direction, angle-space pdf (ky.cpp:3029-3035)
    float z_u = 1.0f - 2.0f * u1;
    float r_u = safe_sqrt(1.0f - z_u * z_u);
    r.wi = vmk(r_u * cphi, r_u * sphi, z_u);
    r.pdf = env_pdf(r.wi.z);
    r.li_s = 1.0f;
    r.dist = S.ldf(S.F);
  }
  return r;
}

// light_sample's phit of light i from p, recomputed from p alone: the cone
// pdf of a sphere light that p cannot be inside (0 where p is), 0 for every
// other light. The same operations in the same order, so the same bits: K1,
// K2 and K4 keep the previous vertex instead of a per-light array.
template <class SC>
__device__ __forceinline__ float light_phit(const SC& S, int i, V p) {
  if (S.ldi(S.LTI + LT_I * i) != L_SPHERE || S.ldi(S.LTI + LT_I * i + 1)) return 0.f;
  const float* lf = S.LTF + LT_F * i;
  const V c = S.ld3f(lf + 19);
  const float rad = S.ldf(lf + 22);
  const float r2 = rad * rad;
  const V vec_c = c - p;
  const float d2c = jmax(vdot(vec_c, vec_c), 1e-20f);
  const float inv_dc = rsqrt_(d2c);
  const float inv_d2c = inv_dc * inv_dc;
  const float sin2_max = jmin(r2 * inv_d2c, 1.0f);
  const float cos_max = safe_sqrt(1.0f - sin2_max);
  const float q_cone = TWO_PI_F * (1.0f - cos_max);
  const float pdf_cone = q_cone > 0.f ? 1.0f / q_cone : 0.f;
  return d2c > r2 ? pdf_cone : 0.f;
}

// solid-angle pdf of light li (an area light the ray from o hit at t)
template <class SC>
__device__ float hit_light_pdf(const SC& S, int li, V o, V d, float t, V nrm) {
  const float* lf = S.LTF + LT_F * li;
  int kind = S.ldi(S.LTI + LT_I * li);
  float t2 = t * t;
  float cos_l = fabsf(vdot(nrm, d));
  if (kind == L_RECT) return safe_div(t2, cos_l * S.ldf(lf + 18));
  if (kind != L_SPHERE) return 0.f;
  float rad = S.ldf(lf + 22);
  float r2 = rad * rad;
  V vc = S.ld3f(lf + 19) - o;
  float d2c = jmax(vdot(vc, vc), 1e-20f);
  bool inside = d2c <= r2;
  float sin2_max = jmin(r2 / d2c, 1.0f);
  float cos_max = safe_sqrt(1.0f - sin2_max);
  float pdf_cone = safe_div(1.0f, TWO_PI_F * (1.0f - cos_max));
  pdf_cone = isfinite(pdf_cone) ? pdf_cone : 0.f;
  if (!S.ldi(S.LTI + LT_I * li + 1)) return inside ? 0.f : pdf_cone;
  return inside ? safe_div(t2, cos_l * S.ldf(lf + 24)) : pdf_cone;
}

// splitmix64 words of draw site ctr (wavefront.py _site_seeds)
void site_seeds(uint64_t ctr, uint32_t out[3]) {
  uint64_t x = ctr * 0x9E3779B97F4A7C15ull + 0x632BE59BD9B4E019ull;
  for (int k = 0; k < 3; ++k) {
    x += 0x9E3779B97F4A7C15ull;
    uint64_t z = x;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    out[k] = (uint32_t)(z ^ (z >> 31));
  }
}

// Fill the current device's site table once (the words depend on nothing
// but the counter).
cudaError_t upload_sites() {
  constexpr int MAX_DEVICES = 64;
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  static uint32_t words[MAX_SITES][3];
  for (int c = 0; c < MAX_SITES; ++c) site_seeds((uint64_t)c, words[c]);
  err = cudaMemcpyToSymbol(c_sites, words, sizeof(words));
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

}  // namespace
