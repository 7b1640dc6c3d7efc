// Forward path-tracing megakernel for NVIDIA Hopper (sm_90a), K1 and K2.
//
// Replaces kytpu/kernels/wavefront.py::_make_kernel with grad=False: K1
// (residual=False), the Pallas TPU kernel behind every render of a scene with
// at most 64 surfaces, and K2 (residual=True), the forward of every train
// step, which also writes the coefficient cache that the backward K3
// (wavefront_bwd_res.cu) reads. Both are one template, wavefront_fwd_kernel
// <RESIDUAL>: K2 adds stores and nothing else, so its radiance is K1's
// arithmetic by construction. Their plain PyTorch transcription is
// kytpu_torch/kernels/wavefront.py::trace_lanes_plain (residual=False/True);
// this file follows it statement by statement, and chip_smoke.py holds the
// two against each other.
//
// Design. One thread per lane (128 threads a block); the whole path state --
// ray, throughput, radiance, MIS carry -- lives in registers for all bounces,
// so a lane reads 24 B (its ray) and writes 12 B (its radiance) of device
// memory. The TPU kernel bakes the scene into its instruction stream; here the
// scene is two small flat tables (see pack_tables in wavefront.py) read through
// const __restrict__ pointers. Every lane of a warp reads the same record at
// the same time, so each read is a broadcast from L1, and every branch on a
// table field is uniform across the warp. The JAX package folds exact 0/+-1
// geometry constants out of its dot products at trace time (kernels/v3.py);
// cdot() does the same at run time, on the same values, so the same inf/NaN
// values reach the raw divisions of the ray tests. A lane leaves the bounce
// loop when it dies: every random draw is a stateless hash of (key, lane,
// draw counter), and the counter advances identically on every live lane.
//
// What bounds K1 on the H100: FP32 and SFU issue (cos, pow, sqrt, division
// per bounce and per light) and register pressure, not memory. K2 adds
// (res_n + max_depth + 1) * 4 bytes of cache stores a lane, plane-major
// (plane k of lane i at k * n + i) so that a warp's 32 stores of one plane
// fill one 128-byte line. The TPU kernel is straight-line and writes every
// plane of every lane; K2's lanes leave the loop when they die, so after the
// loop it writes the bounces a lane never reached: 0 to every float plane and
// 0 (sid+1 of a miss, no lobe bits) to the int plane, with which K3 adds
// nothing. The design keeps all state in registers and the scene in L1; the
// rest (per-scene generated source instead of table loops, FMA contraction,
// wavefront compaction of divergent lanes, occupancy tuning) is later work
// that starts from a profile. It is built with --fmad=false and without fast math, so it
// rounds as the plain version does: division and sqrt are IEEE, rsqrt is
// 1.0f/sqrtf, and min/max propagate NaN as jnp.minimum/maximum and
// torch.minimum/maximum do.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wavefront_tables.cuh"

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

// _Rng(hw=False): "random" keys by tile seed + lane position in the tile,
// "hash" by a per-lane key (lane_mix = 0)
struct Rng {
  uint32_t key, lane_mix, ctr;
  __device__ __forceinline__ float uniform() {
    ctr += 1;
    uint32_t x = key + lane_mix + ctr * 668265263u;
    return bits_to_unit(lowbias(x));
  }
};

// ---- scene tables ----------------------------------------------------------

struct Scene {
  const float* F;
  const int* I;
  int n_pl, n_sp, M, L, lobes, has_plastic, has_glass, has_delta, static_exp,
      env_i, any_azim, use_phits, single;
  const float *PLF, *SPF, *MATF, *LTF;
  const int *PLI, *SPI, *MATI, *LTI;
  __device__ void init(const float* f, const int* i) {
    F = f;
    I = i;
    n_pl = __ldg(i + 0); n_sp = __ldg(i + 1); M = __ldg(i + 2); L = __ldg(i + 3);
    lobes = __ldg(i + 4); has_plastic = __ldg(i + 5); has_glass = __ldg(i + 6);
    has_delta = __ldg(i + 7); static_exp = __ldg(i + 8); env_i = __ldg(i + 9);
    any_azim = __ldg(i + 10); use_phits = __ldg(i + 11); single = __ldg(i + 12);
    PLI = i + HDR_I;
    SPI = PLI + PL_I * n_pl;
    MATI = SPI + SP_I * n_sp;
    LTI = MATI + MAT_I * M;
    PLF = f + HDR_F;
    SPF = PLF + PL_F * n_pl;
    MATF = SPF + SP_F * n_sp;
    LTF = MATF + MAT_F * M;
  }
  __device__ __forceinline__ bool has_lobe(int k) const { return (lobes >> k) & 1; }
};

// ---- geometry --------------------------------------------------------------

// (t, inside) for one planar row; raw divisions, callers gate on eps < t < tmax
__device__ bool planar_hit(const float* P, int kind, int fast, V o, V d, float& t) {
  V n = ld3(P);
  if (kind == DISK) {
    V p0 = ld3(P + 3);
    t = cdot(n, p0 - o) / cdot(n, d);
    V hp = o + d * t;
    V e = hp - p0;
    return vdot(e, e) <= __ldg(P + 15);
  }
  if (fast) {
    V anchor = ld3(P + 16);
    t = (__ldg(P + 25) - cdot(n, o)) / cdot(n, d);
    V rel = (o + d * t) - anchor;
    float a = cdot(ld3(P + 19), rel);
    float b = cdot(ld3(P + 22), rel);
    if (kind == TRI) return a >= 0.f && b >= 0.f && a + b <= 1.0f;
    return a >= 0.f && a <= 1.0f && b >= 0.f && b <= 1.0f;
  }
  V oa = ld3(P + 3) - o, ob = ld3(P + 6) - o, oc = ld3(P + 9) - o, od = ld3(P + 12) - o;
  float v0d = vdot(vcross(oc, ob), d);
  float v1d = vdot(vcross(ob, oa), d);
  float v2d = vdot(vcross(oa, od), d);
  float v3d = vdot(vcross(od, oc), d);
  bool inside;
  if (kind == TRI)
    inside = (v0d < 0.f && v1d < 0.f && v3d < 0.f) ||
             (v0d >= 0.f && v1d >= 0.f && v2d >= 0.f && v3d >= 0.f);
  else
    inside = (v0d < 0.f && v1d < 0.f && v2d < 0.f && v3d < 0.f) ||
             (v0d >= 0.f && v1d >= 0.f && v2d >= 0.f && v3d >= 0.f);
  t = cdot(n, oa) / cdot(n, d);
  return inside;
}

// closest hit -> t, sid (-1 on a miss) and the winner's normal
__device__ void closest_hit(const Scene& S, V o, V d, float& t_best, int& sid, V& nrm) {
  t_best = __int_as_float(0x7f800000);
  sid = -1;
  for (int row = 0; row < S.n_pl; ++row) {
    const int* pi = S.PLI + PL_I * row;
    float t;
    bool inside = planar_hit(S.PLF + PL_F * row, __ldg(pi), __ldg(pi + 1), o, d, t);
    if (inside && t > EPS && t < t_best) { t_best = t; sid = row; }
  }
  for (int j = 0; j < S.n_sp; ++j) {
    const float* sp = S.SPF + SP_F * j;
    float r2 = __ldg(sp + 4);
    V oc = ld3(sp) - o;
    float neg_b = vdot(oc, d);
    V perp = oc - d * neg_b;
    float discr = r2 - vdot(perp, perp);
    float sq = safe_sqrt(discr);
    float cc = vdot(oc, oc) - r2;
    float sgn = neg_b >= 0.f ? 1.0f : -1.0f;
    float q = neg_b + sgn * sq;
    float tq = cc / q;
    float t1 = jmin(q, tq), t2 = jmax(q, tq);
    bool t1_ok = t1 > EPS, t2_ok = t2 > EPS;
    float t = t1_ok ? t1 : t2;
    if (discr >= 0.f && (t1_ok || t2_ok) && t < t_best) { t_best = t; sid = S.n_pl + j; }
  }
  nrm = vmk(0.f, 0.f, 0.f);
  if (sid >= 0 && sid < S.n_pl) {
    nrm = ld3(S.PLF + PL_F * sid);
    if (__ldg(S.PLI + PL_I * sid) == RECT && (nrm.x * d.x + nrm.y * d.y) + nrm.z * d.z > 0.f)
      nrm = -nrm;
  } else if (sid >= S.n_pl) {
    const float* sp = S.SPF + SP_F * (sid - S.n_pl);
    float inv_r = __ldg(sp + 5);
    nrm = vmk((o.x + d.x * t_best - __ldg(sp)) * inv_r,
              (o.y + d.y * t_best - __ldg(sp + 1)) * inv_r,
              (o.z + d.z * t_best - __ldg(sp + 2)) * inv_r);
  }
}

// root of a sphere crossing in (eps, tmax), square-root free
__device__ __forceinline__ bool sphere_occludes(float neg_b, float discr, float tmax) {
  float a_c = neg_b - EPS, b_c = neg_b - tmax;
  float a2 = a_c * a_c, b2 = b_c * b_c;
  bool a_pos = a_c > 0.f, b_neg = b_c < 0.f;
  bool in1 = a_pos && (discr < a2) && (b_neg || (discr > b2));
  bool in2 = (a_pos || (discr > a2)) && b_neg && (discr < b2);
  return discr >= 0.f && (in1 || in2);
}

// nee="single" occlusion (_any_hit): rows skippable for every light are left
// out; under shadow="robust" so are the surfaces bound to the picked light
__device__ bool any_hit_single(const Scene& S, V o, V d, float tmax, int gate_light) {
  for (int row = 0; row < S.n_pl; ++row) {
    const int* pi = S.PLI + PL_I * row;
    if (__ldg(pi + 3)) continue;
    if (gate_light >= 0 && __ldg(S.MATI + MAT_I * row + 1) == gate_light) continue;
    float t;
    bool inside = planar_hit(S.PLF + PL_F * row, __ldg(pi), __ldg(pi + 1), o, d, t);
    if (inside && t > EPS && t < tmax) return true;
  }
  for (int j = 0; j < S.n_sp; ++j) {
    if (gate_light >= 0 && __ldg(S.MATI + MAT_I * (S.n_pl + j) + 1) == gate_light) continue;
    const float* sp = S.SPF + SP_F * j;
    V oc = ld3(sp) - o;
    float neg_b = vdot(oc, d);
    V perp = oc - d * neg_b;
    float discr = __ldg(sp + 4) - vdot(perp, perp);
    if (sphere_occludes(neg_b, discr, tmax)) return true;
  }
  return false;
}

// nee="all" occlusion of light k's shadow ray (_any_hit_multi, one ray): the
// origin is hp offset by se along n_shade, folded into each surface's terms
__device__ bool any_hit_light(const Scene& S, V hp, V ns, V wi, float tmax, float nd,
                              int k, bool robust) {
  float se = nd < 0.f ? -OFF : OFF;
  if (robust) tmax = tmax - se * nd;
  uint32_t bit = 1u << k;
  for (int row = 0; row < S.n_pl; ++row) {
    const int* pi = S.PLI + PL_I * row;
    if ((uint32_t)__ldg(pi + 2) & bit) continue;
    int kind = __ldg(pi), fast = __ldg(pi + 1);
    const float* P = S.PLF + PL_F * row;
    float t;
    bool inside;
    if (kind == DISK || !fast) {
      inside = planar_hit(P, kind, fast, hp + ns * se, wi, t);
    } else {
      V n = ld3(P), f1 = ld3(P + 19), f2 = ld3(P + 22);
      float num_h = __ldg(P + 25) - cdot(n, hp);
      float num_n = cdot(n, ns);
      float a_h = cdot(f1, hp) - __ldg(P + 26);
      float a_n = cdot(f1, ns);
      float b_h = cdot(f2, hp) - __ldg(P + 27);
      float b_n = cdot(f2, ns);
      float num = num_h - se * num_n;
      t = num / cdot(n, wi);
      float a = (a_h + se * a_n) + t * cdot(f1, wi);
      float b = (b_h + se * b_n) + t * cdot(f2, wi);
      if (kind == TRI) inside = a >= 0.f && b >= 0.f && a + b <= 1.0f;
      else inside = a >= 0.f && a <= 1.0f && b >= 0.f && b <= 1.0f;
    }
    if (inside && t > EPS && t < tmax) return true;
  }
  for (int j = 0; j < S.n_sp; ++j) {
    if ((uint32_t)__ldg(S.SPI + SP_I * j) & bit) continue;
    const float* sp = S.SPF + SP_F * j;
    V vc = ld3(sp) - hp;
    float vc2 = vdot(vc, vc);
    float vcn = vdot(vc, ns);
    float neg_b = vdot(vc, wi) - se * nd;
    float oc2 = (vc2 - (2.0f * se) * vcn) + OFF2;
    float discr = (__ldg(sp + 4) - oc2) + neg_b * neg_b;
    if (sphere_occludes(neg_b, discr, tmax)) return true;
  }
  return false;
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
__device__ __forceinline__ void phong_pow(const Scene& S, float cos_a, float exponent,
                                          float& powa, float& e2, float& e1) {
  if (S.static_exp) {
    powa = ipow(cos_a, S.static_exp);
    e2 = __ldg(S.F + 2);
    e1 = __ldg(S.F + 3);
  } else {
    powa = powf(cos_a, exponent);
    e2 = (exponent + 2.0f) * INV_2PI_F;
    e1 = (exponent + 1.0f) * INV_2PI_F;
  }
}

// Lambert / Phong eval on frame-invariant dots -> (pdf, f_unit)
__device__ void eval_dots(const Scene& S, int kind, float exponent, float wo_z, float wi_z,
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
__device__ void bsdf_sample(const Scene& S, int kind, V color, V color2, float eta,
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
    float cos_t_p = S.static_exp ? powf(u2, __ldg(S.F + 1))
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
__device__ LSample light_sample(const Scene& S, int i, V p, V n_shade, float u1, float u2,
                                float cphi, float sphi) {
  const float* lf = S.LTF + LT_F * i;
  int kind = __ldg(S.LTI + LT_I * i);
  LSample r;
  r.phit = 0.f;
  if (kind == L_POINT) {
    V vec = ld3(lf) - p;
    float d2 = jmax(vdot(vec, vec), 1e-20f);
    r.dist = sqrtf(d2);
    r.wi = vec * (1.0f / r.dist);
    r.pdf = 1.0f;
    r.li_s = 1.0f / d2;
  } else if (kind == L_DIRECTION) {
    r.wi = -ld3(lf + 3);
    r.pdf = 1.0f;
    r.li_s = 1.0f;
    r.dist = __ldg(S.F);
  } else if (kind == L_RECT) {
    V p0 = ld3(lf + 6), p1 = ld3(lf + 9), p2 = ld3(lf + 12), n_l = ld3(lf + 15);
    float area = __ldg(lf + 18);
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
    V c = ld3(lf + 19);
    float rad = __ldg(lf + 22);
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
    if (!__ldg(S.LTI + LT_I * i + 1)) {
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
    float pdf_in = safe_div(d2_in, __ldg(lf + 23) * fabsf(vdot(n_shade, -wi_in)));
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
    r.dist = __ldg(S.F);
  }
  return r;
}

// solid-angle pdf of light li (an area light the ray from o hit at t)
__device__ float hit_light_pdf(const Scene& S, int li, V o, V d, float t, V nrm) {
  const float* lf = S.LTF + LT_F * li;
  int kind = __ldg(S.LTI + LT_I * li);
  float t2 = t * t;
  float cos_l = fabsf(vdot(nrm, d));
  if (kind == L_RECT) return safe_div(t2, cos_l * __ldg(lf + 18));
  if (kind != L_SPHERE) return 0.f;
  float rad = __ldg(lf + 22);
  float r2 = rad * rad;
  V vc = ld3(lf + 19) - o;
  float d2c = jmax(vdot(vc, vc), 1e-20f);
  bool inside = d2c <= r2;
  float sin2_max = jmin(r2 / d2c, 1.0f);
  float cos_max = safe_sqrt(1.0f - sin2_max);
  float pdf_cone = safe_div(1.0f, TWO_PI_F * (1.0f - cos_max));
  pdf_cone = isfinite(pdf_cone) ? pdf_cone : 0.f;
  if (!__ldg(S.LTI + LT_I * li + 1)) return inside ? 0.f : pdf_cone;
  return inside ? safe_div(t2, cos_l * __ldg(lf + 24)) : pdf_cone;
}

// ---- the kernel --------------------------------------------------------------

template <bool RESIDUAL>
__global__ void __launch_bounds__(128)
wavefront_fwd_kernel(const float* __restrict__ F, const int* __restrict__ I,
                     const float* __restrict__ diffuse_t, const float* __restrict__ specular_t,
                     const float* __restrict__ emission_t, const float* __restrict__ light_emit_t,
                     const float* __restrict__ env_t, const float* __restrict__ o_in,
                     const float* __restrict__ d_in, const int* __restrict__ si_in,
                     const int* __restrict__ pix_in, float* __restrict__ out,
                     float* __restrict__ resf, int* __restrict__ resi, int n,
                     int seed, int max_depth, int rr_start, int rows, int hash, int robust) {
  int lane_id = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane_id >= n) return;
  Scene S;
  S.init(F, I);
  const ResPlanes rp = res_planes(S.env_i >= 0, S.single, S.L);
  // plane k of this lane
  auto put = [&](int k, float v) { resf[(size_t)k * n + lane_id] = v; };

  const int tile = rows * 128;
  const int tile_id = lane_id / tile;
  const uint32_t tile_seed = (uint32_t)seed + (uint32_t)tile_id * (2654435761u & 0x7fffffffu);
  Rng rng;
  rng.ctr = 0;
  uint32_t si0 = 0;
  if (hash) {
    rng.key = pix_hash((uint32_t)si_in[lane_id], pix_hash((uint32_t)pix_in[lane_id], (uint32_t)seed));
    rng.lane_mix = 0;
    si0 = (uint32_t)si_in[tile_id * tile];
  } else {
    rng.key = tile_seed;
    rng.lane_mix = (uint32_t)(lane_id - tile_id * tile) * 374761393u;
  }

  V o = ld3(o_in + 3 * (size_t)lane_id);
  V d = ld3(d_in + 3 * (size_t)lane_id);
  V beta = vmk(1.f, 1.f, 1.f);
  V Lr = vmk(0.f, 0.f, 0.f);
  bool alive = true, spec_prev = false;
  float pdf_prev = 1.0f;
  float phits[MAX_LIGHTS];
  const bool single = S.single != 0;
  const bool has_phong = S.has_lobe(PHONG);
  const V zero3 = vmk(0.f, 0.f, 0.f);
  int next_bounce = max_depth + 1;  // the first bounce this lane does not reach

  for (int bounce = 0; bounce <= max_depth; ++bounce) {
    float t;
    int sid;
    V nrm;
    closest_hit(S, o, d, t, sid, nrm);
    bool valid = sid >= 0;
    float t_safe = valid ? t : 1.0f;
    V hp = o + d * t_safe;
    V wo = -d;
    bool facing = vdot(nrm, wo) > 0.f;
    int li_idx = valid ? __ldg(S.MATI + MAT_I * sid + 1) : -1;
    V le = (valid && facing && li_idx >= 0) ? ld3(emission_t + 3 * sid) : zero3;

    // emission MIS weight against the pdf of the light this ray found
    bool full = bounce == 0 || (S.has_delta && spec_prev);
    float w_emit = 1.0f;
    if (!full) {
      float pdf_l_hit;
      if (S.use_phits && !single && bounce > 0)
        pdf_l_hit = li_idx >= 0 ? phits[li_idx] : 0.f;
      else
        pdf_l_hit = li_idx >= 0 ? hit_light_pdf(S, li_idx, o, d, t_safe, nrm) : 0.f;
      w_emit = safe_div(pdf_prev, pdf_prev + pdf_l_hit);
    }
    float wb = alive ? w_emit : 0.f;
    Lr = Lr + beta * (le * wb);
    if (RESIDUAL) put(rp.wb(bounce), (valid && facing) ? wb : 0.f);
    if (S.env_i >= 0) {
      float w_env = full ? 1.0f : safe_div(pdf_prev, pdf_prev + env_pdf(d.z));
      float wenv = (alive && !valid) ? w_env : 0.f;
      Lr = Lr + (beta * ld3(env_t)) * wenv;
      if (RESIDUAL) put(rp.wenv(bounce), wenv);
    }
    if (bounce == max_depth) {
      if (RESIDUAL) resi[(size_t)bounce * n + lane_id] = sid + 1;
      break;
    }
    bool cont = alive && valid;

    // material resolution
    int mk = valid ? __ldg(S.MATI + MAT_I * sid) : MAT_MATTE;
    const float* mf = S.MATF + MAT_F * (valid ? sid : 0);
    float exponent = (S.static_exp || !valid) ? 0.f : __ldg(mf);
    float eta = S.has_glass ? (valid ? __ldg(mf + 1) : 0.f) : 1.0f;
    V diffuse = (valid && mk != MAT_MIRROR) ? ld3(diffuse_t + 3 * sid) : zero3;
    V specular = (valid && mk != MAT_MATTE) ? ld3(specular_t + 3 * sid) : zero3;
    bool is_matte = mk == MAT_MATTE, is_mirror = mk == MAT_MIRROR;
    bool is_glass = mk == MAT_GLASS, is_plastic = mk == MAT_PLASTIC;
    int plastic_kind = LAMBERT;
    V plastic_col = diffuse;
    bool lobe_is_phong = false;
    float lobe_scale = 1.0f;
    if (S.has_plastic) {
      float u_lobe = rng.uniform();
      float s_prob = valid ? __ldg(mf + 3) : 0.f;
      float d_prob = valid ? __ldg(mf + 2) : 0.f;
      bool pick_spec = u_lobe < s_prob;
      plastic_kind = pick_spec ? PHONG : LAMBERT;
      float inv_sp = 1.0f / jmax(s_prob, 1e-12f);
      float inv_dp = 1.0f / jmax(d_prob, 1e-12f);
      plastic_col = pick_spec ? specular * inv_sp : diffuse * inv_dp;
      lobe_is_phong = is_plastic && pick_spec;
      lobe_scale = is_plastic ? (pick_spec ? inv_sp : inv_dp) : 1.0f;
    }
    int kind = is_matte ? LAMBERT : is_mirror ? MIRROR : is_glass ? GLASS : plastic_kind;
    V color = is_matte ? diffuse : ((is_mirror || is_glass) ? specular : plastic_col);
    bool nee_act = S.has_delta ? (cont && !(is_mirror || is_glass)) : cont;

    V s_f, t_f;
    make_frame(nrm, s_f, t_f);
    V wo_l = to_local(s_f, t_f, nrm, wo);
    V wr_w = has_phong ? nrm * (wo_l.z * 2.0f) - wo : zero3;
    V col_nee = (S.has_plastic && lobe_is_phong) ? specular : diffuse;
    bool nee_base = nee_act && !is_black(color);
    V ld = zero3;
    int pick_bits = 0;

    // ---- light-side NEE ----
    if (single) {
      float u1 = rng.uniform();
      float u2 = rng.uniform();
      uint32_t c = tile_seed + ((uint32_t)(bounce * 668265263u) & 0x7fffffffu);
      c ^= c >> 16;
      c *= 0x85EBCA6Bu;
      c ^= c >> 13;
      if (hash) c += si0;
      int pick = (int)((c & 0x7fffffffu) % (uint32_t)S.L);
      pick_bits = pick << RESI_PICK_SHIFT;
      int lkind = __ldg(S.LTI + LT_I * pick);
      float cphi = 0.f, sphi = 0.f;
      if (lkind == L_SPHERE || lkind == L_ENV) {
        cphi = cosf(TWO_PI_F * u2);
        sphi = sin_from_phi_cos(cphi, u2);
      }
      LSample sm = light_sample(S, pick, hp, nrm, u1, u2, cphi, sphi);
      V emit_l = ld3(light_emit_t + 3 * pick);
      V wi_l = to_local(s_f, t_f, nrm, sm.wi);
      float cos_a = vdot(vmk(-wo_l.x, -wo_l.y, wo_l.z), wi_l);
      float pdf_b, f_unit;
      eval_dots(S, kind, exponent, wo_l.z, wi_l.z, cos_a, pdf_b, f_unit);
      float ucos = f_unit * fabsf(wi_l.z);
      bool delta_l = lkind == L_POINT || lkind == L_DIRECTION;
      float w = delta_l ? safe_div(1.0f, sm.pdf) : safe_div(1.0f, sm.pdf + pdf_b);
      bool ok = nee_base && sm.pdf > 0.f;
      float tm = sm.dist - SHADOW_EPS;
      if (robust) tm = tm - OFF * fabsf(vdot(nrm, sm.wi));
      bool occ = ok && any_hit_single(S, offset_origin(hp, nrm, sm.wi), sm.wi, tm,
                                      robust ? pick : -1);
      float okf = (ok && !occ) ? w * (float)S.L : 0.f;
      float bp = ((sm.li_s * ucos) * okf) * lobe_scale;
      ld = (col_nee * emit_l) * bp;
      if (RESIDUAL) put(rp.B(bounce, 0), bp);
    } else {
      float u1 = rng.uniform();
      float u2 = rng.uniform();
      float cphi = 0.f, sphi = 0.f;
      if (S.any_azim) {
        cphi = cosf(TWO_PI_F * u2);
        sphi = sin_from_phi_cos(cphi, u2);
      }
      for (int i = 0; i < S.L; ++i) {
        LSample sm = light_sample(S, i, hp, nrm, u1, u2, cphi, sphi);
        phits[i] = sm.phit;
        float nd = vdot(nrm, sm.wi);
        float cos_aw = has_phong ? vdot(wr_w, sm.wi) : 0.f;
        float pdf_b, f_unit;
        eval_dots(S, kind, exponent, wo_l.z, nd, cos_aw, pdf_b, f_unit);
        float ucos = f_unit * fabsf(nd);
        int lkind = __ldg(S.LTI + LT_I * i);
        float w = (lkind == L_POINT || lkind == L_DIRECTION) ? 1.0f / sm.pdf
                                                             : 1.0f / (sm.pdf + pdf_b);
        bool ok = nee_base && sm.pdf > 0.f;
        bool occ = ok && any_hit_light(S, hp, nrm, sm.wi, sm.dist - SHADOW_EPS, nd, i,
                                       robust != 0);
        float okf = (ok && !occ) ? w * 1.0f : 0.f;
        float bp = ((sm.li_s * ucos) * okf) * lobe_scale;
        ld = ld + (col_nee * ld3(light_emit_t + 3 * i)) * bp;
        if (RESIDUAL) put(rp.B(bounce, i), bp);
      }
    }
    Lr = Lr + beta * ld;

    // ---- extension sample ----
    float u1 = rng.uniform();
    float u2 = rng.uniform();
    V f_s, wi_l;
    float pdf_s, f_unit_s;
    bool delta_s, refract;
    bsdf_sample(S, kind, color, diffuse, eta, exponent, wo_l, u1, u2, f_s, wi_l, pdf_s,
                delta_s, f_unit_s, refract);
    V wi_w = to_world(s_f, t_f, nrm, wi_l);
    bool ok = cont && !is_black(f_s) && pdf_s != 0.f;
    V beta_new = beta * (f_s * safe_div(fabsf(wi_l.z), pdf_s));
    // kill lanes whose throughput overflows float32
    ok = ok && vmax(beta_new) < __int_as_float(0x7f800000);
    bool alive_n = ok;
    float scale = 1.0f;
    if (bounce > rr_start) {
      float u_rr = rng.uniform();
      float q = jmax(1.0f - vmax(beta_new), 0.05f);
      bool kill = u_rr < q;
      scale = safe_div(1.0f, 1.0f - q);
      beta_new = beta_new * scale;
      alive_n = ok && !kill;
    }
    if (RESIDUAL) {
      float t_unit = (f_unit_s * safe_div(fabsf(wi_l.z), pdf_s)) * scale;
      put(rp.tu(bounce), alive_n ? t_unit * lobe_scale : 0.f);
      bool to_spec_t = is_mirror || (is_glass && !refract) || lobe_is_phong;
      resi[(size_t)bounce * n + lane_id] = (sid + 1) + (lobe_is_phong ? RESI_PHONG : 0) +
                                           (to_spec_t ? RESI_TO_SPEC : 0) + pick_bits;
    }
    if (alive_n) {
      o = offset_origin(hp, nrm, wi_w);
      d = wi_w;
      beta = beta_new;
      if (S.has_delta) spec_prev = delta_s;
      pdf_prev = pdf_s;
    }
    alive = alive_n;
    if (!alive) {
      next_bounce = bounce + 1;
      break;
    }
  }
  if (RESIDUAL) {
    for (int b = next_bounce; b <= max_depth; ++b) {
      put(rp.wb(b), 0.f);
      if (rp.env) put(rp.wenv(b), 0.f);
      if (b < max_depth) {
        for (int i = 0; i < rp.n_b; ++i) put(rp.B(b, i), 0.f);
        put(rp.tu(b), 0.f);
      }
      resi[(size_t)b * n + lane_id] = 0;
    }
  }
  out[3 * (size_t)lane_id] = Lr.x;
  out[3 * (size_t)lane_id + 1] = Lr.y;
  out[3 * (size_t)lane_id + 2] = Lr.z;
}

}  // namespace

// Launch on `stream` (PyTorch's current stream); they return cudaGetLastError().
// K1: radiance only.
extern "C" int kytpu_wavefront_fwd(const float* F, const int* I, const float* diffuse,
                                   const float* specular, const float* emission,
                                   const float* light_emit, const float* env, const float* o,
                                   const float* d, const int* si, const int* pix, float* out,
                                   int n, int seed, int max_depth, int rr_start, int rows,
                                   int hash, int robust, void* stream) {
  if (n > 0) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    wavefront_fwd_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        F, I, diffuse, specular, emission, light_emit, env, o, d, si, pix, out, nullptr,
        nullptr, n, seed, max_depth, rr_start, rows, hash, robust);
  }
  return (int)cudaGetLastError();
}

// K2: radiance and the coefficient cache, resf (res_n, n) float32 and resi
// (max_depth + 1, n) int32, plane-major.
extern "C" int kytpu_wavefront_fwd_res(const float* F, const int* I, const float* diffuse,
                                       const float* specular, const float* emission,
                                       const float* light_emit, const float* env,
                                       const float* o, const float* d, const int* si,
                                       const int* pix, float* out, float* resf, int* resi,
                                       int n, int seed, int max_depth, int rr_start, int rows,
                                       int hash, int robust, void* stream) {
  if (n > 0) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    wavefront_fwd_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        F, I, diffuse, specular, emission, light_emit, env, o, d, si, pix, out, resf, resi,
        n, seed, max_depth, rr_start, rows, hash, robust);
  }
  return (int)cudaGetLastError();
}
