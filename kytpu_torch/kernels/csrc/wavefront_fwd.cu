// Path-tracing megakernel for NVIDIA Hopper (sm_90a): K1, K2 and K4.
//
// Replaces kytpu/kernels/wavefront.py::_make_kernel: with grad=False, K1
// (residual=False), the Pallas TPU kernel behind every render of a scene with
// at most 64 surfaces (and of a larger one the big-scene tables refuse), and
// K2 (residual=True), the forward of every train step, which also writes the
// coefficient cache that the backward K3 (wavefront_bwd_res.cu) reads; with
// grad=True, K4, the path-replay backward (backward="replay"), which
// re-traces each lane with the forward's draws, peels the tail radiance
// R_{b+1} = (R_b - E_b) / T_b and accumulates the table adjoints. All three
// are one template, wavefront_fwd_kernel<MODE, SOBOL, TEX, ROWTAG>: K2 adds
// stores and K4 adjoint terms and nothing else, so their draws, hits and
// branches are K1's by construction. Their plain PyTorch
// transcriptions are kytpu_torch/kernels/wavefront.py::trace_lanes_plain
// (residual=False/True) and bwd_replay_plain, one body there too; this file
// follows it statement by statement, and chip_smoke.py holds each kernel
// against it.
// The samplers are "random", "hash" and "sobol" (an Owen-scrambled (0,2)
// sequence whose per-site words sit in a __constant__ table); under
// trainable_exponent the Phong exponents come from a per-call table, K2
// caches the kappa-weighted "Bk"/"tuk" planes and K4 adds the exponent
// adjoint.
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
// 1.0f/sqrtf, logf and powf are CUDA's own (as torch.log and torch.pow on
// the card), and min/max propagate NaN as jnp.minimum/maximum and
// torch.minimum/maximum do.
//
// K4 keeps K1's path state and adds g, the tail radiance, the bounce's
// colour adjoints and a per-thread row of 9M+3 (+M) adjoint columns in local
// memory (2.5 KB at M = 64), so it spills where K1 fits in registers. What
// bounds it: K1's FP32/SFU work plus those local read-modify-writes; its
// bytes are K1's rays and radiance plus g. The lanes are summed by the
// fixed-order two-pass reduction of lane_sum.cuh, as K3's are, so its
// gradient repeats to the last bit. Past DENSE_MAX_ROWS surfaces (ROWTAG, a
// compile-time switch) the dense row would not fit a thread: as K8 does,
// each bounce's adjoints of its hit row are written as row-tagged planes
// (dd, ds, de [, dexp], the horizon's de) with a row-tag plane, and only the
// env, per-light emission and checker adjoints stay in the per-thread row;
// the host sorts the tags and bigscene_bwd_res.cu's segment sums add them
// by row in a fixed order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_sum.cuh"
#include "megakernel.cuh"

namespace {

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

// ---- the kernel --------------------------------------------------------------

enum Mode { MODE_FWD = 0, MODE_RESIDUAL = 1, MODE_REPLAY = 2 };

// One launch's arguments: the tables, the lanes and, by mode, the outputs
// (K1: out, the radiance; K2: out, resf, resi; K4: g and L in, out the
// gradient vector through the partials table `partial`).
struct Args {
  const float* F;
  const int* I;
  const float *diffuse, *specular, *emission, *exponent, *light_emit, *env, *o, *d;
  const int *si, *pix;
  float* out;
  float* resf;
  int* resi;
  const float *g, *l_in;
  float* partial;
  int n, n_cols, seed, max_depth, rr_start, rows, sampler, robust;
  // textures: the checker colours, the texel atlas; K4's texel entries
  const float *texa, *texb, *timg;
  float* tex_dout;
  int* tex_tags;
  // K4 past DENSE_MAX_ROWS surfaces: the row-tagged planes and their tags
  float* row_dout;
  int* row_tags;
};

// One lane's path. MODE_FWD accumulates and writes its radiance (K1),
// MODE_RESIDUAL also the coefficient cache (K2), MODE_REPLAY re-traces the
// same path with the same draws and adds its table adjoints to acc (K4):
// dd | ds | de (3M each) | denv (3) | dexp (M, under trainable_exponent) |
// dta | dtb (3T each, textured scenes); under ROWTAG (past DENSE_MAX_ROWS
// surfaces) acc holds denv (3) | each light's emission (3L) | dta | dtb and
// the hit rows' adjoints go to the row-tagged planes. SOBOL, TEX and ROWTAG
// are compile-time switches so that no other sampler's draws, no
// untextured scene and no dense backward branch on them.
template <int MODE, bool SOBOL, bool TEX, bool ROWTAG>
__device__ __forceinline__ void trace_lane(const Args& a, const Scene& S, int lane_id,
                                           float* acc) {
  const int n = a.n;
  const ResPlanes rp = res_planes(S.env_i >= 0, S.single, S.L, S.texp, TEX && S.has_img);
  // plane k of this lane
  auto put = [&](int k, float v) { a.resf[(size_t)k * n + lane_id] = v; };

  const int tile = a.rows * 128;
  const int tile_id = lane_id / tile;
  const uint32_t tile_seed = (uint32_t)a.seed + (uint32_t)tile_id * (2654435761u & 0x7fffffffu);
  Rng rng;
  rng.ctr = 0;
  rng.sobol = SOBOL;
  uint32_t si0 = 0;
  if (a.sampler != S_RANDOM) {
    const uint32_t ph = pix_hash((uint32_t)a.pix[lane_id], (uint32_t)a.seed);
    const uint32_t si = (uint32_t)a.si[lane_id];
    rng.key = rng.sobol ? __brev(si) : pix_hash(si, ph);
    rng.mix = rng.sobol ? ph : 0u;
    si0 = (uint32_t)a.si[tile_id * tile];
  } else {
    rng.key = tile_seed;
    rng.mix = (uint32_t)(lane_id - tile_id * tile) * 374761393u;
  }

  V o = ld3(a.o + 3 * (size_t)lane_id);
  V d = ld3(a.d + 3 * (size_t)lane_id);
  V beta = vmk(1.f, 1.f, 1.f);
  V Lr = vmk(0.f, 0.f, 0.f);
  bool alive = true, spec_prev = false;
  float pdf_prev = 1.0f;
  float phits[MAX_LIGHTS];
  const bool single = S.single != 0;
  const bool has_phong = S.has_lobe(PHONG);
  const bool texp = S.texp != 0;
  const V zero3 = vmk(0.f, 0.f, 0.f);
  int next_bounce = a.max_depth + 1;  // the first bounce this lane does not reach
  // K4: the upstream gradient, the tail radiance and the accumulator columns
  V g = zero3, r_tail = zero3;
  if (MODE == MODE_REPLAY) {
    g = ld3(a.g + 3 * (size_t)lane_id);
    r_tail = ld3(a.l_in + 3 * (size_t)lane_id);
  }
  const int col_d = 0, col_s = 3 * S.M, col_e = 6 * S.M, col_env = ROWTAG ? 0 : 9 * S.M,
            col_x = 9 * S.M + 3,
            col_ta = ROWTAG ? 3 + 3 * S.L : col_x + (S.texp ? S.M : 0),
            col_tb = col_ta + 3 * S.n_tex;
  // K4 under ROWTAG: plane k of this lane's row-tagged adjoints, PB a bounce
  const int PB = S.texp ? 10 : 9;
  auto row_put3 = [&](int k, V v) {
    a.row_dout[(size_t)k * n + lane_id] = v.x;
    a.row_dout[(size_t)(k + 1) * n + lane_id] = v.y;
    a.row_dout[(size_t)(k + 2) * n + lane_id] = v.z;
  };
  // K4: texel entry (slot s of bounce b) of this lane
  auto tex_put = [&](int b, int s, int tag, V v) {
    const size_t j = 4 * (size_t)b + s;
    a.tex_tags[j * n + lane_id] = tag;
    a.tex_dout[(3 * j) * n + lane_id] = v.x;
    a.tex_dout[(3 * j + 1) * n + lane_id] = v.y;
    a.tex_dout[(3 * j + 2) * n + lane_id] = v.z;
  };

  for (int bounce = 0; bounce <= a.max_depth; ++bounce) {
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
    V le = (valid && facing && li_idx >= 0) ? ld3(a.emission + 3 * sid) : zero3;

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
    // E_b, the radiance this vertex adds before the throughput: K4 peels it
    V e_term = le * wb;
    Lr = Lr + beta * e_term;
    if (MODE == MODE_RESIDUAL) put(rp.wb(bounce), (valid && facing) ? wb : 0.f);
    V gb = zero3, de_b = zero3;
    if (MODE == MODE_REPLAY) {
      gb = g * beta;
      if constexpr (ROWTAG) {
        if (valid && li_idx >= 0) de_b = gb * ((valid && facing) ? wb : 0.f);
        a.row_tags[(size_t)bounce * n + lane_id] = valid ? sid + 1 : 0;
      } else {
        if (valid && li_idx >= 0) add3(acc, col_e + 3 * sid, gb * ((valid && facing) ? wb : 0.f));
      }
    }
    if (S.env_i >= 0) {
      float w_env = full ? 1.0f : safe_div(pdf_prev, pdf_prev + env_pdf(d.z));
      float wenv = (alive && !valid) ? w_env : 0.f;
      const V env = ld3(a.env);
      Lr = Lr + (beta * env) * wenv;
      e_term = e_term + env * wenv;
      if (MODE == MODE_RESIDUAL) put(rp.wenv(bounce), wenv);
      if (MODE == MODE_REPLAY) add3(acc, col_env, gb * wenv);
    }
    if (bounce == a.max_depth) {
      if (MODE == MODE_RESIDUAL) a.resi[(size_t)bounce * n + lane_id] = pack_row(sid + 1);
      if constexpr (MODE == MODE_REPLAY && ROWTAG) row_put3(PB * bounce, de_b);
      break;
    }
    bool cont = alive && valid;

    // material resolution
    int mk = valid ? __ldg(S.MATI + MAT_I * sid) : MAT_MATTE;
    const float* mf = S.MATF + MAT_F * (valid ? sid : 0);
    // trainable exponents: the per-call table, read on plastic rows only
    float exponent = texp ? ((valid && mk == MAT_PLASTIC) ? __ldg(a.exponent + sid) : 0.f)
                          : ((S.static_exp || !valid) ? 0.f : __ldg(mf));
    float eta = S.has_glass ? (valid ? __ldg(mf + 1) : 0.f) : 1.0f;
    V diffuse = (valid && mk != MAT_MIRROR) ? ld3(a.diffuse + 3 * sid) : zero3;
    // a textured row's diffuse is its texture's value at the hit
    int trec = -1;
    bool tex_even = false, tex_img = false;
    float tex_x = 0.f, tex_y = 0.f;
    Taps taps;
    if (TEX && valid) {
      trec = __ldg(S.MATI + MAT_I * sid + 2);
      if (trec >= 0) {
        const int* ti = S.TXI + TX_I * trec;
        tex_img = __ldg(ti) != 0;
        if (tex_img) {
          image_xy(S, trec, hp, tex_x, tex_y);
          diffuse = image_lookup(S, trec, tex_x, tex_y, a.timg, taps);
        } else {
          tex_even = checker_even(S, trec, hp);
          diffuse = ld3((tex_even ? a.texa : a.texb) + 3 * __ldg(ti + 1));
        }
      }
    }
    V specular = (valid && mk != MAT_MATTE) ? ld3(a.specular + 3 * sid) : zero3;
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
    // K4: this bounce's colour and exponent adjoints, added to its row once
    V addc_diff = zero3, addc_spec = zero3;
    float addx = 0.f;
    // K4: one NEE term's emission adjoint (to the light's emitting row, or
    // to env), colour adjoint and exponent adjoint
    auto nee_adjoint = [&](int light, float bp, float kap) {
      const V add = (gb * col_nee) * bp;
      if constexpr (ROWTAG) {
        add3(acc, 3 + 3 * light, add);
      } else {
        const int lrow = __ldg(S.LTI + LT_I * light + 2);
        if (lrow >= 0)
          add3(acc, col_e + 3 * lrow, add);
        else if (__ldg(S.LTI + LT_I * light) == L_ENV)
          add3(acc, col_env, add);
      }
      const V addc = (gb * ld3(a.light_emit + 3 * light)) * bp;
      if (S.has_plastic) {
        addc_spec = addc_spec + (lobe_is_phong ? addc : zero3);
        addc_diff = addc_diff + (lobe_is_phong ? zero3 : addc);
      } else {
        addc_diff = addc_diff + addc;
      }
      if (texp) addx = addx + (lobe_is_phong ? vdot(addc, col_nee) * kap : 0.f);
    };

    // ---- light-side NEE ----
    if (single) {
      float u1, u2;
      rng.uniform2(u1, u2);
      uint32_t c = tile_seed + ((uint32_t)(bounce * 668265263u) & 0x7fffffffu);
      c ^= c >> 16;
      c *= 0x85EBCA6Bu;
      c ^= c >> 13;
      if (a.sampler != S_RANDOM) c += si0;
      int pick = (int)((c & 0x7fffffffu) % (uint32_t)S.L);
      pick_bits = pick << RESI_PICK_SHIFT;
      int lkind = __ldg(S.LTI + LT_I * pick);
      float cphi = 0.f, sphi = 0.f;
      if (lkind == L_SPHERE || lkind == L_ENV) {
        cphi = cosf(TWO_PI_F * u2);
        sphi = sin_from_phi_cos(cphi, u2);
      }
      LSample sm = light_sample(S, pick, hp, nrm, u1, u2, cphi, sphi);
      V emit_l = ld3(a.light_emit + 3 * pick);
      V wi_l = to_local(s_f, t_f, nrm, sm.wi);
      float cos_a = vdot(vmk(-wo_l.x, -wo_l.y, wo_l.z), wi_l);
      float pdf_b, f_unit;
      eval_dots(S, kind, exponent, wo_l.z, wi_l.z, cos_a, pdf_b, f_unit);
      float ucos = f_unit * fabsf(wi_l.z);
      bool delta_l = lkind == L_POINT || lkind == L_DIRECTION;
      float w = delta_l ? safe_div(1.0f, sm.pdf) : safe_div(1.0f, sm.pdf + pdf_b);
      bool ok = nee_base && sm.pdf > 0.f;
      float tm = sm.dist - SHADOW_EPS;
      if (a.robust) tm = tm - OFF * fabsf(vdot(nrm, sm.wi));
      bool occ = ok && any_hit_single(S, offset_origin(hp, nrm, sm.wi), sm.wi, tm,
                                      a.robust ? pick : -1);
      float okf = (ok && !occ) ? w * (float)S.L : 0.f;
      float bp = ((sm.li_s * ucos) * okf) * lobe_scale;
      ld = (col_nee * emit_l) * bp;
      const float kap = (MODE != MODE_FWD && texp) ? kappa_dot(exponent, cos_a) : 0.f;
      if (MODE == MODE_RESIDUAL) {
        put(rp.B(bounce, 0), bp);
        if (texp) put(rp.Bk(bounce, 0), lobe_is_phong ? bp * kap : 0.f);
      }
      if (MODE == MODE_REPLAY) nee_adjoint(pick, bp, kap);
    } else {
      float u1, u2;
      rng.uniform2(u1, u2);
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
                                       a.robust != 0);
        float okf = (ok && !occ) ? w * 1.0f : 0.f;
        float bp = ((sm.li_s * ucos) * okf) * lobe_scale;
        ld = ld + (col_nee * ld3(a.light_emit + 3 * i)) * bp;
        const float kap = (MODE != MODE_FWD && texp) ? kappa_dot(exponent, cos_aw) : 0.f;
        if (MODE == MODE_RESIDUAL) {
          put(rp.B(bounce, i), bp);
          if (texp) put(rp.Bk(bounce, i), lobe_is_phong ? bp * kap : 0.f);
        }
        if (MODE == MODE_REPLAY) nee_adjoint(i, bp, kap);
      }
    }
    Lr = Lr + beta * ld;
    e_term = e_term + ld;

    // ---- extension sample ----
    float u1, u2;
    rng.uniform2(u1, u2);
    V f_s, wi_l;
    float pdf_s, f_unit_s;
    bool delta_s, refract;
    bsdf_sample(S, kind, color, diffuse, eta, exponent, wo_l, u1, u2, f_s, wi_l, pdf_s,
                delta_s, f_unit_s, refract);
    V wi_w = to_world(s_f, t_f, nrm, wi_l);
    bool ok = cont && !is_black(f_s) && pdf_s != 0.f;
    V thr = f_s * safe_div(fabsf(wi_l.z), pdf_s);
    V beta_new = beta * thr;
    // kill lanes whose throughput overflows float32
    ok = ok && vmax(beta_new) < __int_as_float(0x7f800000);
    bool alive_n = ok;
    float scale = 1.0f;
    if (bounce > a.rr_start) {
      float u_rr = rng.uniform();
      float q = jmax(1.0f - vmax(beta_new), 0.05f);
      bool kill = u_rr < q;
      scale = safe_div(1.0f, 1.0f - q);
      beta_new = beta_new * scale;
      alive_n = ok && !kill;
    }
    bool to_spec_t = is_mirror || (is_glass && !refract) || lobe_is_phong;
    if (MODE != MODE_FWD) {
      // the extension's throughput per unit table colour, and its kappa
      float t_unit = (f_unit_s * safe_div(fabsf(wi_l.z), pdf_s)) * scale;
      float tu_plane = alive_n ? t_unit * lobe_scale : 0.f;
      float kap_s = texp ? kappa_dot(exponent, vdot(vmk(-wo_l.x, -wo_l.y, wo_l.z), wi_l)) : 0.f;
      if (MODE == MODE_RESIDUAL) {
        put(rp.tu(bounce), tu_plane);
        if (texp) put(rp.tuk(bounce), lobe_is_phong ? tu_plane * kap_s : 0.f);
        a.resi[(size_t)bounce * n + lane_id] = pack_row(sid + 1) + (lobe_is_phong ? RESI_PHONG : 0) +
                                               (to_spec_t ? RESI_TO_SPEC : 0) + pick_bits +
                                               (trec >= 0 && !tex_img && tex_even ? RESI_EVEN : 0);
        if (rp.img) {
          put(rp.tx(bounce), tex_img ? tex_x : 0.f);
          put(rp.ty(bounce), tex_img ? tex_y : 0.f);
        }
      }
      if (MODE == MODE_REPLAY) {
        // R_{b+1} = (R_b - E_b) / T_b per channel, 0 where the path ends
        const V t_eff = alive_n ? thr * scale : zero3;
        const V r_next = alive_n ? vmk(safe_div(r_tail.x - e_term.x, t_eff.x),
                                       safe_div(r_tail.y - e_term.y, t_eff.y),
                                       safe_div(r_tail.z - e_term.z, t_eff.z))
                                 : zero3;
        const V addt = (gb * r_next) * tu_plane;
        addc_spec = addc_spec + (to_spec_t ? addt : zero3);
        addc_diff = addc_diff + (to_spec_t ? zero3 : addt);
        if (texp) addx = addx + (lobe_is_phong ? vdot(addt, col_nee) * kap_s : 0.f);
        if (TEX) {
          // a textured row's diffuse adjoint goes to its texture
          const bool on_img = trec >= 0 && tex_img;
          if (trec >= 0 && !tex_img)
            add3(acc, (tex_even ? col_ta : col_tb) + 3 * __ldg(S.TXI + TX_I * trec + 1),
                 addc_diff);
          if (S.has_img) {
            const bool sep = on_img && __ldg(S.TXI + TX_I * trec + 5) != 0;
#pragma unroll
            for (int s = 0; s < 4; ++s) {
              const bool ok = on_img && taps.t[s] >= 0;
              tex_put(bounce, s, ok ? taps.t[s] + 1 : 0,
                      ok ? vmk(texel_entry(taps, sep, s, addc_diff.x),
                               texel_entry(taps, sep, s, addc_diff.y),
                               texel_entry(taps, sep, s, addc_diff.z))
                         : zero3);
            }
          }
          if (trec >= 0) addc_diff = zero3;
        }
        if constexpr (ROWTAG) {
          const int p = PB * bounce;
          row_put3(p, (valid && mk != MAT_MIRROR) ? addc_diff : zero3);
          row_put3(p + 3, (valid && mk != MAT_MATTE) ? addc_spec : zero3);
          row_put3(p + 6, de_b);
          if (texp)
            a.row_dout[(size_t)(p + 9) * n + lane_id] =
                (valid && mk == MAT_PLASTIC) ? addx : 0.f;
        } else {
          if (valid && mk != MAT_MIRROR) add3(acc, col_d + 3 * sid, addc_diff);
          if (valid && mk != MAT_MATTE) add3(acc, col_s + 3 * sid, addc_spec);
          if (texp && valid && mk == MAT_PLASTIC) acc[col_x + sid] = acc[col_x + sid] + addx;
        }
        r_tail = r_next;
      }
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
  if (MODE == MODE_RESIDUAL) {
    for (int b = next_bounce; b <= a.max_depth; ++b) {
      put(rp.wb(b), 0.f);
      if (rp.env) put(rp.wenv(b), 0.f);
      if (b < a.max_depth) {
        for (int i = 0; i < rp.n_b; ++i) {
          put(rp.B(b, i), 0.f);
          if (texp) put(rp.Bk(b, i), 0.f);
        }
        put(rp.tu(b), 0.f);
        if (texp) put(rp.tuk(b), 0.f);
        if (rp.img) {
          put(rp.tx(b), 0.f);
          put(rp.ty(b), 0.f);
        }
      }
      a.resi[(size_t)b * n + lane_id] = 0;
    }
  }
  if (MODE == MODE_REPLAY && TEX && S.has_img) {
    // the texel entries of the bounces a dead lane never reached: tag 0
    for (int b = next_bounce; b < a.max_depth; ++b)
      for (int s = 0; s < 4; ++s) tex_put(b, s, 0, zero3);
  }
  if constexpr (MODE == MODE_REPLAY && ROWTAG) {
    // the row-tagged planes of the bounces a dead lane never reached: tag 0
    for (int b = next_bounce; b <= a.max_depth; ++b) {
      row_put3(PB * b, zero3);
      if (b < a.max_depth) {
        row_put3(PB * b + 3, zero3);
        row_put3(PB * b + 6, zero3);
        if (texp) a.row_dout[(size_t)(PB * b + 9) * n + lane_id] = 0.f;
      }
      a.row_tags[(size_t)b * n + lane_id] = 0;
    }
  }
  if (MODE != MODE_REPLAY) {
    a.out[3 * (size_t)lane_id] = Lr.x;
    a.out[3 * (size_t)lane_id + 1] = Lr.y;
    a.out[3 * (size_t)lane_id + 2] = Lr.z;
  }
}

// K1, K2 and K4 are this one template: K2 adds the cache stores and K4 the
// adjoint terms, so their draws, hits and branches are K1's by construction.
template <int MODE, bool SOBOL, bool TEX, bool ROWTAG>
__global__ void __launch_bounds__(128) wavefront_fwd_kernel(const Args a) {
  const int lane_id = blockIdx.x * blockDim.x + threadIdx.x;
  Scene S;
  S.init(a.F, a.I);
  if constexpr (MODE == MODE_REPLAY) {
    // per-thread adjoint row (local memory), then the fixed-order block sum
    float acc[ROWTAG ? ROW_COLS : MAX_COLS];
    for (int k = 0; k < a.n_cols; ++k) acc[k] = 0.f;
    if (lane_id < a.n) trace_lane<MODE, SOBOL, TEX, ROWTAG>(a, S, lane_id, acc);
    block_partials(acc, a.n_cols, a.partial);
  } else if (lane_id < a.n) {
    trace_lane<MODE, SOBOL, TEX, ROWTAG>(a, S, lane_id, nullptr);
  }
}

template <int MODE, bool TEX, bool ROWTAG>
void launch_kernel(const Args& a, int blocks, void* stream) {
  if (a.sampler == S_SOBOL)
    wavefront_fwd_kernel<MODE, true, TEX, ROWTAG><<<blocks, 128, 0, (cudaStream_t)stream>>>(a);
  else
    wavefront_fwd_kernel<MODE, false, TEX, ROWTAG><<<blocks, 128, 0, (cudaStream_t)stream>>>(a);
}

// textured: the scene has texture records (texa, texb and timg are then its
// tables, and K4 writes texel entries where it has image textures); K4
// writes row-tagged planes where a.row_tags is given
template <int MODE>
int launch(const Args& a, int textured, void* stream) {
  if (a.sampler == S_SOBOL) {
    if (a.max_depth > MAX_SOBOL_DEPTH) return (int)cudaErrorInvalidValue;
    cudaError_t err = upload_sites();
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = 128;
  const int blocks = a.n > 0 ? (a.n + threads - 1) / threads : (MODE == MODE_REPLAY ? 1 : 0);
  const bool rowtag = MODE == MODE_REPLAY && a.row_tags != nullptr;
  if (blocks > 0 && rowtag) {
    if constexpr (MODE == MODE_REPLAY) {
      if (textured)
        launch_kernel<MODE, true, true>(a, blocks, stream);
      else
        launch_kernel<MODE, false, true>(a, blocks, stream);
    }
  } else if (blocks > 0 && textured) {
    launch_kernel<MODE, true, false>(a, blocks, stream);
  } else if (blocks > 0) {
    launch_kernel<MODE, false, false>(a, blocks, stream);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || MODE != MODE_REPLAY) return (int)err;
  return sum_partials(a.partial, a.out, blocks, a.n_cols, (cudaStream_t)stream);
}

}  // namespace

// Launch on `stream` (PyTorch's current stream); they return cudaGetLastError()
// (or cudaErrorInvalidValue for what the kernel does not take). Tables:
// F, I (pack_tables), the (M, 3) diffuse/specular/emission, the (M,)
// exponent, the (max(L, 1), 3) light emissions, the (3,) env and the
// texture tables texa, texb (T, 3) and timg (texels, 3) (one zero row each
// in an untextured scene; textured: the scene has texture records); lanes:
// o, d (n, 3), si and pix (n,) int32 (null under the "random" sampler).
// sampler: 0 random, 1 hash, 2 sobol.
// K1: radiance only.
extern "C" int kytpu_wavefront_fwd(const float* F, const int* I, const float* diffuse,
                                   const float* specular, const float* emission,
                                   const float* exponent, const float* light_emit,
                                   const float* env, const float* texa, const float* texb,
                                   const float* timg, const float* o, const float* d,
                                   const int* si, const int* pix, float* out, int n, int seed,
                                   int max_depth, int rr_start, int rows, int sampler,
                                   int robust, int textured, void* stream) {
  const Args a{F, I, diffuse, specular, emission, exponent, light_emit, env, o, d, si, pix,
               out, nullptr, nullptr, nullptr, nullptr, nullptr,
               n, 0, seed, max_depth, rr_start, rows, sampler, robust,
               texa, texb, timg, nullptr, nullptr, nullptr, nullptr};
  return launch<MODE_FWD>(a, textured, stream);
}

// K2: radiance and the coefficient cache, resf (res_n, n) float32 and resi
// (max_depth + 1, n) int32, plane-major.
extern "C" int kytpu_wavefront_fwd_res(const float* F, const int* I, const float* diffuse,
                                       const float* specular, const float* emission,
                                       const float* exponent, const float* light_emit,
                                       const float* env, const float* texa, const float* texb,
                                       const float* timg, const float* o, const float* d,
                                       const int* si, const int* pix, float* out, float* resf,
                                       int* resi, int n, int seed, int max_depth, int rr_start,
                                       int rows, int sampler, int robust, int textured,
                                       void* stream) {
  const Args a{F, I, diffuse, specular, emission, exponent, light_emit, env, o, d, si, pix,
               out, resf, resi, nullptr, nullptr, nullptr,
               n, 0, seed, max_depth, rr_start, rows, sampler, robust,
               texa, texb, timg, nullptr, nullptr, nullptr, nullptr};
  return launch<MODE_RESIDUAL>(a, textured, stream);
}

// K4: the table adjoints of upstream gradient g (n, 3) on the lanes whose
// forward radiance is big_l (n, 3), as one (n_cols,) vector dd | ds | de |
// denv [| dexp] [| dta | dtb] in `out`, through the (max(1, ceil(n / 128)),
// n_cols) scratch `partial`; where the scene has image textures, the texel
// entries tex_dout (12 max_depth, n) and their tags tex_tags (4 max_depth,
// n): slot s of bounce b is entry plane 4b + s. Past DENSE_MAX_ROWS
// surfaces (row_tags not null) `out` holds denv | each light's emission |
// dta | dtb, and the hit rows' adjoints are row_dout ((PB max_depth + 3), n)
// with their tags row_tags (max_depth + 1, n), as K8 writes them.
extern "C" int kytpu_wavefront_bwd_replay(const float* F, const int* I, const float* diffuse,
                                          const float* specular, const float* emission,
                                          const float* exponent, const float* light_emit,
                                          const float* env, const float* texa,
                                          const float* texb, const float* timg, const float* o,
                                          const float* d, const int* si, const int* pix,
                                          const float* g, const float* big_l, float* partial,
                                          float* out, float* tex_dout, int* tex_tags,
                                          float* row_dout, int* row_tags, int n, int n_cols,
                                          int seed, int max_depth, int rr_start, int rows,
                                          int sampler, int robust, int textured, void* stream) {
  if (n_cols > (row_tags ? ROW_COLS : MAX_COLS)) return (int)cudaErrorInvalidValue;
  const Args a{F, I, diffuse, specular, emission, exponent, light_emit, env, o, d, si, pix,
               out, nullptr, nullptr, g, big_l, partial,
               n, n_cols, seed, max_depth, rr_start, rows, sampler, robust,
               texa, texb, timg, tex_dout, tex_tags, row_dout, row_tags};
  return launch<MODE_REPLAY>(a, textured, stream);
}
