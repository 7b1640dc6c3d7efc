// The table-driven big-scene megakernel for NVIDIA Hopper (sm_90a): K5, K6
// and K8.
//
// Replaces kytpu/kernels/bigscene.py::_make_kernel: with grad=False, K5
// (residual=False), the Pallas TPU kernel behind every render of a scene
// past 64 surfaces, and K6 (residual=True), the forward of every train step
// on such a scene, which also writes the coefficient cache of
// bigscene.py::_bigres_layout that K7 (bigscene_bwd_res.cu) reads; with
// grad=True, K8, the path-replay backward (backward="replay"), which
// re-traces each lane with the forward's draws and peels the tail radiance
// R_{b+1} = (R_b - E_b) / T_b. All three are one template,
// bigscene_fwd_kernel<MODE, SOBOL>, as K1, K2 and K4 are: K6 adds stores and
// K8 adjoint terms and nothing else, so their draws, hits and branches are
// K5's by construction. Their plain PyTorch transcription is
// kytpu_torch/kernels/bigscene.py::_trace_plain (trace_lanes_plain,
// bwd_replay_plain); this file follows it statement by statement, and
// chip_smoke.py holds the two against each other. The light sampling,
// BSDFs, RNG and vector maths are K1's (megakernel.cuh), reading a header
// and light records packed as K1's are.
//
// Design. One thread runs one lane's whole path (128 threads a block); the
// path state lives in registers. The geometry is one table per shape class
// (tri, rect: 12 floats a row; disk: 8; sphere: 4), rows in Morton order,
// read through __ldg: every lane of a warp reads the same row at the same
// step, so each read is one broadcast. The closest-hit sweep carries only
// (t, class, table row); the material is gathered by the hit's global row
// after the sweep (the TPU carries 16 material columns through a select per
// surface because its vector unit has no per-lane gather; the card does
// not need that). The NEE occlusion is one sweep a bounce that tests the
// shadow ray of every light still unblocked on each row, and a lane leaves
// the sweep once every ray is blocked. A lane leaves the bounce loop when
// it dies, in place of the TPU's whole-tile dead skip; every random draw is
// a stateless hash of (key, lane, draw counter), as in K1. kytpu's cone
// cull changes no result (its tests pin that) and is not run here; its
// matmul sweep is about an ulp from the scalar sweep this file transcribes.
//
// What bounds K5 on the H100: FP32 issue of the sweeps, about 25-35
// operations per row and ray, (1 + L) rays a bounce, against a few bytes a
// lane of memory traffic (24 B of ray in, 12 B of radiance out; the tables,
// 48 B a row, stay in L1/L2). K6 adds (res_n + max_depth + 1) * 4 bytes of
// cache stores a lane, plane-major (plane k of lane i at k * n + i). Built
// with --fmad=false and without fast math, so it rounds as the plain
// version does. Simple first: shared-memory table staging, a per-warp cull
// and the light loop unrolled for small L are later work.
//
// K8 keeps K5's path state and adds g, the tail radiance and the bounce's
// colour adjoints. As K7 does, it writes each bounce's adjoints tagged with
// the row it hit (PB planes a bounce, dd ds de [dexp], then the horizon's
// de; the row tags in a (max_depth + 1, n) int plane, 0 for a miss or a
// bounce the lane does not reach), and its env and light-emission adjoints
// (3 + 3L columns, local memory) go through lane_sum.cuh's fixed-order block
// sums. The host then sorts the tags stably and runs K7's segment sums
// (bigscene_bwd_res.cu): no float atomics, the gradient repeats to the last
// bit. What bounds it: K5's FP32 issue plus the adjoint terms; its bytes
// are K5's plus g and L in and (PB * max_depth + 3) * 4 + (max_depth + 1) *
// 4 B a lane out.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_sum.cuh"
#include "megakernel.cuh"

namespace {

// the class tables, the material rows, and the launch's lanes and outputs
struct BigArgs {
  const float* F;       // header and light records (wavefront.py pack_header)
  const int* I;
  const float* geo;     // tri | rect | disk | sphere rows
  const int* rows;      // the global surface row of each
  const int* mat_i;     // (M, 2): kind, light index
  const float* mat_f;   // (M, 4): eta, d_prob, s_prob, 0
  const float *diffuse, *specular, *emission, *exponent, *light_emit, *env;
  const float *o, *d;
  const int *si, *pix;
  float* out;
  float* resf;
  int* resi;
  int n, n_tri, n_rect, n_disk, n_sph, M, seed, max_depth, rr_start, rows_per_tile,
      sampler, robust, texp;
  // K8: g and L in; the row-tagged planes, the row tags, the lane sums out
  const float *g, *l_in;
  float* dout;
  int* tags;
  float *partial, *lane_sums;
  int n_cols;
};

constexpr int PG = 12, DG = 8, SG = 4;  // columns of the class tables

// the class tables' bases
struct Tables {
  const float *tri, *rect, *disk, *sph;
  const int *tri_r, *rect_r, *disk_r, *sph_r;
  int n_tri, n_rect, n_disk, n_sph;
  __device__ void init(const BigArgs& a) {
    n_tri = a.n_tri; n_rect = a.n_rect; n_disk = a.n_disk; n_sph = a.n_sph;
    tri = a.geo;
    rect = tri + PG * n_tri;
    disk = rect + PG * n_rect;
    sph = disk + DG * n_disk;
    tri_r = a.rows;
    rect_r = tri_r + n_tri;
    disk_r = rect_r + n_rect;
    sph_r = disk_r + n_disk;
  }
};

// K6's cache planes (bigscene.py::bigres_layout). Per bounce b: wb, [wenv],
// emi x3; below the horizon then L x (B [Bk]), tu [tuk], dif x3, spc x3
struct BigRes {
  int stride, env, L, texp;
  __device__ __forceinline__ int wb(int b) const { return b * stride; }
  __device__ __forceinline__ int wenv(int b) const { return b * stride + 1; }
  __device__ __forceinline__ int emi(int b, int c) const { return b * stride + 1 + env + c; }
  __device__ __forceinline__ int B(int b, int i) const {
    return b * stride + 4 + env + i * (1 + texp);
  }
  __device__ __forceinline__ int Bk(int b, int i) const { return B(b, i) + 1; }
  __device__ __forceinline__ int tu(int b) const { return b * stride + 4 + env + L * (1 + texp); }
  __device__ __forceinline__ int tuk(int b) const { return tu(b) + 1; }
  __device__ __forceinline__ int dif(int b, int c) const { return tu(b) + 1 + texp + c; }
  __device__ __forceinline__ int spc(int b, int c) const { return tu(b) + 4 + texp + c; }
};

constexpr int RES_PHONG = 1 << 20, RES_TO_SPEC = 1 << 21;

__device__ __forceinline__ bool planar_inside(float a, float b, bool tri) {
  if (tri) return a >= 0.f && b >= 0.f && a + b <= 1.0f;
  return a >= 0.f && a <= 1.0f && b >= 0.f && b <= 1.0f;
}

// closest hit -> t, class (0 tri, 1 rect, 2 disk, 3 sphere; -1 on a miss)
// and table row; strict t < t_best, so the first of equal rows wins
__device__ void closest_tables(const Tables& T, V o, V d, float& t_best, int& cls, int& trow) {
  t_best = __int_as_float(0x7f800000);
  cls = -1;
  trow = -1;
  for (int k = 0; k < 2; ++k) {
    const float* tab = k == 0 ? T.tri : T.rect;
    const int nr = k == 0 ? T.n_tri : T.n_rect;
    for (int s = 0; s < nr; ++s) {
      const float* P = tab + PG * s;
      const V n = ld3(P);
      const float t = (__ldg(P + 3) - vdot(n, o)) / vdot(n, d);
      const V f1 = ld3(P + 4), f2 = ld3(P + 8);
      const float a = (vdot(f1, o) - __ldg(P + 7)) + t * vdot(f1, d);
      const float b = (vdot(f2, o) - __ldg(P + 11)) + t * vdot(f2, d);
      if (planar_inside(a, b, k == 0) && t > EPS && t < t_best) {
        t_best = t;
        cls = k;
        trow = s;
      }
    }
  }
  for (int s = 0; s < T.n_disk; ++s) {
    const float* P = T.disk + DG * s;
    const V n = ld3(P);
    const float t = (__ldg(P + 3) - vdot(n, o)) / vdot(n, d);
    const V rel = (o + d * t) - ld3(P + 4);
    if (vdot(rel, rel) <= __ldg(P + 7) && t > EPS && t < t_best) {
      t_best = t;
      cls = 2;
      trow = s;
    }
  }
  for (int s = 0; s < T.n_sph; ++s) {
    const float* P = T.sph + SG * s;
    const float r = __ldg(P + 3);
    const V oc = ld3(P) - o;
    const float neg_b = vdot(oc, d);
    const V perp = oc - d * neg_b;
    const float discr = r * r - vdot(perp, perp);
    const float cc = vdot(oc, oc) - r * r;
    const float sq = safe_sqrt(discr);
    const float sgn = neg_b >= 0.f ? 1.0f : -1.0f;
    const float q = neg_b + sgn * sq;
    const float tq = cc / q;
    const float t1 = jmin(q, tq), t2 = jmax(q, tq);
    const bool t1_ok = t1 > EPS;
    const float t = t1_ok ? t1 : t2;
    if (discr >= 0.f && r > 0.f && (t1_ok || t2 > EPS) && t < t_best) {
      t_best = t;
      cls = 3;
      trow = s;
    }
  }
}

// the global row and normal of a hit (a rect's turned toward the ray)
__device__ void hit_record(const Tables& T, int cls, int trow, V o, V d, float t, int& grow,
                           V& nrm) {
  grow = -1;
  nrm = vmk(0.f, 0.f, 0.f);
  if (cls == 3) {
    const float* P = T.sph + SG * trow;
    const float inv = 1.0f / jmax(__ldg(P + 3), 1e-20f);
    nrm = ((o + d * t) - ld3(P)) * inv;
    grow = __ldg(T.sph_r + trow);
  } else if (cls >= 0) {
    const float* P = cls == 0 ? T.tri + PG * trow
                              : cls == 1 ? T.rect + PG * trow : T.disk + DG * trow;
    nrm = ld3(P);
    if (cls == 1 && vdot(nrm, d) > 0.f) nrm = -nrm;
    grow = __ldg((cls == 0 ? T.tri_r : cls == 1 ? T.rect_r : T.disk_r) + trow);
  }
}

// one shadow ray of NEE: direction, tmax, origin offset and n.wi
struct Shadow {
  V wi;
  float tmax, se, nd;
  int own;  // the global row it skips (robust shadows), or -1
};

// One occlusion sweep for the shadow rays `sh` whose bit is set in `need`
// -> the bits of the blocked ones (bigscene.py::_occluded). The terms of
// (hp, n_shade) are shared by the rays; a lane leaves once every ray is
// blocked.
__device__ uint32_t occluded_tables(const Tables& T, V hp, V ns, const Shadow* sh, uint32_t need) {
  uint32_t open = need;
  for (int k = 0; k < 2 && open; ++k) {
    const float* tab = k == 0 ? T.tri : T.rect;
    const int* rws = k == 0 ? T.tri_r : T.rect_r;
    const int nr = k == 0 ? T.n_tri : T.n_rect;
    for (int s = 0; s < nr && open; ++s) {
      const float* P = tab + PG * s;
      const V n = ld3(P), f1 = ld3(P + 4), f2 = ld3(P + 8);
      const float num_h = __ldg(P + 3) - vdot(n, hp);
      const float num_n = vdot(n, ns);
      const float a_h = vdot(f1, hp) - __ldg(P + 7);
      const float a_n = vdot(f1, ns);
      const float b_h = vdot(f2, hp) - __ldg(P + 11);
      const float b_n = vdot(f2, ns);
      for (uint32_t m = open; m; m &= m - 1) {
        const int j = __ffs(m) - 1;
        const Shadow& r = sh[j];
        const float t = (num_h - r.se * num_n) / vdot(n, r.wi);
        const float a = (a_h + r.se * a_n) + t * vdot(f1, r.wi);
        const float b = (b_h + r.se * b_n) + t * vdot(f2, r.wi);
        if (planar_inside(a, b, k == 0) && t > EPS && t < r.tmax &&
            (r.own < 0 || __ldg(rws + s) != r.own))
          open &= ~(1u << j);
      }
    }
  }
  for (int s = 0; s < T.n_disk && open; ++s) {
    const float* P = T.disk + DG * s;
    const V n = ld3(P), p0 = ld3(P + 4);
    const float num_h = __ldg(P + 3) - vdot(n, hp);
    const float num_n = vdot(n, ns);
    const float r2 = __ldg(P + 7);
    for (uint32_t m = open; m; m &= m - 1) {
      const int j = __ffs(m) - 1;
      const Shadow& r = sh[j];
      const float t = (num_h - r.se * num_n) / vdot(n, r.wi);
      const V rel = ((hp + ns * r.se) + r.wi * t) - p0;
      if (vdot(rel, rel) <= r2 && t > EPS && t < r.tmax &&
          (r.own < 0 || __ldg(T.disk_r + s) != r.own))
        open &= ~(1u << j);
    }
  }
  for (int s = 0; s < T.n_sph && open; ++s) {
    const float* P = T.sph + SG * s;
    const float rad = __ldg(P + 3);
    const V vc = ld3(P) - hp;
    const float vc2 = vdot(vc, vc);
    const float vcn = vdot(vc, ns);
    for (uint32_t m = open; m; m &= m - 1) {
      const int j = __ffs(m) - 1;
      const Shadow& r = sh[j];
      const float neg_b = vdot(vc, r.wi) - r.se * r.nd;
      const float oc2 = (vc2 - (2.0f * r.se) * vcn) + OFF2;
      const float discr = (rad * rad - oc2) + neg_b * neg_b;
      if (sphere_occludes(neg_b, discr, r.tmax) && rad > 0.f &&
          (r.own < 0 || __ldg(T.sph_r + s) != r.own))
        open &= ~(1u << j);
    }
  }
  return need & ~open;
}

enum Mode { MODE_FWD = 0, MODE_RESIDUAL = 1, MODE_REPLAY = 2 };

// One lane's path: MODE_FWD writes its radiance (K5), MODE_RESIDUAL also
// the coefficient cache (K6), MODE_REPLAY re-traces the same path with the
// same draws and writes its row-tagged adjoints, adding its env (0-2) and
// per-light emission (3 + 3i ..) adjoints to acc (K8). SOBOL is a
// compile-time switch, as in K1.
template <int MODE, bool SOBOL>
__device__ __forceinline__ void trace_lane(const BigArgs& a, const Scene& S, const Tables& T,
                                           int lane_id, float* acc) {
  const int n = a.n;
  const int L = S.L;
  const bool texp = a.texp != 0;
  BigRes rp;
  rp.env = S.env_i >= 0 ? 1 : 0;
  rp.L = L;
  rp.texp = texp ? 1 : 0;
  rp.stride = 11 + rp.env + L * (1 + rp.texp) + rp.texp;
  auto put = [&](int k, float v) { a.resf[(size_t)k * n + lane_id] = v; };
  // K8: adjoint plane k of this lane, PB planes a bounce below the horizon
  const int PB = texp ? 10 : 9;
  auto dput = [&](int k, float v) { a.dout[(size_t)k * n + lane_id] = v; };

  const int tile = a.rows_per_tile * 128;
  const int tile_id = lane_id / tile;
  const uint32_t tile_seed = (uint32_t)a.seed + (uint32_t)tile_id * (2654435761u & 0x7fffffffu);
  Rng rng;
  rng.ctr = 0;
  rng.sobol = SOBOL;
  if (a.sampler != S_RANDOM) {
    const uint32_t ph = pix_hash((uint32_t)a.pix[lane_id], (uint32_t)a.seed);
    const uint32_t si = (uint32_t)a.si[lane_id];
    rng.key = rng.sobol ? __brev(si) : pix_hash(si, ph);
    rng.mix = rng.sobol ? ph : 0u;
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
  Shadow sh[MAX_LIGHTS];
  const bool has_phong = S.has_lobe(PHONG);
  const V zero3 = vmk(0.f, 0.f, 0.f);
  int next_bounce = a.max_depth + 1;  // the first bounce this lane does not reach
  // K8: the upstream gradient and the tail radiance
  V g = zero3, r_tail = zero3;
  if (MODE == MODE_REPLAY) {
    g = ld3(a.g + 3 * (size_t)lane_id);
    r_tail = ld3(a.l_in + 3 * (size_t)lane_id);
  }

  for (int bounce = 0; bounce <= a.max_depth; ++bounce) {
    float t;
    int cls, trow, grow;
    V nrm;
    closest_tables(T, o, d, t, cls, trow);
    hit_record(T, cls, trow, o, d, t, grow, nrm);
    const bool valid = cls >= 0;
    const float t_safe = valid ? t : 1.0f;
    const V hp = o + d * t_safe;
    const V wo = -d;
    const bool facing = vdot(nrm, wo) > 0.f;
    const bool emit_mask = valid && facing;
    // the hit's material by global row (a miss: 0, kind matte, no light)
    const V emi = valid ? ld3(a.emission + 3 * grow) : zero3;
    const int li_idx = valid ? __ldg(a.mat_i + 2 * grow + 1) : -1;

    // emission MIS weight against the pdf of the light this ray found
    const bool full = bounce == 0 || (S.has_delta && spec_prev);
    float w_emit = 1.0f;
    if (!full) {
      float pdf_l_hit;
      if (S.use_phits)
        pdf_l_hit = li_idx >= 0 ? phits[li_idx] : 0.f;
      else
        pdf_l_hit = li_idx >= 0 ? hit_light_pdf(S, li_idx, o, d, t_safe, nrm) : 0.f;
      w_emit = safe_div(pdf_prev, pdf_prev + pdf_l_hit);
    }
    const float wb = alive ? w_emit : 0.f;
    // E_b, the radiance this vertex adds before the throughput: K8 peels it
    V e_term = (emit_mask ? emi : zero3) * wb;
    Lr = Lr + beta * e_term;
    V gb = zero3, de_b = zero3;
    if (MODE == MODE_REPLAY) {
      gb = g * beta;
      de_b = gb * (emit_mask ? wb : 0.f);
      a.tags[(size_t)bounce * n + lane_id] = valid ? grow + 1 : 0;
    }
    if (MODE == MODE_RESIDUAL) {
      put(rp.wb(bounce), emit_mask ? wb : 0.f);
      put(rp.emi(bounce, 0), emi.x);
      put(rp.emi(bounce, 1), emi.y);
      put(rp.emi(bounce, 2), emi.z);
    }
    if (S.env_i >= 0) {
      const float w_env = full ? 1.0f : safe_div(pdf_prev, pdf_prev + env_pdf(d.z));
      const float wenv = (alive && !valid) ? w_env : 0.f;
      const V env = ld3(a.env);
      Lr = Lr + (beta * env) * wenv;
      if (MODE == MODE_RESIDUAL) put(rp.wenv(bounce), wenv);
      if (MODE == MODE_REPLAY) {
        e_term = e_term + env * wenv;
        add3(acc, 0, gb * wenv);
      }
    }
    if (bounce == a.max_depth) {
      if (MODE == MODE_RESIDUAL) a.resi[(size_t)bounce * n + lane_id] = grow + 1;
      if (MODE == MODE_REPLAY) {
        dput(PB * bounce, de_b.x);
        dput(PB * bounce + 1, de_b.y);
        dput(PB * bounce + 2, de_b.z);
      }
      break;
    }
    const bool cont = alive && valid;

    // material resolution
    const int mk = valid ? __ldg(a.mat_i + 2 * grow) : MAT_MATTE;
    const float exponent = valid ? __ldg(a.exponent + grow) : 0.f;
    const float eta = valid ? __ldg(a.mat_f + 4 * grow) : 0.f;
    const V diffuse = valid ? ld3(a.diffuse + 3 * grow) : zero3;
    const V specular = valid ? ld3(a.specular + 3 * grow) : zero3;
    const bool is_matte = mk == MAT_MATTE, is_mirror = mk == MAT_MIRROR;
    const bool is_glass = mk == MAT_GLASS, is_plastic = mk == MAT_PLASTIC;
    int plastic_kind = LAMBERT;
    V plastic_col = diffuse;
    bool lobe_is_phong = false;
    float lobe_scale = 1.0f;
    if (S.has_plastic) {
      const float u_lobe = rng.uniform();
      const float s_prob = valid ? __ldg(a.mat_f + 4 * grow + 2) : 0.f;
      const float d_prob = valid ? __ldg(a.mat_f + 4 * grow + 1) : 0.f;
      const bool pick_spec = u_lobe < s_prob;
      plastic_kind = pick_spec ? PHONG : LAMBERT;
      const float inv_sp = 1.0f / jmax(s_prob, 1e-12f);
      const float inv_dp = 1.0f / jmax(d_prob, 1e-12f);
      plastic_col = pick_spec ? specular * inv_sp : diffuse * inv_dp;
      lobe_is_phong = is_plastic && pick_spec;
      lobe_scale = is_plastic ? (pick_spec ? inv_sp : inv_dp) : 1.0f;
    }
    const int kind = is_matte ? LAMBERT : is_mirror ? MIRROR : is_glass ? GLASS : plastic_kind;
    const V color = is_matte ? diffuse : ((is_mirror || is_glass) ? specular : plastic_col);
    const bool nee_act = S.has_delta ? (cont && !(is_mirror || is_glass)) : cont;

    V s_f, t_f;
    make_frame(nrm, s_f, t_f);
    const V wo_l = to_local(s_f, t_f, nrm, wo);
    const V wr_w = has_phong ? nrm * (wo_l.z * 2.0f) - wo : zero3;
    const V col_nee = (S.has_plastic && lobe_is_phong) ? specular : diffuse;
    const bool nee_base = nee_act && !is_black(color);

    // ---- NEE: every light, one occlusion sweep for their shadow rays ----
    float u1, u2;
    rng.uniform2(u1, u2);
    float cphi = 0.f, sphi = 0.f;
    if (S.any_azim) {
      cphi = cosf(TWO_PI_F * u2);
      sphi = sin_from_phi_cos(cphi, u2);
    }
    // per light: its shadow ray and its NEE factors li_s * ucos, the MIS
    // weight and the mirror dot (for the kappa plane)
    float lu[MAX_LIGHTS], wl[MAX_LIGHTS], caw[MAX_LIGHTS];
    uint32_t want = 0;
    for (int i = 0; i < L; ++i) {
      const LSample sm = light_sample(S, i, hp, nrm, u1, u2, cphi, sphi);
      phits[i] = sm.phit;
      const float nd = vdot(nrm, sm.wi);
      const float cos_aw = has_phong ? vdot(wr_w, sm.wi) : 0.f;
      float pdf_b, f_unit;
      eval_dots(S, kind, exponent, wo_l.z, nd, cos_aw, pdf_b, f_unit);
      const float ucos = f_unit * fabsf(nd);
      const int lkind = __ldg(S.LTI + LT_I * i);
      wl[i] = (lkind == L_POINT || lkind == L_DIRECTION) ? safe_div(1.0f, sm.pdf)
                                                          : safe_div(1.0f, sm.pdf + pdf_b);
      lu[i] = sm.li_s * ucos;
      caw[i] = cos_aw;
      if (nee_base && sm.pdf > 0.f && sm.li_s != 0.f && ucos != 0.f) want |= 1u << i;
      Shadow& r = sh[i];
      r.wi = sm.wi;
      r.nd = nd;
      r.se = nd < 0.f ? -OFF : OFF;
      r.tmax = sm.dist - SHADOW_EPS;
      if (a.robust) r.tmax = r.tmax - r.se * nd;
      r.own = a.robust ? __ldg(S.LTI + LT_I * i + 2) : -1;
    }
    const uint32_t lit = want ? want & ~occluded_tables(T, hp, nrm, sh, want) : 0u;
    V ld = zero3;
    // K8: this bounce's colour and exponent adjoints, all of its hit row
    V addc_diff = zero3, addc_spec = zero3;
    float addx = 0.f;
    for (int i = 0; i < L; ++i) {
      const float okf = ((lit >> i) & 1u) ? wl[i] : 0.f;
      const float bp = (lu[i] * okf) * lobe_scale;
      const V emit_l = ld3(a.light_emit + 3 * i);
      ld = ld + (col_nee * emit_l) * bp;
      if (MODE == MODE_RESIDUAL) {
        put(rp.B(bounce, i), bp);
        if (texp) put(rp.Bk(bounce, i), lobe_is_phong ? bp * kappa_dot(exponent, caw[i]) : 0.f);
      }
      if (MODE == MODE_REPLAY) {
        add3(acc, 3 + 3 * i, (gb * col_nee) * bp);
        const V addc = (gb * emit_l) * bp;
        addc_spec = addc_spec + (lobe_is_phong ? addc : zero3);
        addc_diff = addc_diff + (lobe_is_phong ? zero3 : addc);
        if (texp)
          addx = addx + (lobe_is_phong ? vdot(addc, col_nee) * kappa_dot(exponent, caw[i]) : 0.f);
      }
    }
    Lr = Lr + beta * ld;
    e_term = e_term + ld;

    // ---- extension sample ----
    rng.uniform2(u1, u2);
    V f_s, wi_l;
    float pdf_s, f_unit_s;
    bool delta_s, refract;
    bsdf_sample(S, kind, color, diffuse, eta, exponent, wo_l, u1, u2, f_s, wi_l, pdf_s, delta_s,
                f_unit_s, refract);
    const V wi_w = to_world(s_f, t_f, nrm, wi_l);
    bool ok = cont && !is_black(f_s) && pdf_s != 0.f;
    const V thr = f_s * safe_div(fabsf(wi_l.z), pdf_s);
    V beta_new = beta * thr;
    // kill lanes whose throughput overflows float32
    ok = ok && vmax(beta_new) < __int_as_float(0x7f800000);
    bool alive_n = ok;
    float scale = 1.0f;
    if (bounce > a.rr_start) {
      const float u_rr = rng.uniform();
      const float q = jmax(1.0f - vmax(beta_new), 0.05f);
      const bool kill = u_rr < q;
      scale = safe_div(1.0f, 1.0f - q);
      beta_new = beta_new * scale;
      alive_n = ok && !kill;
    }
    const bool to_spec = is_mirror || (is_glass && !refract) || lobe_is_phong;
    if (MODE == MODE_REPLAY) {
      // R_{b+1} = (R_b - E_b) / T_b per channel, 0 where the path ends
      const V t_eff = alive_n ? thr * scale : zero3;
      const V r_next = alive_n ? vmk(safe_div(r_tail.x - e_term.x, t_eff.x),
                                     safe_div(r_tail.y - e_term.y, t_eff.y),
                                     safe_div(r_tail.z - e_term.z, t_eff.z))
                               : zero3;
      const float t_unit = (f_unit_s * safe_div(fabsf(wi_l.z), pdf_s)) * scale;
      const V addt = (gb * r_next) * (alive_n ? t_unit * lobe_scale : 0.f);
      addc_spec = addc_spec + (to_spec ? addt : zero3);
      addc_diff = addc_diff + (to_spec ? zero3 : addt);
      if (texp)
        addx = addx + (lobe_is_phong ? vdot(addt, col_nee) *
                                           kappa_dot(exponent, vdot(vmk(-wo_l.x, -wo_l.y, wo_l.z),
                                                                    wi_l))
                                     : 0.f);
      const int p = PB * bounce;
      dput(p, addc_diff.x);
      dput(p + 1, addc_diff.y);
      dput(p + 2, addc_diff.z);
      dput(p + 3, addc_spec.x);
      dput(p + 4, addc_spec.y);
      dput(p + 5, addc_spec.z);
      dput(p + 6, de_b.x);
      dput(p + 7, de_b.y);
      dput(p + 8, de_b.z);
      if (texp) dput(p + 9, addx);
      r_tail = r_next;
    }
    if (MODE == MODE_RESIDUAL) {
      const float t_unit = (f_unit_s * safe_div(fabsf(wi_l.z), pdf_s)) * scale;
      const float tu_plane = alive_n ? t_unit * lobe_scale : 0.f;
      put(rp.tu(bounce), tu_plane);
      if (texp)
        put(rp.tuk(bounce),
            lobe_is_phong ? tu_plane * kappa_dot(exponent, vdot(vmk(-wo_l.x, -wo_l.y, wo_l.z), wi_l))
                          : 0.f);
      put(rp.dif(bounce, 0), diffuse.x);
      put(rp.dif(bounce, 1), diffuse.y);
      put(rp.dif(bounce, 2), diffuse.z);
      put(rp.spc(bounce, 0), specular.x);
      put(rp.spc(bounce, 1), specular.y);
      put(rp.spc(bounce, 2), specular.z);
      a.resi[(size_t)bounce * n + lane_id] =
          (grow + 1) + (lobe_is_phong ? RES_PHONG : 0) + (to_spec ? RES_TO_SPEC : 0);
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
    // the bounces a dead lane never reached: every plane 0 (K7 adds nothing)
    for (int b = next_bounce; b <= a.max_depth; ++b) {
      put(rp.wb(b), 0.f);
      if (rp.env) put(rp.wenv(b), 0.f);
      for (int c = 0; c < 3; ++c) put(rp.emi(b, c), 0.f);
      if (b < a.max_depth) {
        for (int i = 0; i < L; ++i) {
          put(rp.B(b, i), 0.f);
          if (texp) put(rp.Bk(b, i), 0.f);
        }
        put(rp.tu(b), 0.f);
        if (texp) put(rp.tuk(b), 0.f);
        for (int c = 0; c < 3; ++c) {
          put(rp.dif(b, c), 0.f);
          put(rp.spc(b, c), 0.f);
        }
      }
      a.resi[(size_t)b * n + lane_id] = 0;
    }
  }
  if (MODE == MODE_REPLAY) {
    // the bounces a dead lane never reached: tag 0, every plane 0
    for (int b = next_bounce; b <= a.max_depth; ++b) {
      const int np = b < a.max_depth ? PB : 3;
      for (int k = 0; k < np; ++k) dput(PB * b + k, 0.f);
      a.tags[(size_t)b * n + lane_id] = 0;
    }
    return;
  }
  a.out[3 * (size_t)lane_id] = Lr.x;
  a.out[3 * (size_t)lane_id + 1] = Lr.y;
  a.out[3 * (size_t)lane_id + 2] = Lr.z;
}

// K5, K6 and K8 are this one template: K6 adds the cache stores and K8 the
// adjoint terms, so their draws, hits and branches are K5's by construction.
template <int MODE, bool SOBOL>
__global__ void __launch_bounds__(128) bigscene_fwd_kernel(const BigArgs a) {
  const int lane_id = blockIdx.x * blockDim.x + threadIdx.x;
  Scene S;
  S.init(a.F, a.I);
  Tables T;
  T.init(a);
  if constexpr (MODE == MODE_REPLAY) {
    // per-thread env and light-emission adjoints, then the fixed-order block sum
    float acc[3 + 3 * MAX_LIGHTS];
    for (int k = 0; k < a.n_cols; ++k) acc[k] = 0.f;
    if (lane_id < a.n) trace_lane<MODE, SOBOL>(a, S, T, lane_id, acc);
    block_partials(acc, a.n_cols, a.partial);
  } else if (lane_id < a.n) {
    trace_lane<MODE, SOBOL>(a, S, T, lane_id, nullptr);
  }
}

template <int MODE>
int launch(const BigArgs& a, void* stream) {
  if (a.sampler == S_SOBOL) {
    if (a.max_depth > MAX_SOBOL_DEPTH) return (int)cudaErrorInvalidValue;
    cudaError_t err = upload_sites();
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = 128;
  const int blocks = a.n > 0 ? (a.n + threads - 1) / threads : (MODE == MODE_REPLAY ? 1 : 0);
  if (blocks > 0 && a.sampler == S_SOBOL)
    bigscene_fwd_kernel<MODE, true><<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  else if (blocks > 0)
    bigscene_fwd_kernel<MODE, false><<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || MODE != MODE_REPLAY) return (int)err;
  return sum_partials(a.partial, a.lane_sums, blocks, a.n_cols, (cudaStream_t)stream);
}

}  // namespace

// K5 (residual = 0) or K6 (residual = 1) on `stream` (PyTorch's current
// stream); returns cudaGetLastError() (or cudaErrorInvalidValue for what the
// kernel does not take). Tables: F, I (the header and light records), geo
// and rows (the class tables' rows and their global rows; n_tri, n_rect,
// n_disk, n_sph of each), mat_i (M, 2), mat_f (M, 4), the (M, 3)
// diffuse/specular/emission, the (M,) exponent, the (max(L, 1), 3) light
// emissions and the (3,) env; lanes: o, d (n, 3), si and pix (n,) int32
// (null under the "random" sampler); out (n, 3), and under residual resf
// (res_n, n) and resi (max_depth + 1, n), plane-major. sampler: 0 random, 1
// hash, 2 sobol.
extern "C" int kytpu_bigscene_fwd(const float* F, const int* I, const float* geo, const int* rows,
                                  const int* mat_i, const float* mat_f, const float* diffuse,
                                  const float* specular, const float* emission,
                                  const float* exponent, const float* light_emit,
                                  const float* env, const float* o, const float* d, const int* si,
                                  const int* pix, float* out, float* resf, int* resi, int n,
                                  int n_tri, int n_rect, int n_disk, int n_sph, int M, int seed,
                                  int max_depth, int rr_start, int rows_per_tile, int sampler,
                                  int robust, int texp, int residual, void* stream) {
  const BigArgs a{F, I, geo, rows, mat_i, mat_f, diffuse, specular, emission, exponent,
                  light_emit, env, o, d, si, pix, out, resf, resi, n, n_tri, n_rect, n_disk,
                  n_sph, M, seed, max_depth, rr_start, rows_per_tile, sampler, robust, texp};
  return residual ? launch<MODE_RESIDUAL>(a, stream) : launch<MODE_FWD>(a, stream);
}

// K8 on `stream` (PyTorch's current stream): the tables and lanes of
// kytpu_bigscene_fwd, the upstream gradient g (n, 3) and the forward's
// radiance big_l (n, 3) -> the row-tagged adjoint planes dout ((PB *
// max_depth + 3), n), their row tags (max_depth + 1, n) and, through the
// (max(1, ceil(n / 128)), n_cols) scratch `partial`, the (n_cols = 3 + 3L,)
// lane sums of the env and light-emission adjoints. Returns
// cudaGetLastError() (or cudaErrorInvalidValue for what it does not take).
extern "C" int kytpu_bigscene_bwd_replay(
    const float* F, const int* I, const float* geo, const int* rows, const int* mat_i,
    const float* mat_f, const float* diffuse, const float* specular, const float* emission,
    const float* exponent, const float* light_emit, const float* env, const float* o,
    const float* d, const int* si, const int* pix, const float* g, const float* big_l,
    float* dout, int* tags, float* partial, float* lane_sums, int n, int n_cols, int n_tri,
    int n_rect, int n_disk, int n_sph, int M, int seed, int max_depth, int rr_start,
    int rows_per_tile, int sampler, int robust, int texp, void* stream) {
  if (n_cols > 3 + 3 * MAX_LIGHTS || n_cols < 3) return (int)cudaErrorInvalidValue;
  const BigArgs a{F,         I,         geo,   rows,     mat_i,  mat_f,   diffuse, specular,
                  emission,  exponent,  light_emit, env,  o,      d,       si,      pix,
                  nullptr,   nullptr,   nullptr, n,       n_tri,  n_rect,  n_disk,  n_sph,
                  M,         seed,      max_depth, rr_start, rows_per_tile, sampler, robust,
                  texp,      g,         big_l, dout,     tags,   partial, lane_sums, n_cols};
  return launch<MODE_REPLAY>(a, stream);
}
