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
// run one lane body, lane_start / lane_bounce / lane_finish: K2 adds stores
// and K4 adjoint terms and nothing else, so their draws, hits and branches
// are K1's by construction. Their plain PyTorch transcriptions are
// kytpu_torch/kernels/wavefront.py::trace_lanes_plain (residual=False/True)
// and bwd_replay_plain, one body there too; this file follows it statement
// by statement, and chip_smoke.py holds each kernel against it to the last
// bit. The samplers are "random", "hash" and "sobol" (an Owen-scrambled
// (0,2) sequence whose per-site words sit in a __constant__ table); under
// trainable_exponent the Phong exponents come from a per-call table, K2
// caches the kappa-weighted "Bk"/"tuk" planes and K4 adds the exponent
// adjoint.
//
// What bounds K1 and K2 on the H100: FP32 and SFU issue (cos, pow, sqrt and
// division per bounce, per light and per shadow-ray row test; with
// --fmad=false none of it fuses), the latency of the scene-table reads in
// the row sweeps, occupancy (16 warps an SM at 128 registers a thread),
// and the lanes of a warp that have died while its longest lane still
// runs. Their bytes are small: a lane reads 24 B (its ray) and writes 12 B
// (its radiance); K2 adds (res_n + max_depth + 1) * 4 B of cache stores,
// plane-major (plane k of lane i at k * n + i). The whole path state --
// ray, throughput, radiance, MIS carry -- lives in registers for all
// bounces. The design, step by step (PERF.md has each step's times):
//
// 1. The scene in shared memory. Each block copies the tables of
//    pack_tables (header, planar rows, spheres, materials, lights, texture
//    records) and the colour, emission, exponent and light tables into its
//    shared memory once (SH = true) and the sweeps read them from there; a
//    scene whose tables pass STAGE_BUDGET bytes (wavefront.py
//    SceneTables.stage_bytes) keeps them in device memory and reads them
//    through __ldg (SH = false). The budget is 48 KB, the most a block takes
//    without opting in: Veach's and Cornell's tables take 2,568 and 2,560
//    bytes, and the 1,026-surface random_spheres(1024) with a 16x16 ground
//    atlas, the largest scene that reaches K1 (kbs.extract_tables refuses
//    it), 107,276, so it takes the device-memory route.
// 2. One sweep for all shadow rays of a vertex (nee="all"). The light loop
//    is split in three: sample each light of a chunk of min(L, NEE_CHUNK)
//    lights and keep its ray's wi, tmax, n_shade . wi and NEE weights in
//    this thread's column of a shared-memory block (ShadowRays; 8 rays in
//    registers took 215-255 registers and made K1 42% slower); sweep the
//    rows once, computing each row's terms that depend only on the shading
//    point (the planar rows' n.hp, f1.hp, f2.hp and their n_shade dots, the
//    spheres' |c - hp|^2 and (c - hp).n_shade) once and testing only the
//    rays still unoccluded whose skip bit is clear; then accumulate ld, the
//    "B"/"Bk" planes and K4's adjoints in light order, as before. A ray's
//    occlusion is a boolean that does not depend on the row order and the
//    accumulation keeps its order, so the bits do not change. nee="single"
//    has one shadow ray a vertex and keeps its sweep. The next bounce's hit
//    pdf of a sphere light (light_phit) is recomputed from the previous
//    vertex, which replaces a per-light array in local memory.
// 3. Dead-lane refill (K1, K2 and K4). Each warp owns a contiguous chunk
//    of lanes; a thread (a slot) traces one lane a bounce at a time, and
//    when slots finish their lanes they take the chunk's next lanes in slot
//    order (__ballot_sync / __popc, no atomics), so the slot-to-lane map is
//    fixed and a warp no longer idles on dead lanes while its longest path
//    runs. The bounce, the Rng counter, the MIS carry and the previous
//    vertex (K4: g and the tail radiance) are per-slot state; the tile seed
//    and si0 still come from the lane index, and K2 stores plane-major by
//    lane index, as before. A chunk holds the lanes that spread a launch
//    over MIN_WAVES waves of the warps the SMs hold (refill_chunk: for K1
//    and K2 from the occupancy calculator, for K4 at min_blocks_of blocks
//    an SM, so that its slot-to-lane map, and with it its sums' order, is
//    the same on both accumulator routes), at most 32 * REFILL: 512 lanes
//    at Veach's 4M, where fewer, longer waves leave more of the card idle
//    at the end, and 32 (no refill) at a train step's 262K. The host turns
//    refill off past REFILL_MAX_ROWS surfaces (wavefront.py): there the
//    occlusion sweeps run over hundreds of rows, each ray ends its sweep at
//    its first occluder, and a refilled warp holds lanes from all over the
//    frame, which end theirs far apart.
// 4. Registers and occupancy: K1, K2 and K4 are bound to 4 blocks of 128
//    threads an SM (128 registers a thread; K1 lost 10-15% at 3 blocks,
//    blocks of 256 threads fit only one block an SM, and K4 on its shared
//    accumulator route was 8% slower at 3, where the compiler took up to
//    159 registers). K4 runs the same lane body, so it takes steps 1-3 and
//    branches as K1 does.
//
// The JAX package folds exact 0/+-1 geometry constants out of its dot
// products at trace time (kernels/v3.py); cdot() does the same at run time,
// on the same values, so the same inf/NaN values reach the raw divisions of
// the ray tests. Every random draw is a stateless hash of (key, lane, draw
// counter), and the counter advances identically on every lane. The TPU
// kernel is straight-line and writes every plane of every lane; a lane here
// stops when it dies, so K2 then writes the bounces it never reached: 0 to
// every float plane and 0 (sid+1 of a miss, no lobe bits) to the int plane,
// with which K3 adds nothing. It is built with --fmad=false and without
// fast math, so it rounds as the plain version does: division and sqrt are
// IEEE, rsqrt is 1.0f/sqrtf, logf and powf are CUDA's own (as torch.log and
// torch.pow on the card), and min/max propagate NaN as jnp.minimum/maximum
// and torch.minimum/maximum do.
//
// K4 keeps K1's path state and adds g, the tail radiance, the bounce's
// colour adjoints and a per-slot adjoint row, which each lane the slot
// traces adds to in turn. The row keeps the columns a lane can add to
// (wavefront.py acc_columns, through the column map `cmap`: 64 of Veach's
// 102), as K3's does, and is the slot's column of the block's accumulator
// in dynamic shared memory, after the staged tables and the shadow rays
// (ACC_SHARED, lane_sum.cuh's ColAcc: column k of thread t at k * 128 + t,
// conflict-free whatever rows a warp's lanes hit) where the block stays
// within ACC_BUDGET (wavefront.py acc_route): 53 KB at Veach, four blocks
// an SM (at 73 KB, every column kept, three blocks: no faster than the
// local row). A larger row (32 lights' 199 kept columns) stays in local
// memory (ACC_LOCAL, RowAcc), and a row past that local array (past
// ROW_LIGHTS lights or ROW_TEXTURES textures on the row-tagged route) is
// the shared route's block in device memory (ACC_DEVICE). What bounds it: K1's FP32/SFU work plus the
// adjoint terms; its bytes are K1's rays and radiance plus g. The block's
// slots are summed by column in one fixed order on both routes
// (lane_sum.cuh), as K3's lanes are, so its gradient repeats to the last
// bit and does not depend on the route; the order depends on which slot
// traced which lane (step 3), so with refill it is not the plain
// version's, which sums lane by lane in K3's order (wavefront.py
// sum_kept); without refill (32-lane chunks) the two orders are one. Past
// DENSE_MAX_ROWS surfaces (ROWTAG, a compile-time switch) the dense row
// would not fit a thread: as K8 does, each bounce's adjoints of its hit row
// are written as row-tagged planes (dd, ds, de [, dexp], the horizon's de)
// with a row-tag plane, and only the env, per-light emission and checker
// adjoints stay in the local row; the host sorts the tags and
// bigscene_bwd_res.cu's segment sums add them by row in a fixed order. Later work (each from a measurement): per-scene
// generated source instead of table loops, FMA contraction (it changes the
// bits the plain version fixes).

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_sum.cuh"
#include "megakernel.cuh"

namespace {

// shared-memory budget of the staged tables (step 1), STAGE_BUDGET in
// wavefront.py
constexpr int STAGE_BUDGET = 48 * 1024;
// lights sampled, swept and accumulated together at most (step 2),
// NEE_CHUNK in wavefront.py
constexpr int NEE_CHUNK = 8;
// lanes a slot traces in turn at most (step 3): a warp's chunk is at most
// 32 * REFILL lanes; and the waves of resident blocks a K1 or K2 grid
// keeps at least, so that the blocks' scheduler balances the chunks' work
constexpr int REFILL = 16;
constexpr int MIN_WAVES = 4;
enum Mode { MODE_FWD = 0, MODE_RESIDUAL = 1, MODE_REPLAY = 2 };
// threads a block: K1 and K2, K4 (lane_sum.cuh's fixed-order sums)
constexpr int FWD_THREADS = 128;
template <int MODE>
constexpr int threads_of() { return MODE == MODE_REPLAY ? LANE_THREADS : FWD_THREADS; }
// blocks an SM that the compiler must leave registers for (step 4): 16
// warps an SM, 128 registers a thread
template <int MODE>
constexpr int min_blocks_of() { return 16 * 32 / threads_of<MODE>(); }

// K1, K2 and K4's view of the scene: pack_tables' tables and the colour,
// emission, exponent, light and texture tables, in shared memory (SH) or in
// device memory
template <bool SH>
struct KScene : SceneT<SH> {
  const float *diffuse, *specular, *emission, *exponent, *light_emit, *env, *texa, *texb;
};

// ---- geometry --------------------------------------------------------------

// (t, inside) for one planar row; raw divisions, callers gate on eps < t < tmax
template <class SC>
__device__ bool planar_hit(const SC& S, const float* P, int kind, int fast, V o, V d, float& t) {
  V n = S.ld3f(P);
  if (kind == DISK) {
    V p0 = S.ld3f(P + 3);
    t = cdot(n, p0 - o) / cdot(n, d);
    V hp = o + d * t;
    V e = hp - p0;
    return vdot(e, e) <= S.ldf(P + 15);
  }
  if (fast) {
    V anchor = S.ld3f(P + 16);
    t = (S.ldf(P + 25) - cdot(n, o)) / cdot(n, d);
    V rel = (o + d * t) - anchor;
    float a = cdot(S.ld3f(P + 19), rel);
    float b = cdot(S.ld3f(P + 22), rel);
    if (kind == TRI) return a >= 0.f && b >= 0.f && a + b <= 1.0f;
    return a >= 0.f && a <= 1.0f && b >= 0.f && b <= 1.0f;
  }
  V oa = S.ld3f(P + 3) - o, ob = S.ld3f(P + 6) - o, oc = S.ld3f(P + 9) - o, od = S.ld3f(P + 12) - o;
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
template <class SC>
__device__ void closest_hit(const SC& S, V o, V d, float& t_best, int& sid, V& nrm) {
  t_best = __int_as_float(0x7f800000);
  sid = -1;
  for (int row = 0; row < S.n_pl; ++row) {
    const int* pi = S.PLI + PL_I * row;
    float t;
    bool inside = planar_hit(S, S.PLF + PL_F * row, S.ldi(pi), S.ldi(pi + 1), o, d, t);
    if (inside && t > EPS && t < t_best) { t_best = t; sid = row; }
  }
  for (int j = 0; j < S.n_sp; ++j) {
    const float* sp = S.SPF + SP_F * j;
    float r2 = S.ldf(sp + 4);
    V oc = S.ld3f(sp) - o;
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
    nrm = S.ld3f(S.PLF + PL_F * sid);
    if (S.ldi(S.PLI + PL_I * sid) == RECT && (nrm.x * d.x + nrm.y * d.y) + nrm.z * d.z > 0.f)
      nrm = -nrm;
  } else if (sid >= S.n_pl) {
    const float* sp = S.SPF + SP_F * (sid - S.n_pl);
    float inv_r = S.ldf(sp + 5);
    nrm = vmk((o.x + d.x * t_best - S.ldf(sp)) * inv_r,
              (o.y + d.y * t_best - S.ldf(sp + 1)) * inv_r,
              (o.z + d.z * t_best - S.ldf(sp + 2)) * inv_r);
  }
}

// nee="single" occlusion (_any_hit): rows skippable for every light are left
// out; under shadow="robust" so are the surfaces bound to the picked light
template <class SC>
__device__ bool any_hit_single(const SC& S, V o, V d, float tmax, int gate_light) {
  for (int row = 0; row < S.n_pl; ++row) {
    const int* pi = S.PLI + PL_I * row;
    if (S.ldi(pi + 3)) continue;
    if (gate_light >= 0 && S.ldi(S.MATI + MAT_I * row + 1) == gate_light) continue;
    float t;
    bool inside = planar_hit(S, S.PLF + PL_F * row, S.ldi(pi), S.ldi(pi + 1), o, d, t);
    if (inside && t > EPS && t < tmax) return true;
  }
  for (int j = 0; j < S.n_sp; ++j) {
    if (gate_light >= 0 && S.ldi(S.MATI + MAT_I * (S.n_pl + j) + 1) == gate_light) continue;
    const float* sp = S.SPF + SP_F * j;
    V oc = S.ld3f(sp) - o;
    float neg_b = vdot(oc, d);
    V perp = oc - d * neg_b;
    float discr = S.ldf(sp + 4) - vdot(perp, perp);
    if (sphere_occludes(neg_b, discr, tmax)) return true;
  }
  return false;
}

// The NEE shadow rays of one vertex under nee="all", lights i0 .. i0 +
// chunk - 1 (_any_hit_multi), chunk = min(L, NEE_CHUNK): each leaves hp
// offset by se = +-OFF along n_shade (the sign of nd = n_shade . wi), up to
// tmax; val and wgt are its NEE weights. They live in this thread's column
// of a shared-memory block, field f of ray k at p[(k * FIELDS + f) *
// RAY_STRIDE] (the block's threads side by side: no bank conflicts, the
// fields of a ray at constant offsets), and hold no registers across the
// sweep.
constexpr int RAY_STRIDE = 128;
static_assert(FWD_THREADS == RAY_STRIDE && LANE_THREADS == RAY_STRIDE, "one column a thread");
static_assert(MASK_LIGHTS % NEE_CHUNK == 0, "a chunk's lights in one skip word");
struct ShadowRays {
  enum { WX, WY, WZ, TMAX, ND, VAL, WGT, FIELDS };
  float* p;
  int chunk;
  __device__ __forceinline__ float& at(int f, int k) const {
    return p[(k * FIELDS + f) * RAY_STRIDE];
  }
  __device__ __forceinline__ V wi(int k) const { return vmk(at(WX, k), at(WY, k), at(WZ, k)); }
};

// One sweep of the rows for the rays whose bits are set in `pend` -> the
// bits of those that no row occludes. Each row's terms that depend only on
// (hp, n_shade) are computed once; a ray is tested on a row only while it is
// unoccluded and its skip bit for that row is clear, and the sweep stops
// when no ray is left: each ray's boolean is any_hit's. The chunk's lights
// i0 .. i0 + chunk - 1 lie in one skip word (NEE_CHUNK divides
// MASK_LIGHTS): lights 0-31 in the records' own field, later ones in the
// words after the texture records (SceneT::XMI), a planar row's at
// pm[pstride * row] and a sphere's at sm[sstride * j] either way.
template <class SC>
__device__ __forceinline__ uint32_t shadow_sweep(const SC& S, V hp, V ns, const ShadowRays& R,
                                                 uint32_t pend, int i0) {
  const int g = i0 / MASK_LIGHTS;  // the chunk's skip word
  const int* xm = S.XMI + (g > 0 ? g - 1 : 0) * (S.n_pl + S.n_sp);
  const int* pm = g ? xm : S.PLI + 2;
  const int* sm = g ? xm + S.n_pl : S.SPI;
  const int pstride = g ? 1 : PL_I, sstride = g ? 1 : SP_I;
  const int sh = i0 % MASK_LIGHTS;
  for (int row = 0; row < S.n_pl && pend; ++row) {
    const int* pi = S.PLI + PL_I * row;
    const uint32_t test = pend & ~((uint32_t)S.ldi(pm + pstride * row) >> sh);
    if (!test) continue;
    const int kind = S.ldi(pi), fast = S.ldi(pi + 1);
    const float* P = S.PLF + PL_F * row;
    if (kind == DISK || !fast) {
      for (uint32_t m = test; m; m &= m - 1) {
        const int k = __ffs(m) - 1;
        const float se = R.at(R.ND, k) < 0.f ? -OFF : OFF;
        float t;
        const bool inside = planar_hit(S, P, kind, fast, hp + ns * se, R.wi(k), t);
        if (inside && t > EPS && t < R.at(R.TMAX, k)) pend &= ~(1u << k);
      }
      continue;
    }
    const V n = S.ld3f(P), f1 = S.ld3f(P + 19), f2 = S.ld3f(P + 22);
    const float num_h = S.ldf(P + 25) - cdot(n, hp);
    const float num_n = cdot(n, ns);
    const float a_h = cdot(f1, hp) - S.ldf(P + 26);
    const float a_n = cdot(f1, ns);
    const float b_h = cdot(f2, hp) - S.ldf(P + 27);
    const float b_n = cdot(f2, ns);
    for (uint32_t m = test; m; m &= m - 1) {
      const int k = __ffs(m) - 1;
      const V wi = R.wi(k);
      const float se = R.at(R.ND, k) < 0.f ? -OFF : OFF;
      const float num = num_h - se * num_n;
      const float t = num / cdot(n, wi);
      const float a = (a_h + se * a_n) + t * cdot(f1, wi);
      const float b = (b_h + se * b_n) + t * cdot(f2, wi);
      const bool inside = kind == TRI ? (a >= 0.f && b >= 0.f && a + b <= 1.0f)
                                      : (a >= 0.f && a <= 1.0f && b >= 0.f && b <= 1.0f);
      if (inside && t > EPS && t < R.at(R.TMAX, k)) pend &= ~(1u << k);
    }
  }
  for (int j = 0; j < S.n_sp && pend; ++j) {
    const uint32_t test = pend & ~((uint32_t)S.ldi(sm + sstride * j) >> sh);
    if (!test) continue;
    const float* sp = S.SPF + SP_F * j;
    const V vc = S.ld3f(sp) - hp;
    const float vc2 = vdot(vc, vc);
    const float vcn = vdot(vc, ns);
    const float r2 = S.ldf(sp + 4);
    for (uint32_t m = test; m; m &= m - 1) {
      const int k = __ffs(m) - 1;
      const float nd = R.at(R.ND, k);
      const float se = nd < 0.f ? -OFF : OFF;
      const float neg_b = vdot(vc, R.wi(k)) - se * nd;
      const float oc2 = (vc2 - (2.0f * se) * vcn) + OFF2;
      const float discr = (r2 - oc2) + neg_b * neg_b;
      if (sphere_occludes(neg_b, discr, R.at(R.TMAX, k))) pend &= ~(1u << k);
    }
  }
  return pend;
}

// ---- the lane body -----------------------------------------------------------

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
  // K4: the columns of a row, and of the gradient vector out
  int n, n_cols, n_out, seed, max_depth, rr_start, rows, sampler, robust;
  // textures: the checker colours, the texel atlas; K4's texel entries
  const float *texa, *texb, *timg;
  float* tex_dout;
  int* tex_tags;
  // K4 past DENSE_MAX_ROWS surfaces: the row-tagged planes and their tags
  float* row_dout;
  int* row_tags;
  // lanes a warp owns (a multiple of 32)
  int chunk;
  // words of the staged tables in dynamic shared memory, and the lights a
  // shadow-ray chunk holds (its block follows the tables; 0 under
  // nee="single"); whether slots refill (else a warp owns 32 lanes, one a
  // thread); K4: its accumulator route (an AccRoute; the shared route's
  // block follows the shadow rays'), and the blocks its partials table
  // holds
  int stage_words, nee_rays, refill, acc_route, n_blocks;
  // K4: each column of the gradient vector's column in a row (lane_sum.cuh)
  const int* cmap;
  // K4 on ACC_DEVICE: the blocks' accumulators, n_cols * LANE_THREADS
  // floats a block
  float* wide;
};

// One lane's path state, kept by the thread that traces it: everything that
// lives from one bounce to the next
struct Lane {
  int id, bounce;  // the lane, and the bounce it traces next
  uint32_t tile_seed, si0;
  Rng rng;
  V o, d, beta, Lr;
  V hp_prev;  // the previous vertex (light_phit)
  float pdf_prev;
  bool spec_prev;
  V g, r_tail;  // K4: the upstream gradient and the tail radiance
};

template <int MODE, bool SOBOL>
__device__ __forceinline__ void lane_start(const Args& a, int id, Lane& L) {
  const int tile = a.rows * 128;
  const int tile_id = id / tile;
  L.id = id;
  L.bounce = 0;
  L.tile_seed = (uint32_t)a.seed + (uint32_t)tile_id * (2654435761u & 0x7fffffffu);
  L.rng.ctr = 0;
  L.rng.sobol = SOBOL;
  L.si0 = 0;
  if (a.sampler != S_RANDOM) {
    const uint32_t ph = pix_hash((uint32_t)a.pix[id], (uint32_t)a.seed);
    const uint32_t si = (uint32_t)a.si[id];
    L.rng.key = L.rng.sobol ? __brev(si) : pix_hash(si, ph);
    L.rng.mix = L.rng.sobol ? ph : 0u;
    L.si0 = (uint32_t)a.si[tile_id * tile];
  } else {
    L.rng.key = L.tile_seed;
    L.rng.mix = (uint32_t)(id - tile_id * tile) * 374761393u;
  }
  L.o = ld3(a.o + 3 * (size_t)id);
  L.d = ld3(a.d + 3 * (size_t)id);
  L.beta = vmk(1.f, 1.f, 1.f);
  L.Lr = vmk(0.f, 0.f, 0.f);
  L.hp_prev = vmk(0.f, 0.f, 0.f);
  L.spec_prev = false;
  L.pdf_prev = 1.0f;
  if (MODE == MODE_REPLAY) {
    L.g = ld3(a.g + 3 * (size_t)id);
    L.r_tail = ld3(a.l_in + 3 * (size_t)id);
  }
}

// One bounce of lane L -> whether its path ended (it died, or this was the
// horizon); L.bounce is then the first bounce it did not reach. MODE_FWD
// accumulates the radiance (K1), MODE_RESIDUAL also writes the coefficient
// cache (K2), MODE_REPLAY re-traces the same path with the same draws and
// adds its table adjoints to acc (K4; a RowAcc or ColAcc view of the slot's
// row, lane_sum.cuh): dd | ds | de (3M each) | denv (3) |
// dexp (M, under trainable_exponent) | dta | dtb (3T each, textured
// scenes); under ROWTAG (past DENSE_MAX_ROWS surfaces) acc holds denv (3) |
// each light's emission (3L) | dta | dtb and the hit rows' adjoints go to
// the row-tagged planes. SOBOL, TEX and ROWTAG are compile-time switches so
// that no other sampler's draws, no untextured scene and no dense backward
// branch on them.
// K4: v to columns col .. col + 2 of the accumulator view (lane_sum.cuh)
template <class A>
__device__ __forceinline__ void acc_add3(const A& acc, int col, V v) {
  float* q = acc.at(col);
  q[0] = q[0] + v.x;
  q[A::STRIDE] = q[A::STRIDE] + v.y;
  q[2 * A::STRIDE] = q[2 * A::STRIDE] + v.z;
}

template <int MODE, bool SOBOL, bool TEX, bool ROWTAG, bool SH, class A>
__device__ __forceinline__ bool lane_bounce(const Args& a, const KScene<SH>& S,
                                            const ResPlanes& rp, const ShadowRays& R, Lane& L,
                                            A acc) {
  const int n = a.n;
  const int lane_id = L.id;
  const int bounce = L.bounce;
  // plane k of this lane
  auto put = [&](int k, float v) { a.resf[(size_t)k * n + lane_id] = v; };
  const bool single = S.single != 0;
  const bool has_phong = S.has_lobe(PHONG);
  const bool texp = S.texp != 0;
  const V zero3 = vmk(0.f, 0.f, 0.f);
  const V o = L.o, d = L.d, beta = L.beta;
  Rng& rng = L.rng;
  // K4: the accumulator columns
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
  L.bounce = bounce + 1;

  float t;
  int sid;
  V nrm;
  closest_hit(S, o, d, t, sid, nrm);
  bool valid = sid >= 0;
  float t_safe = valid ? t : 1.0f;
  V hp = o + d * t_safe;
  V wo = -d;
  bool facing = vdot(nrm, wo) > 0.f;
  int li_idx = valid ? S.ldi(S.MATI + MAT_I * sid + 1) : -1;
  V le = (valid && facing && li_idx >= 0) ? S.ld3f(S.emission + 3 * sid) : zero3;

  // emission MIS weight against the pdf of the light this ray found; a lane
  // is alive at every bounce it traces
  bool full = bounce == 0 || (S.has_delta && L.spec_prev);
  float wb = 1.0f;
  if (!full) {
    float pdf_l_hit;
    if (S.use_phits && !single && bounce > 0)
      pdf_l_hit = li_idx >= 0 ? light_phit(S, li_idx, L.hp_prev) : 0.f;
    else
      pdf_l_hit = li_idx >= 0 ? hit_light_pdf(S, li_idx, o, d, t_safe, nrm) : 0.f;
    wb = safe_div(L.pdf_prev, L.pdf_prev + pdf_l_hit);
  }
  // E_b, the radiance this vertex adds before the throughput: K4 peels it
  V e_term = le * wb;
  L.Lr = L.Lr + beta * e_term;
  if (MODE == MODE_RESIDUAL) put(rp.wb(bounce), (valid && facing) ? wb : 0.f);
  V gb = zero3, de_b = zero3;
  if (MODE == MODE_REPLAY) {
    gb = L.g * beta;
    if constexpr (ROWTAG) {
      if (valid && li_idx >= 0) de_b = gb * ((valid && facing) ? wb : 0.f);
      a.row_tags[(size_t)bounce * n + lane_id] = valid ? sid + 1 : 0;
    } else {
      if (valid && li_idx >= 0) acc_add3(acc, col_e + 3 * sid, gb * ((valid && facing) ? wb : 0.f));
    }
  }
  if (S.env_i >= 0) {
    float w_env = full ? 1.0f : safe_div(L.pdf_prev, L.pdf_prev + env_pdf(d.z));
    float wenv = !valid ? w_env : 0.f;
    const V env = S.ld3f(S.env);
    L.Lr = L.Lr + (beta * env) * wenv;
    e_term = e_term + env * wenv;
    if (MODE == MODE_RESIDUAL) put(rp.wenv(bounce), wenv);
    if (MODE == MODE_REPLAY) acc_add3(acc, col_env, gb * wenv);
  }
  if (bounce == a.max_depth) {
    if (MODE == MODE_RESIDUAL) a.resi[(size_t)bounce * n + lane_id] = pack_row(sid + 1);
    if constexpr (MODE == MODE_REPLAY && ROWTAG) row_put3(PB * bounce, de_b);
    return true;
  }
  const bool cont = valid;

  // material resolution
  int mk = valid ? S.ldi(S.MATI + MAT_I * sid) : MAT_MATTE;
  const float* mf = S.MATF + MAT_F * (valid ? sid : 0);
  // trainable exponents: the per-call table, read on plastic rows only
  float exponent = texp ? ((valid && mk == MAT_PLASTIC) ? S.ldf(S.exponent + sid) : 0.f)
                        : ((S.static_exp || !valid) ? 0.f : S.ldf(mf));
  float eta = S.has_glass ? (valid ? S.ldf(mf + 1) : 0.f) : 1.0f;
  V diffuse = (valid && mk != MAT_MIRROR) ? S.ld3f(S.diffuse + 3 * sid) : zero3;
  // a textured row's diffuse is its texture's value at the hit
  int trec = -1;
  bool tex_even = false, tex_img = false;
  float tex_x = 0.f, tex_y = 0.f;
  Taps taps;
  if (TEX && valid) {
    trec = S.ldi(S.MATI + MAT_I * sid + 2);
    if (trec >= 0) {
      const int* ti = S.TXI + TX_I * trec;
      tex_img = S.ldi(ti) != 0;
      if (tex_img) {
        image_xy(S, trec, hp, tex_x, tex_y);
        diffuse = image_lookup(S, trec, tex_x, tex_y, a.timg, taps);
      } else {
        tex_even = checker_even(S, trec, hp);
        diffuse = S.ld3f((tex_even ? S.texa : S.texb) + 3 * S.ldi(ti + 1));
      }
    }
  }
  V specular = (valid && mk != MAT_MATTE) ? S.ld3f(S.specular + 3 * sid) : zero3;
  bool is_matte = mk == MAT_MATTE, is_mirror = mk == MAT_MIRROR;
  bool is_glass = mk == MAT_GLASS, is_plastic = mk == MAT_PLASTIC;
  int plastic_kind = LAMBERT;
  V plastic_col = diffuse;
  bool lobe_is_phong = false;
  float lobe_scale = 1.0f;
  if (S.has_plastic) {
    float u_lobe = rng.uniform();
    float s_prob = valid ? S.ldf(mf + 3) : 0.f;
    float d_prob = valid ? S.ldf(mf + 2) : 0.f;
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
      acc_add3(acc, 3 + 3 * light, add);
    } else {
      const int lrow = S.ldi(S.LTI + LT_I * light + 2);
      if (lrow >= 0)
        acc_add3(acc, col_e + 3 * lrow, add);
      else if (S.ldi(S.LTI + LT_I * light) == L_ENV)
        acc_add3(acc, col_env, add);
    }
    const V addc = (gb * S.ld3f(S.light_emit + 3 * light)) * bp;
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
    uint32_t c = L.tile_seed + ((uint32_t)(bounce * 668265263u) & 0x7fffffffu);
    c ^= c >> 16;
    c *= 0x85EBCA6Bu;
    c ^= c >> 13;
    if (a.sampler != S_RANDOM) c += L.si0;
    int pick = (int)((c & 0x7fffffffu) % (uint32_t)S.L);
    if (S.L <= PICK_LIGHTS)
      pick_bits = pick << RESI_PICK_SHIFT;
    else if (MODE == MODE_RESIDUAL)
      a.resi[(size_t)(a.max_depth + 1 + bounce) * n + lane_id] = pick;
    int lkind = S.ldi(S.LTI + LT_I * pick);
    float cphi = 0.f, sphi = 0.f;
    if (lkind == L_SPHERE || lkind == L_ENV) {
      cphi = cosf(TWO_PI_F * u2);
      sphi = sin_from_phi_cos(cphi, u2);
    }
    LSample sm = light_sample(S, pick, hp, nrm, u1, u2, cphi, sphi);
    V emit_l = S.ld3f(S.light_emit + 3 * pick);
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
    for (int i0 = 0; i0 < S.L; i0 += R.chunk) {
      const int nk = min(R.chunk, S.L - i0);
      // 1. sample each light of the chunk: its shadow ray and its weights
      uint32_t live = 0;
      for (int k = 0; k < nk; ++k) {
        const int i = i0 + k;
        LSample sm = light_sample(S, i, hp, nrm, u1, u2, cphi, sphi);
        float nd = vdot(nrm, sm.wi);
        float cos_aw = has_phong ? vdot(wr_w, sm.wi) : 0.f;
        float pdf_b, f_unit;
        eval_dots(S, kind, exponent, wo_l.z, nd, cos_aw, pdf_b, f_unit);
        float ucos = f_unit * fabsf(nd);
        int lkind = S.ldi(S.LTI + LT_I * i);
        float w = (lkind == L_POINT || lkind == L_DIRECTION) ? 1.0f / sm.pdf
                                                             : 1.0f / (sm.pdf + pdf_b);
        float tmax = sm.dist - SHADOW_EPS;
        if (a.robust) tmax = tmax - (nd < 0.f ? -OFF : OFF) * nd;
        if (nee_base && sm.pdf > 0.f) live |= 1u << k;
        R.at(R.WX, k) = sm.wi.x;
        R.at(R.WY, k) = sm.wi.y;
        R.at(R.WZ, k) = sm.wi.z;
        R.at(R.TMAX, k) = tmax;
        R.at(R.ND, k) = nd;
        R.at(R.VAL, k) = sm.li_s * ucos;
        R.at(R.WGT, k) = w;
      }
      // 2. one sweep of the rows for every live ray
      const uint32_t clear = shadow_sweep(S, hp, nrm, R, live, i0);
      // 3. accumulate in light order
      for (int k = 0; k < nk; ++k) {
        const int i = i0 + k;
        float okf = (clear >> k & 1u) ? R.at(R.WGT, k) * 1.0f : 0.f;
        float bp = (R.at(R.VAL, k) * okf) * lobe_scale;
        ld = ld + (col_nee * S.ld3f(S.light_emit + 3 * i)) * bp;
        const float kap = (MODE != MODE_FWD && texp)
                              ? kappa_dot(exponent, has_phong ? vdot(wr_w, R.wi(k)) : 0.f)
                              : 0.f;
        if (MODE == MODE_RESIDUAL) {
          put(rp.B(bounce, i), bp);
          if (texp) put(rp.Bk(bounce, i), lobe_is_phong ? bp * kap : 0.f);
        }
        if (MODE == MODE_REPLAY) nee_adjoint(i, bp, kap);
      }
    }
  }
  L.Lr = L.Lr + beta * ld;
  e_term = e_term + ld;

  // ---- extension sample ----
  float u1, u2;
  rng.uniform2(u1, u2);
  V f_s, wi_l;
  float pdf_s, f_unit_s;
  bool delta_s, refract;
  bsdf_sample(S, kind, color, diffuse, eta, exponent, wo_l, u1, u2, f_s, wi_l, pdf_s, delta_s,
              f_unit_s, refract);
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
      const V r_next = alive_n ? vmk(safe_div(L.r_tail.x - e_term.x, t_eff.x),
                                     safe_div(L.r_tail.y - e_term.y, t_eff.y),
                                     safe_div(L.r_tail.z - e_term.z, t_eff.z))
                               : zero3;
      const V addt = (gb * r_next) * tu_plane;
      addc_spec = addc_spec + (to_spec_t ? addt : zero3);
      addc_diff = addc_diff + (to_spec_t ? zero3 : addt);
      if (texp) addx = addx + (lobe_is_phong ? vdot(addt, col_nee) * kap_s : 0.f);
      if (TEX) {
        // a textured row's diffuse adjoint goes to its texture
        const bool on_img = trec >= 0 && tex_img;
        if (trec >= 0 && !tex_img)
          acc_add3(acc, (tex_even ? col_ta : col_tb) + 3 * S.ldi(S.TXI + TX_I * trec + 1), addc_diff);
        if (S.has_img) {
          const bool sep = on_img && S.ldi(S.TXI + TX_I * trec + 5) != 0;
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
        if (texp) a.row_dout[(size_t)(p + 9) * n + lane_id] = (valid && mk == MAT_PLASTIC) ? addx : 0.f;
      } else {
        if (valid && mk != MAT_MIRROR) acc_add3(acc, col_d + 3 * sid, addc_diff);
        if (valid && mk != MAT_MATTE) acc_add3(acc, col_s + 3 * sid, addc_spec);
        if (texp && valid && mk == MAT_PLASTIC) {
          float* q = acc.at(col_x + sid);
          *q = *q + addx;
        }
      }
      L.r_tail = r_next;
    }
  }
  if (!alive_n) return true;
  L.o = offset_origin(hp, nrm, wi_w);
  L.d = wi_w;
  L.beta = beta_new;
  if (S.has_delta) L.spec_prev = delta_s;
  L.pdf_prev = pdf_s;
  L.hp_prev = hp;
  return false;
}

// After lane L's last bounce: K2 writes the bounces it never reached (and
// K4 their texel entries and row-tagged planes, tag 0); K1 and K2 write its
// radiance.
template <int MODE, bool TEX, bool ROWTAG, bool SH>
__device__ __forceinline__ void lane_finish(const Args& a, const KScene<SH>& S, const ResPlanes& rp,
                                            const Lane& L) {
  const int n = a.n, lane_id = L.id;
  if (MODE == MODE_RESIDUAL) {
    auto put = [&](int k, float v) { a.resf[(size_t)k * n + lane_id] = v; };
    for (int b = L.bounce; b <= a.max_depth; ++b) {
      put(rp.wb(b), 0.f);
      if (rp.env) put(rp.wenv(b), 0.f);
      if (b < a.max_depth) {
        for (int i = 0; i < rp.n_b; ++i) {
          put(rp.B(b, i), 0.f);
          if (rp.texp) put(rp.Bk(b, i), 0.f);
        }
        put(rp.tu(b), 0.f);
        if (rp.texp) put(rp.tuk(b), 0.f);
        if (rp.img) {
          put(rp.tx(b), 0.f);
          put(rp.ty(b), 0.f);
        }
      }
      a.resi[(size_t)b * n + lane_id] = 0;
      if (S.single && S.L > PICK_LIGHTS && b < a.max_depth)
        a.resi[(size_t)(a.max_depth + 1 + b) * n + lane_id] = 0;
    }
  }
  if (MODE == MODE_REPLAY && TEX && S.has_img) {
    for (int b = L.bounce; b < a.max_depth; ++b)
      for (int s = 0; s < 4; ++s) {
        const size_t j = 4 * (size_t)b + s;
        a.tex_tags[j * n + lane_id] = 0;
        a.tex_dout[(3 * j) * n + lane_id] = 0.f;
        a.tex_dout[(3 * j + 1) * n + lane_id] = 0.f;
        a.tex_dout[(3 * j + 2) * n + lane_id] = 0.f;
      }
  }
  if constexpr (MODE == MODE_REPLAY && ROWTAG) {
    const int PB = S.texp ? 10 : 9;
    for (int b = L.bounce; b <= a.max_depth; ++b) {
      const int planes = b < a.max_depth ? PB : 3;
      for (int k = 0; k < planes; ++k) a.row_dout[(size_t)(PB * b + k) * n + lane_id] = 0.f;
      a.row_tags[(size_t)b * n + lane_id] = 0;
    }
  }
  if (MODE != MODE_REPLAY) {
    a.out[3 * (size_t)lane_id] = L.Lr.x;
    a.out[3 * (size_t)lane_id + 1] = L.Lr.y;
    a.out[3 * (size_t)lane_id + 2] = L.Lr.z;
  }
}

// ---- the kernels -------------------------------------------------------------

// the words a launch stages (wavefront.py SceneTables.stage_bytes / 4):
// pack_tables' f and i, diffuse, specular, emission (3M each), exponent
// (M), light_emit (3 max(L, 1)), env (3) and, textured, texa and texb (3
// max(T, 1) each)
template <class T>
__device__ __forceinline__ void stage_copy(T* dst, const T* src, int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = __ldg(src + k);
}

// The block's view of the scene: under SH its tables copied into `smem` once
// (every thread of the block must call it), else the tables in device memory.
template <bool SH, bool TEX>
__device__ __forceinline__ KScene<SH> stage_scene(const Args& a, float* smem) {
  KScene<SH> S;
  if constexpr (!SH) {
    S.init(a.F, a.I);
    S.diffuse = a.diffuse; S.specular = a.specular; S.emission = a.emission;
    S.exponent = a.exponent; S.light_emit = a.light_emit; S.env = a.env;
    S.texa = a.texa; S.texb = a.texb;
  } else {
    const int* I = a.I;
    const int n_pl = __ldg(I), n_sp = __ldg(I + 1), M = __ldg(I + H_M), L = __ldg(I + H_L),
              n_trec = __ldg(I + H_TREC), n_tex = __ldg(I + H_TEX);
    const int nf = HDR_F + PL_F * n_pl + SP_F * n_sp + MAT_F * M + LT_F * L + TX_F * n_trec;
    const int words = (L + MASK_LIGHTS - 1) / MASK_LIGHTS;  // skip words a row
    const int ni = HDR_I + PL_I * n_pl + SP_I * n_sp + MAT_I * M + LT_I * L + TX_I * n_trec +
                   (words > 1 ? (words - 1) * (n_pl + n_sp) : 0);
    const int nl = 3 * (L > 1 ? L : 1), nt = 3 * (n_tex > 1 ? n_tex : 1);
    float* p = smem;
    auto take = [&](const float* src, int cnt) {
      float* at = p;
      stage_copy(at, src, cnt);
      p += cnt;
      return (const float*)at;
    };
    const float* F = take(a.F, nf);
    int* Is = (int*)p;
    stage_copy(Is, I, ni);
    p += ni;
    S.diffuse = take(a.diffuse, 3 * M);
    S.specular = take(a.specular, 3 * M);
    S.emission = take(a.emission, 3 * M);
    S.exponent = take(a.exponent, M);
    S.light_emit = take(a.light_emit, nl);
    S.env = take(a.env, 3);
    if (TEX) {
      S.texa = take(a.texa, nt);
      S.texb = take(a.texb, nt);
    } else {
      S.texa = S.texb = nullptr;
    }
    __syncthreads();
    S.init(F, Is);
  }
  return S;
}

// Each warp traces its chunk of lanes [base, base + a.chunk), a slot taking
// the next lane in order when its lane ends (step 3); K4 adds each lane's
// adjoints to its slot's row `acc`.
template <int MODE, bool SOBOL, bool TEX, bool ROWTAG, bool SH, class A>
__device__ __forceinline__ void trace_chunk(const Args& a, const KScene<SH>& S,
                                            const ResPlanes& rp, const ShadowRays& R, A acc) {
  // acc: K4's view of this slot's row
  const int slot = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long base = (long long)warp * a.chunk;
  const long long end = min(base + a.chunk, (long long)a.n);
  long long next = base + 32;  // the chunk's next lane to hand out
  Lane L;
  bool active = base + slot < end;
  if (active) lane_start<MODE, SOBOL>(a, (int)(base + slot), L);
  while (__any_sync(0xffffffffu, active)) {
    bool done = false;
    if (active) {
      done = lane_bounce<MODE, SOBOL, TEX, ROWTAG, SH>(a, S, rp, R, L, acc);
      if (done) lane_finish<MODE, TEX, ROWTAG, SH>(a, S, rp, L);
    }
    const uint32_t ended = __ballot_sync(0xffffffffu, done);
    if (done) {
      const long long id = next + __popc(ended & ((1u << slot) - 1u));
      active = id < end;
      if (active) lane_start<MODE, SOBOL>(a, (int)id, L);
    }
    next += __popc(ended);
  }
}

// K1, K2 and K4. K4 (MODE_REPLAY): each slot's row is zeroed, takes the
// adjoints of every lane the slot traces, and the block's rows are summed by
// column into the partials table (lane_sum.cuh); ACC (an AccRoute): each
// row a local array, or a column of the block's accumulator in dynamic
// shared memory or in device memory (a row past the local array).
template <int MODE, bool SOBOL, bool TEX, bool ROWTAG, bool SH, int ACC>
__global__ void __launch_bounds__(threads_of<MODE>(), min_blocks_of<MODE>())
    wavefront_fwd_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  const KScene<SH> S = stage_scene<SH, TEX>(a, (float*)smem4);
  const ResPlanes rp = res_planes(S.env_i >= 0, S.single, S.L, S.texp, TEX && S.has_img);
  float* rays = (float*)smem4 + a.stage_words;
  const ShadowRays R{rays + threadIdx.x, a.nee_rays};
  if constexpr (MODE != MODE_REPLAY) {
    trace_chunk<MODE, SOBOL, TEX, ROWTAG, SH>(a, S, rp, R, RowAcc{nullptr, nullptr});
  } else if constexpr (ACC != ACC_LOCAL) {
    float* cols = ACC == ACC_SHARED ? rays + ShadowRays::FIELDS * a.nee_rays * RAY_STRIDE
                                    : a.wide + (size_t)blockIdx.x * a.n_cols * RAY_STRIDE;
    for (int k = 0; k < a.n_cols; ++k) cols[k * RAY_STRIDE + threadIdx.x] = 0.f;
    trace_chunk<MODE, SOBOL, TEX, ROWTAG, SH>(a, S, rp, R,
                                              ColAcc{cols + threadIdx.x, a.cmap});
    block_col_sums(cols, a.n_cols, a.partial, a.n_blocks);
  } else {
    float row[ROWTAG ? ROW_COLS : MAX_ROW];
    for (int k = 0; k < a.n_cols; ++k) row[k] = 0.f;
    trace_chunk<MODE, SOBOL, TEX, ROWTAG, SH>(a, S, rp, R, RowAcc{row, a.cmap});
    block_row_sums(row, a.n_cols, a.partial, a.n_blocks);
  }
}

constexpr int MAX_DEVICES = 64;

// SMs of device dev
int sm_count(int dev) {
  static int sms[MAX_DEVICES] = {};
  if (dev < MAX_DEVICES && sms[dev]) return sms[dev];
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 132;
  if (dev < MAX_DEVICES) sms[dev] = v;
  return v;
}

// The lanes a warp owns, a multiple of 32: as many as spread n lanes over
// MIN_WAVES waves of the warps the SMs hold (`per_sm` blocks each), at most
// 32 * REFILL, and 32 (one lane a thread) without refill
int refill_chunk(long long n, int per_sm, int sms, int threads, bool refill) {
  if (!refill) return 32;
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms * (threads / 32);
  long long chunk = (n + resident * MIN_WAVES - 1) / (resident * MIN_WAVES);
  chunk = (chunk + 31) / 32 * 32;
  return (int)(chunk < 32 ? 32 : chunk > 32 * REFILL ? 32 * REFILL : chunk);
}

// Kernel k's dynamic shared-memory limit set to smem on device dev, and
// the blocks of it an SM holds -> per_sm; `Cache` keeps both for the last
// smem asked on each device, one per kernel, so that a run of launches of
// one scene pays for the two runtime calls once.
struct Cache {
  int smem[MAX_DEVICES], per_sm[MAX_DEVICES];
  bool known[MAX_DEVICES];
};

template <class K>
cudaError_t prepare(Cache& c, K k, int dev, int threads, int smem, int& per_sm) {
  if (dev < MAX_DEVICES && c.known[dev] && c.smem[dev] == smem) {
    per_sm = c.per_sm[dev];
    return cudaSuccess;
  }
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, threads, smem);
  if (err == cudaSuccess && dev < MAX_DEVICES) {
    c.known[dev] = true;
    c.smem[dev] = smem;
    c.per_sm[dev] = per_sm;
  }
  return err;
}

// dynamic shared memory: the staged tables, then the shadow rays' block,
// then (K4 on a shared-memory route) the accumulator's. chunk_only: set
// a.chunk and a.n_blocks and launch nothing.
template <int MODE, bool TEX, bool ROWTAG, bool SH, int ACC>
cudaError_t launch_kernel(Args& a, bool chunk_only, void* stream) {
  static Cache cache[2];  // this instantiation's kernels: sobol or not
  const bool sobol = a.sampler == S_SOBOL;
  auto k = sobol ? wavefront_fwd_kernel<MODE, true, TEX, ROWTAG, SH, ACC>
                 : wavefront_fwd_kernel<MODE, false, TEX, ROWTAG, SH, ACC>;
  constexpr int threads = threads_of<MODE>();
  const long long words = (long long)a.stage_words + ShadowRays::FIELDS * a.nee_rays * threads +
                          (ACC == ACC_SHARED ? (long long)a.n_cols * threads : 0);
  if (4 * words > MAX_SMEM) return cudaErrorInvalidValue;
  const int smem = (int)(4 * words);
  int dev = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (MODE == MODE_REPLAY) {
    // K4's chunk from its launch bound, not its occupancy: the same on both
    // accumulator routes (step 3)
    per_sm = min_blocks_of<MODE>();
  } else {
    err = prepare(cache[sobol], k, dev, threads, smem, per_sm);
    if (err != cudaSuccess) return err;
  }
  a.chunk = refill_chunk(a.n, per_sm, sm_count(dev), threads, a.refill != 0);
  const long long warps = ((long long)a.n + a.chunk - 1) / a.chunk;
  int blocks = (int)((warps + threads / 32 - 1) / (threads / 32));
  // K4 launches one block at least, which writes the partials of no lanes
  if (MODE == MODE_REPLAY && blocks < 1) blocks = 1;
  if (chunk_only) {
    a.n_blocks = blocks;
    return cudaSuccess;
  }
  if (MODE == MODE_REPLAY) {
    if (a.n_blocks != blocks) return cudaErrorInvalidValue;
    err = prepare(cache[sobol], k, dev, threads, smem, per_sm);
    if (err != cudaSuccess) return err;
    k<<<blocks, threads, smem, (cudaStream_t)stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return (cudaError_t)sum_cols(a.partial, a.out, a.n_blocks, a.cmap,
                                 a.row_tags ? a.n_cols : a.n_cols - 1, a.n_out,
                                 (cudaStream_t)stream);
  }
  if (blocks > 0) k<<<blocks, threads, smem, (cudaStream_t)stream>>>(a);
  return cudaSuccess;
}

template <int MODE, bool TEX, bool ROWTAG, int ACC>
cudaError_t launch_acc(Args& a, bool chunk_only, void* stream) {
  if (a.stage_words > 0) return launch_kernel<MODE, TEX, ROWTAG, true, ACC>(a, chunk_only, stream);
  return launch_kernel<MODE, TEX, ROWTAG, false, ACC>(a, chunk_only, stream);
}

// K4's rows on a.acc_route (the row-tagged K4: local or device); K1 and K2
// have none
template <int MODE, bool TEX, bool ROWTAG>
cudaError_t launch_route(Args& a, bool chunk_only, void* stream) {
  if constexpr (MODE == MODE_REPLAY && !ROWTAG)
    if (a.acc_route == ACC_SHARED) return launch_acc<MODE, TEX, ROWTAG, ACC_SHARED>(a, chunk_only, stream);
  if constexpr (MODE == MODE_REPLAY)
    if (a.acc_route == ACC_DEVICE) return launch_acc<MODE, TEX, ROWTAG, ACC_DEVICE>(a, chunk_only, stream);
  return launch_acc<MODE, TEX, ROWTAG, ACC_LOCAL>(a, chunk_only, stream);
}

// textured: the scene has texture records (texa, texb and timg are then its
// tables, and K4 writes texel entries where it has image textures); K4
// writes row-tagged planes where a.row_tags is given; stage_bytes: the
// tables' bytes to stage in shared memory, 0 to read them from device
// memory; nee_rays: min(L, NEE_CHUNK), 0 under nee="single"; refill: slots
// refill with the chunk's next lanes; chunk_only: set a.chunk and
// a.n_blocks and launch nothing
template <int MODE>
int launch(Args& a, int textured, int stage_bytes, int nee_rays, int refill, void* stream,
           bool chunk_only = false) {
  if (a.sampler == S_SOBOL) {
    if (a.max_depth > MAX_SOBOL_DEPTH) return (int)cudaErrorInvalidValue;
    cudaError_t err = upload_sites();
    if (err != cudaSuccess) return (int)err;
  }
  if (stage_bytes < 0 || stage_bytes > STAGE_BUDGET || stage_bytes % 4 || nee_rays < 0 ||
      nee_rays > NEE_CHUNK)
    return (int)cudaErrorInvalidValue;
  a.stage_words = stage_bytes / 4;
  a.nee_rays = nee_rays;
  a.refill = refill;
  if (MODE != MODE_REPLAY && a.n == 0 && !chunk_only) return (int)cudaSuccess;
  cudaError_t err = cudaSuccess;
  if (MODE == MODE_REPLAY && a.row_tags != nullptr) {
    if constexpr (MODE == MODE_REPLAY)
      err = textured ? launch_route<MODE, true, true>(a, chunk_only, stream)
                     : launch_route<MODE, false, true>(a, chunk_only, stream);
  } else {
    err = textured ? launch_route<MODE, true, false>(a, chunk_only, stream)
                   : launch_route<MODE, false, false>(a, chunk_only, stream);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream` (PyTorch's current stream); they return cudaGetLastError()
// (or cudaErrorInvalidValue for what the kernel does not take). Tables:
// F, I (pack_tables), the (M, 3) diffuse/specular/emission, the (M,)
// exponent, the (max(L, 1), 3) light emissions, the (3,) env and the
// texture tables texa, texb (T, 3) and timg (texels, 3) (one zero row each
// in an untextured scene; textured: the scene has texture records); lanes:
// o, d (n, 3), si and pix (n,) int32 (null under the "random" sampler).
// sampler: 0 random, 1 hash, 2 sobol. stage_bytes: the bytes of the tables
// a block stages in shared memory (SceneTables.stage_bytes), at most
// STAGE_BUDGET, or 0 to read them from device memory; nee_rays: the
// shadow rays a chunk of the nee="all" light loop holds, min(L, NEE_CHUNK)
// (0 under nee="single"); refill: K1 and K2 refill the slots of dead lanes
// (wavefront.py REFILL_MAX_ROWS).
// K1: radiance only.
extern "C" int kytpu_wavefront_fwd(const float* F, const int* I, const float* diffuse,
                                   const float* specular, const float* emission,
                                   const float* exponent, const float* light_emit,
                                   const float* env, const float* texa, const float* texb,
                                   const float* timg, const float* o, const float* d,
                                   const int* si, const int* pix, float* out, int n, int seed,
                                   int max_depth, int rr_start, int rows, int sampler,
                                   int robust, int textured, int stage_bytes, int nee_rays,
                                   int refill, void* stream) {
  Args a{F, I, diffuse, specular, emission, exponent, light_emit, env, o, d, si, pix,
         out, nullptr, nullptr, nullptr, nullptr, nullptr,
         n, 0, 0, seed, max_depth, rr_start, rows, sampler, robust,
         texa, texb, timg, nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 0, 0, 0};
  return launch<MODE_FWD>(a, textured, stage_bytes, nee_rays, refill, stream);
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
                                       int stage_bytes, int nee_rays, int refill,
                                       void* stream) {
  Args a{F, I, diffuse, specular, emission, exponent, light_emit, env, o, d, si, pix,
         out, resf, resi, nullptr, nullptr, nullptr,
         n, 0, 0, seed, max_depth, rr_start, rows, sampler, robust,
         texa, texb, timg, nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 0, 0, 0};
  return launch<MODE_RESIDUAL>(a, textured, stage_bytes, nee_rays, refill, stream);
}

// K4: the table adjoints of upstream gradient g (n, 3) on the lanes whose
// forward radiance is big_l (n, 3), as one (n_out,) vector dd | ds | de |
// denv [| dexp] [| dta | dtb] in `out`, through the column-major (n_cols,
// n_blocks) scratch `partial` (n_blocks: kytpu_wavefront_chunk's, the
// launch's blocks); where the scene has image textures, the texel entries
// tex_dout (12 max_depth, n) and their tags tex_tags (4 max_depth, n):
// slot s of bounce b is entry plane 4b + s. A row: n_cols columns, the
// gradient vector's column c at column cmap[c] (wavefront.py acc_map), and
// on the dense route a last one that no lane adds to;
// acc_route (an AccRoute): the dense rows in local memory, or as columns of
// the block's accumulator in shared memory after the tables and the shadow
// rays (n_cols * 512 bytes a block), or, for a row past the local array,
// that accumulator in the device-memory scratch `wide` (n_cols * 128 floats
// a block; ACC_DEVICE). Past DENSE_MAX_ROWS surfaces (row_tags not null;
// local or device rows) `out` holds denv | each light's
// emission | dta | dtb, and the hit rows' adjoints are row_dout ((PB
// max_depth + 3), n) with their tags row_tags (max_depth + 1, n), as K8
// writes them.
extern "C" int kytpu_wavefront_bwd_replay(const float* F, const int* I, const float* diffuse,
                                          const float* specular, const float* emission,
                                          const float* exponent, const float* light_emit,
                                          const float* env, const float* texa,
                                          const float* texb, const float* timg, const float* o,
                                          const float* d, const int* si, const int* pix,
                                          const float* g, const float* big_l, float* partial,
                                          float* wide, float* out, float* tex_dout, int* tex_tags,
                                          float* row_dout, int* row_tags, const int* cmap, int n,
                                          int n_cols, int n_out,
                                          int seed, int max_depth, int rr_start, int rows,
                                          int sampler, int robust, int textured,
                                          int stage_bytes, int nee_rays, int refill,
                                          int acc_route, int n_blocks, void* stream) {
  if ((acc_route == ACC_LOCAL && n_cols > (row_tags ? ROW_COLS : MAX_ROW)) ||
      acc_route < ACC_LOCAL || acc_route > ACC_DEVICE ||
      (acc_route == ACC_SHARED && row_tags) || (acc_route == ACC_DEVICE && !wide))
    return (int)cudaErrorInvalidValue;
  Args a{F, I, diffuse, specular, emission, exponent, light_emit, env, o, d, si, pix,
         out, nullptr, nullptr, g, big_l, partial,
         n, n_cols, n_out, seed, max_depth, rr_start, rows, sampler, robust,
         texa, texb, timg, tex_dout, tex_tags, row_dout, row_tags, 0, 0, 0, 0,
         acc_route, n_blocks, cmap, wide};
  return launch<MODE_REPLAY>(a, textured, stage_bytes, nee_rays, refill, stream);
}

// The lanes a warp of K1 (mode 0), K2 (1) or K4 (2) owns in a launch of n
// lanes with these arguments on the current device, or -1 with a CUDA
// error (K4's launch has max(1, ceil(n / (4 * chunk))) blocks). Nothing is
// launched.
extern "C" int kytpu_wavefront_chunk(int mode, int n, int sampler, int textured, int stage_bytes,
                                     int nee_rays, int refill) {
  Args a{};
  a.n = n;
  a.sampler = sampler;
  const int err =
      mode == 2 ? launch<MODE_REPLAY>(a, textured, stage_bytes, nee_rays, refill, nullptr, true)
      : mode == 1
          ? launch<MODE_RESIDUAL>(a, textured, stage_bytes, nee_rays, refill, nullptr, true)
          : launch<MODE_FWD>(a, textured, stage_bytes, nee_rays, refill, nullptr, true);
  return err ? -1 : a.chunk;
}
