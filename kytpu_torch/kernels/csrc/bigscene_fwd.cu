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
// bigscene_fwd_kernel<MODE, SOBOL, TEX>, as K1, K2 and K4 are: K6 adds stores and
// K8 adjoint terms and nothing else, so their draws, hits and branches are
// K5's by construction. Their plain PyTorch transcription is
// kytpu_torch/kernels/bigscene.py::_trace_plain (trace_lanes_plain,
// bwd_replay_plain); this file follows it statement by statement, and
// chip_smoke.py holds the two against each other. The light sampling,
// BSDFs, RNG and vector maths are K1's (megakernel.cuh), reading a header
// and light records packed as K1's are.
//
// Design (PR 8's redesign; PERF.md has each step's times). One thread
// runs one lane's whole path (128 threads a block), lanes in pixel order;
// the path state lives in registers. The geometry is one table per shape
// class (tri, rect: 12 floats a row; disk: 8; sphere: 4), rows in Morton
// order, read through __ldg: every lane of a warp reads the same row at the
// same step, so each read is one broadcast. The closest-hit sweep carries
// only (t, class, table row); the material is gathered by the hit's global
// row after the sweep. Every random draw is a stateless hash of (key, lane,
// draw counter), as in K1.
//
// 1. The tree walk, each lane alone, on every sweep. Each class's rows come
//    in blocks of 8 (kbs.extract_tables sorts them by Morton code), each
//    block has a bounding sphere, padded so that no row test's rounding can
//    reach past it (kbs.cull_bounds; each lane adds CULL_PAD of its
//    origin's size, `cull_slack`; both tests are megakernel.cuh's, which K1,
//    K2 and K4 cull with past REFILL_MAX_ROWS surfaces), and above the
//    blocks an implicit tree of TREE_ARITY children a node holds, class by
//    class, each node a padded sphere around its children's, laid out
//    depth first with a skip link an entry (kbs.tree_bounds). Each lane
//    walks the trees alone and stacklessly, in table order (`walk`): at an
//    entry it tests its own ray over [0, t_best] (closest hit), or each of
//    its open shadow rays over [0, tmax] from the offset origin
//    (occlusion), against the entry's sphere, and goes on to the next entry
//    (the first child, or after a block the next one) where it meets it,
//    else to the entry's skip, past its subtree. There is no vote
//    on a bound: a lane pays for its own path and not for the union of its
//    warp's, and lanes that share a path read the same address (a
//    broadcast), so coherent and incoherent rays take the one path. The
//    warp runs the walk in the while-while form of Aila and Laine (HPG
//    2009) with their speculative traversal: node steps while some lane
//    has no block pending, each lane with room for one more of LEAF_BUF
//    pending blocks stepping on, then a leaf phase in which each lane
//    tests its own first pending block's rows (a gather). A lane whose ray
//    is not finite passes every node.
//    The rows are visited in table order and a skipped node holds no row
//    the lane would have taken, so the results are those of the full sweep
//    to the last bit; cull = 0 (cfg.cull="off") passes every node. kytpu
//    culls per tile with a ray cone, and only where its rays are coherent;
//    a per-lane test does not fall apart on incoherent rays, so here every
//    sweep is culled. The walk's votes need the lanes that reach
//    them: every thread of a warp stays in the bounce loop until the
//    warp's last lane ends (a finished lane with a false `live`), the
//    closest sweep's mask is the ballot of the live lanes, the occlusion
//    sweep's that of the lanes with a shadow ray, and a sweep's lanes leave
//    each class's walk together.
// 2. The shadow rays out of local memory. The lights are sampled, swept and
//    accumulated in chunks of min(L, NEE_CHUNK), as K1 does: each shadow
//    ray's direction, tmax, n.wi, NEE factors, 1 / |wi|^2 and cull slack
//    sit in this thread's column of a shared-memory block (`Rays`), and the
//    next bounce's hit pdf of a sphere light is recomputed from the previous
//    vertex (light_phit), which replaces a per-light array. A ray's
//    occlusion is a boolean and the sums keep light order: the bits do not
//    change.
// 3. The tree replaced flat superblocks of 8 blocks, which every sweep
//    tested all of before a warp entered, by vote, the superblocks and
//    blocks that any of its lanes met: on the sphereflake's first 64K
//    lanes 398.2 rows and 367.1 bound tests a lane-sweep, where the walk
//    takes 204.0 rows and 285.6 node steps of the warp (a lane's own walk
//    121.6 and 158.3; chip_smoke.swept_counts against vote_counts). Without
//    the speculation (one pending block) the warp's node steps rose past
//    the vote's tests, since its lanes reach their blocks at different
//    depths; at TREE_ARITY 8 or 2 a lane takes more node steps than at 4.
//    Both walks read the tables through L1; the walk's rows and nodes are
//    gathers, so the rows are read 16 bytes at a time.
//
// What bounds K5 on the H100: FP32 issue of the sweeps (about 25-35
// operations per row and ray, a similar count per block test), against a
// few bytes a lane of memory traffic (24 B of ray in, 12 B of radiance out;
// the tables stay in L1/L2). K6 adds (res_n + max_depth + 1) * 4 bytes of
// cache stores a lane, plane-major (plane k of lane i at k * n + i). Built
// with --fmad=false and without fast math, so it rounds as the plain
// version does.
//
// K8 keeps K5's path state and adds g, the tail radiance and the bounce's
// colour adjoints. As K7 does, it writes each bounce's adjoints tagged with
// the row it hit (PB planes a bounce, dd ds de [dexp], then the horizon's
// de; the row tags in a (max_depth + 1, n) int plane, 0 for a miss or a
// bounce the lane does not reach), and its env and light-emission adjoints
// (3 + 3L columns, local memory; past ROW_LIGHTS lights or ROW_TEXTURES
// textures a column of the block's accumulator in device memory, WIDE) go
// through lane_sum.cuh's fixed-order block sums. The host then sorts the tags stably and runs K7's segment sums
// (bigscene_bwd_res.cu): no float atomics, the gradient repeats to the last
// bit. What bounds it: K5's FP32 issue plus the adjoint terms; its bytes
// are K5's plus g and L in and (PB * max_depth + 3) * 4 + (max_depth + 1) *
// 4 B a lane out.
//
// Textures (TEX, a compile-time switch: an untextured scene runs the
// TEX=false instantiation, which loads no texture field). As in kytpu's
// table kernel, a textured row is found by the hit's global row (tex_rec,
// an (M,) table of its own into K1's texture records, appended after the
// lights, read only under TEX): its diffuse is the checker colour of the
// hit's cell or the four-tap gather of texture.cuh in the select chain's
// addition order. K6 caches that diffuse in "dif", the
// checker parity in bit 22 of the int plane and the texel coordinates in
// "tx"/"ty"; K8 routes the row's diffuse adjoint to the texture (6 lane
// columns a checker, 4 texel-tagged entries a bounce for an atlas, summed
// by texel by the segment-sum kernel) and writes 0 to its row-tagged
// diffuse share. No atomics: the texture gradients repeat bit for bit.
//
// The rows swept (the counters kernel.<k>.rows, .sweeps and .bounds of
// utils/profiling.py, taken while the profiler records): on each sweep a
// thread takes part in (the closest hit of a live lane, the occlusion sweep
// of a lane with a shadow ray) it counts one sweep, its warp's node steps
// and, for each leaf phase, the rows of the largest block tested in it:
// the rows its warp tested for it; of those, the tri class's share
// (kernel.<k>.rows.tri, .bounds.tri: the rows and node steps of the walks
// of the tri tree). Where a.swept is not null the launch runs the kernel's
// counting instance (COUNT), whose warps sum the five counts at their exit
// and add them there once; an untraced launch passes null and runs the
// instance that holds no count.

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
  // textures: the checker colours, the atlas and each row's texture record
  // (-1: none); K8's texel entries
  const float *texa, *texb, *timg;
  const int* tex_rec;
  float* tex_dout;
  int* tex_tags;
  // step 1: each class's tree over its 8-row blocks, depth first, tri |
  // rect | disk | sphere: the entries' spheres (cx, cy, cz, padded r) and
  // links (skip, block), and whether to cull; step 2: the shadow rays a
  // chunk holds
  const float4* bnd;
  const int2* link;
  int cull, nee_rays;
  // K8 past its local row (LOCAL_COLS): the blocks' accumulators in device
  // memory, n_cols * THREADS floats a block; else null
  float* wide;
  // the rows swept, the lane-sweeps, the node steps and the tri class's
  // rows and node steps, added at each warp's exit; null: not counted
  unsigned long long* swept;
};

// a thread's count of the rows its warp's leaf phases tested, of its
// sweeps, of its warp's node steps, and of the rows and node steps of
// those in the tri tree; COUNT: a traced launch's instance (an untraced
// one keeps no count, and the compiler drops its fields)
template <bool COUNT>
struct Swept {
  uint32_t rows = 0, sweeps = 0, bounds = 0, tri_rows = 0, tri_bounds = 0;
};

// K8's local row: env, each light's emission [, the checker adjoints]
template <bool TEX>
constexpr int LOCAL_COLS = TEX ? ROW_COLS : 3 + 3 * ROW_LIGHTS;

// v to columns col .. col + 2 of a row in device memory (lane_sum.cuh)
__device__ __forceinline__ void add3(const WideAcc& acc, int col, V v) {
  acc[col] = acc[col] + v.x;
  acc[col + 1] = acc[col + 1] + v.y;
  acc[col + 2] = acc[col + 2] + v.z;
}

constexpr int PG = 12, DG = 8, SG = 4;  // columns of the class tables
// lights sampled, swept and accumulated together at most (step 2),
// NEE_CHUNK in wavefront.py
constexpr int NEE_CHUNK = 8;
constexpr int THREADS = 128;

// children of a tree node (kbs.ARITY)
constexpr int TREE_ARITY = 4;
// blocks a lane holds pending while it walks on (kbs.LEAF_BUF)
constexpr int LEAF_BUF = 4;
// blocks an SM at the least (__launch_bounds__): 64 registers a thread.
// The walk's state took the compiler's own choice to 128 registers and 4
// blocks an SM, where the sphereflake's K6 ran at 27.19 ms; 80, 64, 56 and
// 48 registers ran it at 24.23, 21.13, 20.90 and 21.35 ms (NVIDIA H100,
// 700 W), K5 and K8 likewise
constexpr int MIN_BLOCKS = 8;

__device__ __forceinline__ V xyz(float4 q) { return vmk(q.x, q.y, q.z); }

// the tree entries of a class of `rows` rows (kbs.tree_bounds): its blocks
// and the levels above them up to one root
__device__ __forceinline__ int tree_entries(int rows) {
  int n = blocks_of(rows), e = n;
  while (n > 1) {
    n = (n + TREE_ARITY - 1) / TREE_ARITY;
    e += n;
  }
  return e;
}

// the class tables' bases and their trees (step 1): each class's entries
// [start[c], start[c + 1]) of node (bounds) and link (skip, block),
// tri | rect | disk | sphere
struct Tables {
  const float *tri, *rect, *disk, *sph;
  const int *tri_r, *rect_r, *disk_r, *sph_r;
  const float4* node;
  const int2* link;
  int start[5];
  int n_tri, n_rect, n_disk, n_sph;
  bool cull;
  __device__ void init(const BigArgs& a) {
    n_tri = a.n_tri; n_rect = a.n_rect; n_disk = a.n_disk; n_sph = a.n_sph;
    cull = a.cull != 0;
    tri = a.geo;
    rect = tri + PG * n_tri;
    disk = rect + PG * n_rect;
    sph = disk + DG * n_disk;
    tri_r = a.rows;
    rect_r = tri_r + n_tri;
    disk_r = rect_r + n_rect;
    sph_r = disk_r + n_disk;
    node = a.bnd;
    link = a.link;
    start[0] = 0;
    start[1] = tree_entries(n_tri);
    start[2] = start[1] + tree_entries(n_rect);
    start[3] = start[2] + tree_entries(n_disk);
    start[4] = start[3] + tree_entries(n_sph);
  }
};

// One sweep of class c's tree by each lane of `mask` alone (step 1), in
// table order: at entry e a lane goes on to e + 1 where its rays meet the
// entry's sphere (its first child, or the next entry after a block) and
// to the entry's skip where they do not, until it passes the class's last
// entry. In the while-while form of Aila & Laine (HPG 2009) with their
// speculative traversal: node phases while some lane has no block
// pending, in which each lane with room for one more of LEAF_BUF pending
// blocks takes a step, then a leaf phase in which each lane with a pending
// block tests the first one's rows. meets(b, rays): whether the lane's
// rays can meet sphere b (true without the cull), and in rays which of
// them do; leaf(blk, rays): test block blk's rows for those rays ->
// whether the lane still looks for something; live: whether it does at
// the start; nr: the class's rows. The votes keep the warp together; under
// COUNT every lane adds the warp's node steps and the rows of its largest
// first pending block of each leaf phase (`Swept`), in the tri tree (c 0)
// to the tri counts too.
template <bool COUNT, class Meets, class Leaf>
__device__ __forceinline__ void walk(const Tables& T, int c, int nr, uint32_t mask, bool live,
                                     Swept<COUNT>& sw, Meets&& meets, Leaf&& leaf) {
  int e = T.start[c];
  const int end = T.start[c + 1];
  if (e == end) return;
  bool done = !live;  // past the last entry
  int buf[LEAF_BUF];
  uint32_t buf_rays[LEAF_BUF];
#pragma unroll
  for (int q = 0; q < LEAF_BUF; ++q) {
    buf[q] = -1;
    buf_rays[q] = 0;
  }
  for (;;) {
    while (__any_sync(mask, !done && buf[0] < 0)) {
      if constexpr (COUNT) {
        ++sw.bounds;
        if (c == 0) ++sw.tri_bounds;
      }
      if (!done && buf[LEAF_BUF - 1] < 0) {
        const int2 ln = __ldg(T.link + e);
        uint32_t rays = 0;
        const bool hit = meets(__ldg(T.node + e), rays);
        if (hit && ln.y >= 0) {
          bool put = false;
#pragma unroll
          for (int q = 0; q < LEAF_BUF; ++q)
            if (!put && buf[q] < 0) {
              buf[q] = ln.y;
              buf_rays[q] = rays;
              put = true;
            }
        }
        e = hit ? e + 1 : ln.x;
        done = e >= end;
      }
    }
    const bool any = __any_sync(mask, buf[0] >= 0);
    if constexpr (COUNT) {
      const int rows = buf[0] >= 0 ? min(nr, (buf[0] + 1) * BLOCK_ROWS) - buf[0] * BLOCK_ROWS : 0;
      const uint32_t most = __reduce_max_sync(mask, (uint32_t)rows);
      sw.rows += most;
      if (c == 0) sw.tri_rows += most;
    }
    if (!any) return;
    if (buf[0] >= 0) {
      const bool alive = leaf(buf[0], buf_rays[0]);
#pragma unroll
      for (int q = 0; q + 1 < LEAF_BUF; ++q) {
        buf[q] = alive ? buf[q + 1] : -1;
        buf_rays[q] = buf_rays[q + 1];
      }
      buf[LEAF_BUF - 1] = -1;
      done = done || !alive;
    }
  }
}

__device__ __forceinline__ bool planar_inside(float a, float b, bool tri) {
  if (tri) return a >= 0.f && b >= 0.f && a + b <= 1.0f;
  return a >= 0.f && a <= 1.0f && b >= 0.f && b <= 1.0f;
}

// K6's cache planes (bigscene.py::bigres_layout). Per bounce b: wb, [wenv],
// emi x3; below the horizon then L x (B [Bk]), tu [tuk], dif x3, spc x3,
// [tx, ty] (image scenes)
struct BigRes {
  int stride, env, L, texp, img;
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
  __device__ __forceinline__ int tx(int b) const { return tu(b) + 7 + texp; }
  __device__ __forceinline__ int ty(int b) const { return tx(b) + 1; }
};

constexpr int RES_PHONG = 1 << 20, RES_TO_SPEC = 1 << 21, RES_EVEN = 1 << 22;

// closest hit -> t, class (0 tri, 1 rect, 2 disk, 3 sphere; -1 on a miss)
// and table row; strict t < t_best, so the first of equal rows wins. Every
// lane of `mask` (the live lanes of the warp) calls it; each walks the
// classes' trees alone, skipping a node that its ray cannot meet over [0,
// t_best].
template <bool COUNT>
__device__ void closest_tables(const Tables& T, V o, V d, uint32_t mask, float& t_best, int& cls,
                               int& trow, Swept<COUNT>& sw) {
  ++sw.sweeps;
  t_best = __int_as_float(0x7f800000);
  cls = -1;
  trow = -1;
  float inv_dd = 0.f, slack = 0.f;
  if (T.cull) slack = cull_slack(o, d, inv_dd);
  auto meets = [&](float4 b, uint32_t&) {
    return !T.cull || block_meets(b, o, d, inv_dd, t_best, slack);
  };
  for (int k = 0; k < 2; ++k) {
    const float* tab = k == 0 ? T.tri : T.rect;
    const int nr = k == 0 ? T.n_tri : T.n_rect;
    walk(T, k, nr, mask, true, sw, meets, [&](int blk, uint32_t) {
      const int s1 = min(nr, (blk + 1) * BLOCK_ROWS);
      for (int s = blk * BLOCK_ROWS; s < s1; ++s) {
        // 16-byte loads: the lanes' blocks may differ
        const float4* P = (const float4*)(tab + PG * s);
        const float4 q0 = __ldg(P), q1 = __ldg(P + 1), q2 = __ldg(P + 2);
        const V n = xyz(q0);
        const float t = (q0.w - vdot(n, o)) / vdot(n, d);
        const V f1 = xyz(q1), f2 = xyz(q2);
        const float a = (vdot(f1, o) - q1.w) + t * vdot(f1, d);
        const float b = (vdot(f2, o) - q2.w) + t * vdot(f2, d);
        if (planar_inside(a, b, k == 0) && t > EPS && t < t_best) {
          t_best = t;
          cls = k;
          trow = s;
        }
      }
      return true;
    });
  }
  walk(T, 2, T.n_disk, mask, true, sw, meets, [&](int blk, uint32_t) {
    const int s1 = min(T.n_disk, (blk + 1) * BLOCK_ROWS);
    for (int s = blk * BLOCK_ROWS; s < s1; ++s) {
      const float4* P = (const float4*)(T.disk + DG * s);
      const float4 q0 = __ldg(P), q1 = __ldg(P + 1);
      const V n = xyz(q0);
      const float t = (q0.w - vdot(n, o)) / vdot(n, d);
      const V rel = (o + d * t) - xyz(q1);
      if (vdot(rel, rel) <= q1.w && t > EPS && t < t_best) {
        t_best = t;
        cls = 2;
        trow = s;
      }
    }
    return true;
  });
  walk(T, 3, T.n_sph, mask, true, sw, meets, [&](int blk, uint32_t) {
    const int s1 = min(T.n_sph, (blk + 1) * BLOCK_ROWS);
    for (int s = blk * BLOCK_ROWS; s < s1; ++s) {
      const float4 P = __ldg((const float4*)(T.sph + SG * s));
      const float r = P.w;
      const V oc = xyz(P) - o;
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
    return true;
  });
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

// The shadow rays of one vertex, lights i0 .. i0 + chunk - 1 (step 2): each
// leaves hp offset by se = +-OFF along n_shade (the sign of nd = n_shade .
// wi) up to tmax; val and wgt are its NEE factors, iww 1 / |wi|^2 and slk
// its cull slack. They live in this thread's column of a shared-memory
// block, field f of ray k at p[(k * FIELDS + f) * THREADS] (the block's
// threads side by side: no bank conflicts).
struct Rays {
  enum { WX, WY, WZ, TMAX, ND, VAL, WGT, IWW, SLK, FIELDS };
  float* p;
  int chunk;
  __device__ __forceinline__ float& at(int f, int k) const { return p[(k * FIELDS + f) * THREADS]; }
  __device__ __forceinline__ V wi(int k) const { return vmk(at(WX, k), at(WY, k), at(WZ, k)); }
  __device__ __forceinline__ float se(int k) const { return at(ND, k) < 0.f ? -OFF : OFF; }
};

// One occlusion sweep for the rays of R whose bit is set in `need` -> the
// bits of the blocked ones (bigscene.py::_occluded). The terms of (hp,
// n_shade) are shared by the rays. Every lane of `mask` (those with a ray
// to sweep) calls it; each walks the classes' trees alone, keeping at a
// node the mask of its open rays that can meet the node's bound, going
// down where that mask is not 0, testing a block's rows for the rays in it
// while they are open, and finishing once every ray is blocked.
// lti: under robust shadows the light records of the chunk's first light,
// whose field 2 is the emitting row that the light's ray skips (-1: none);
// else null.
template <bool COUNT>
__device__ uint32_t occluded_tables(const Tables& T, V hp, V ns, const Rays& R, uint32_t need,
                                    uint32_t mask, const int* lti, Swept<COUNT>& sw) {
  ++sw.sweeps;
  uint32_t open = need;
  // the open rays that can meet bound *b (all of them without the cull)
  auto meets = [&](float4 bb, uint32_t& test) {
    if (!T.cull) {
      test = open;
      return true;
    }
    test = 0;
    for (uint32_t q = open; q; q &= q - 1) {
      const int j = __ffs(q) - 1;
      if (block_meets(bb, hp + ns * R.se(j), R.wi(j), R.at(R.IWW, j), R.at(R.TMAX, j),
                      R.at(R.SLK, j)))
        test |= 1u << j;
    }
    return test != 0;
  };
  auto own_ok = [&](const int* rws, int s, int j) {
    const int own = lti ? __ldg(lti + LT_I * j + 2) : -1;
    return own < 0 || __ldg(rws + s) != own;
  };
  // the rows of block blk of a class for the rays in `test`, while open
  // -> whether a ray is still open
  auto planar_rows = [&](const float* tab, const int* rws, int nr, int blk, bool tri,
                         uint32_t test) {
    const int s1 = min(nr, (blk + 1) * BLOCK_ROWS);
    for (int s = blk * BLOCK_ROWS; s < s1 && (test & open); ++s) {
      const float4* P = (const float4*)(tab + PG * s);
      const float4 q0 = __ldg(P), q1 = __ldg(P + 1), q2 = __ldg(P + 2);
      const V n = xyz(q0), f1 = xyz(q1), f2 = xyz(q2);
      const float num_h = q0.w - vdot(n, hp);
      const float num_n = vdot(n, ns);
      const float a_h = vdot(f1, hp) - q1.w;
      const float a_n = vdot(f1, ns);
      const float b_h = vdot(f2, hp) - q2.w;
      const float b_n = vdot(f2, ns);
      for (uint32_t m = test & open; m; m &= m - 1) {
        const int j = __ffs(m) - 1;
        const V wi = R.wi(j);
        const float se = R.se(j);
        const float t = (num_h - se * num_n) / vdot(n, wi);
        const float a = (a_h + se * a_n) + t * vdot(f1, wi);
        const float b = (b_h + se * b_n) + t * vdot(f2, wi);
        if (planar_inside(a, b, tri) && t > EPS && t < R.at(R.TMAX, j) && own_ok(rws, s, j))
          open &= ~(1u << j);
      }
    }
    return open != 0;
  };
  walk(T, 0, T.n_tri, mask, open != 0, sw, meets, [&](int blk, uint32_t test) {
    return planar_rows(T.tri, T.tri_r, T.n_tri, blk, true, test);
  });
  walk(T, 1, T.n_rect, mask, open != 0, sw, meets, [&](int blk, uint32_t test) {
    return planar_rows(T.rect, T.rect_r, T.n_rect, blk, false, test);
  });
  walk(T, 2, T.n_disk, mask, open != 0, sw, meets, [&](int blk, uint32_t test) {
    const int s1 = min(T.n_disk, (blk + 1) * BLOCK_ROWS);
    for (int s = blk * BLOCK_ROWS; s < s1 && (test & open); ++s) {
      const float4* P = (const float4*)(T.disk + DG * s);
      const float4 q0 = __ldg(P), q1 = __ldg(P + 1);
      const V n = xyz(q0), p0 = xyz(q1);
      const float num_h = q0.w - vdot(n, hp);
      const float num_n = vdot(n, ns);
      const float r2 = q1.w;
      for (uint32_t m = test & open; m; m &= m - 1) {
        const int j = __ffs(m) - 1;
        const V wi = R.wi(j);
        const float se = R.se(j);
        const float t = (num_h - se * num_n) / vdot(n, wi);
        const V rel = ((hp + ns * se) + wi * t) - p0;
        if (vdot(rel, rel) <= r2 && t > EPS && t < R.at(R.TMAX, j) && own_ok(T.disk_r, s, j))
          open &= ~(1u << j);
      }
    }
    return open != 0;
  });
  walk(T, 3, T.n_sph, mask, open != 0, sw, meets, [&](int blk, uint32_t test) {
    const int s1 = min(T.n_sph, (blk + 1) * BLOCK_ROWS);
    for (int s = blk * BLOCK_ROWS; s < s1 && (test & open); ++s) {
      const float4 P = __ldg((const float4*)(T.sph + SG * s));
      const float rad = P.w;
      const V vc = xyz(P) - hp;
      const float vc2 = vdot(vc, vc);
      const float vcn = vdot(vc, ns);
      for (uint32_t m = test & open; m; m &= m - 1) {
        const int j = __ffs(m) - 1;
        const float se = R.se(j);
        const float neg_b = vdot(vc, R.wi(j)) - se * R.at(R.ND, j);
        const float oc2 = (vc2 - (2.0f * se) * vcn) + OFF2;
        const float discr = (rad * rad - oc2) + neg_b * neg_b;
        if (sphere_occludes(neg_b, discr, R.at(R.TMAX, j)) && rad > 0.f && own_ok(T.sph_r, s, j))
          open &= ~(1u << j);
      }
    }
    return open != 0;
  });
  return need & ~open;
}

enum Mode { MODE_FWD = 0, MODE_RESIDUAL = 1, MODE_REPLAY = 2 };

// One lane's path: MODE_FWD writes its radiance (K5), MODE_RESIDUAL also
// the coefficient cache (K6), MODE_REPLAY re-traces the same path with the
// same draws and writes its row-tagged adjoints, adding its env (0-2) and
// per-light emission (3 + 3i ..) adjoints to acc, then the checker ones
// (3 + 3L ..) (K8); acc: a local row (float*), or past it this thread's
// column of the block's accumulator in device memory (WideAcc). SOBOL and
// TEX are compile-time switches, as in K1.
// Every thread of the warp calls it (step 1: the sweeps' votes); `in`:
// lane_id < a.n, else the thread traces nothing and writes nothing.
template <int MODE, bool SOBOL, bool TEX, class ACC = float*, bool COUNT>
__device__ __forceinline__ void trace_lane(const BigArgs& a, const Scene& S, const Tables& T,
                                           const Rays& R, int lane_id, bool in, ACC acc,
                                           Swept<COUNT>& sw) {
  const int n = a.n;
  const int L = S.L;
  const bool texp = a.texp != 0;
  BigRes rp;
  rp.env = S.env_i >= 0 ? 1 : 0;
  rp.L = L;
  rp.texp = texp ? 1 : 0;
  rp.img = (TEX && S.has_img) ? 1 : 0;
  rp.stride = 11 + rp.env + L * (1 + rp.texp) + rp.texp + 2 * rp.img;
  auto put = [&](int k, float v) { a.resf[(size_t)k * n + lane_id] = v; };
  // K8: the checker columns, and texel entry (slot s of bounce b)
  const int col_ta = 3 + 3 * L, col_tb = col_ta + 3 * S.n_tex;
  auto tex_put = [&](int b, int s, int tag, V v) {
    const size_t j = 4 * (size_t)b + s;
    a.tex_tags[j * n + lane_id] = tag;
    a.tex_dout[(3 * j) * n + lane_id] = v.x;
    a.tex_dout[(3 * j + 1) * n + lane_id] = v.y;
    a.tex_dout[(3 * j + 2) * n + lane_id] = v.z;
  };
  // K8: adjoint plane k of this lane, PB planes a bounce below the horizon
  const int PB = texp ? 10 : 9;
  auto dput = [&](int k, float v) { a.dout[(size_t)k * n + lane_id] = v; };

  const int tile = a.rows_per_tile * 128;
  const int tile_id = lane_id / tile;
  const uint32_t tile_seed = (uint32_t)a.seed + (uint32_t)tile_id * (2654435761u & 0x7fffffffu);
  Rng rng;
  rng.ctr = 0;
  rng.sobol = SOBOL;
  if (a.sampler != S_RANDOM && in) {
    const uint32_t ph = pix_hash((uint32_t)a.pix[lane_id], (uint32_t)a.seed);
    const uint32_t si = (uint32_t)a.si[lane_id];
    rng.key = rng.sobol ? __brev(si) : pix_hash(si, ph);
    rng.mix = rng.sobol ? ph : 0u;
  } else {
    rng.key = tile_seed;
    rng.mix = (uint32_t)(lane_id - tile_id * tile) * 374761393u;
  }

  const V zero3 = vmk(0.f, 0.f, 0.f);
  V o = in ? ld3(a.o + 3 * (size_t)lane_id) : zero3;
  V d = in ? ld3(a.d + 3 * (size_t)lane_id) : zero3;
  V beta = vmk(1.f, 1.f, 1.f);
  V Lr = vmk(0.f, 0.f, 0.f);
  bool alive = true, spec_prev = false;
  float pdf_prev = 1.0f;
  V hp_prev = zero3;  // the previous vertex (light_phit)
  const bool has_phong = S.has_lobe(PHONG);
  int next_bounce = a.max_depth + 1;  // the first bounce this lane does not reach
  // K8: the upstream gradient and the tail radiance
  V g = zero3, r_tail = zero3;
  if (MODE == MODE_REPLAY && in) {
    g = ld3(a.g + 3 * (size_t)lane_id);
    r_tail = ld3(a.l_in + 3 * (size_t)lane_id);
  }

  // one bounce of a live lane -> whether the lane goes on; `mask`: the
  // warp's live lanes, which all run it
  auto step = [&](int bounce, uint32_t mask) -> bool {
    float t;
    int cls, trow, grow;
    V nrm;
    closest_tables(T, o, d, mask, t, cls, trow, sw);
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
        pdf_l_hit = li_idx >= 0 ? light_phit(S, li_idx, hp_prev) : 0.f;
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
      return false;
    }
    const bool cont = alive && valid;

    // material resolution
    const int mk = valid ? __ldg(a.mat_i + 2 * grow) : MAT_MATTE;
    const float exponent = valid ? __ldg(a.exponent + grow) : 0.f;
    const float eta = valid ? __ldg(a.mat_f + 4 * grow) : 0.f;
    V diffuse = valid ? ld3(a.diffuse + 3 * grow) : zero3;
    // a textured row's diffuse is its texture's value at the hit
    int trec = -1;
    bool tex_even = false, tex_img = false;
    float tex_x = 0.f, tex_y = 0.f;
    Taps taps;
    if (TEX && valid) {
      trec = __ldg(a.tex_rec + grow);
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

    // ---- NEE: every light, in chunks of R.chunk lights: sample, one
    // occlusion sweep for the chunk's shadow rays, accumulate in light
    // order (step 2) ----
    float u1, u2;
    rng.uniform2(u1, u2);
    float cphi = 0.f, sphi = 0.f;
    if (S.any_azim) {
      cphi = cosf(TWO_PI_F * u2);
      sphi = sin_from_phi_cos(cphi, u2);
    }
    V ld = zero3;
    // K8: this bounce's colour and exponent adjoints, all of its hit row
    V addc_diff = zero3, addc_spec = zero3;
    float addx = 0.f;
    for (int i0 = 0; i0 < L; i0 += R.chunk) {
      const int nk = min(R.chunk, L - i0);
      // each light's shadow ray and its NEE factors li_s * ucos and MIS
      // weight
      uint32_t want = 0;
      for (int k = 0; k < nk; ++k) {
        const int i = i0 + k;
        const LSample sm = light_sample(S, i, hp, nrm, u1, u2, cphi, sphi);
        const float nd = vdot(nrm, sm.wi);
        const float cos_aw = has_phong ? vdot(wr_w, sm.wi) : 0.f;
        float pdf_b, f_unit;
        eval_dots(S, kind, exponent, wo_l.z, nd, cos_aw, pdf_b, f_unit);
        const float ucos = f_unit * fabsf(nd);
        const int lkind = __ldg(S.LTI + LT_I * i);
        R.at(R.WGT, k) = (lkind == L_POINT || lkind == L_DIRECTION)
                             ? safe_div(1.0f, sm.pdf)
                             : safe_div(1.0f, sm.pdf + pdf_b);
        R.at(R.VAL, k) = sm.li_s * ucos;
        if (nee_base && sm.pdf > 0.f && sm.li_s != 0.f && ucos != 0.f) want |= 1u << k;
        const float se = nd < 0.f ? -OFF : OFF;
        float tmax = sm.dist - SHADOW_EPS;
        if (a.robust) tmax = tmax - se * nd;
        R.at(R.WX, k) = sm.wi.x;
        R.at(R.WY, k) = sm.wi.y;
        R.at(R.WZ, k) = sm.wi.z;
        R.at(R.TMAX, k) = tmax;
        R.at(R.ND, k) = nd;
        if (T.cull) {
          float iww;
          R.at(R.SLK, k) = cull_slack(hp + nrm * se, sm.wi, iww);
          R.at(R.IWW, k) = iww;
        }
      }
      const uint32_t omask = __ballot_sync(mask, want != 0);
      const uint32_t lit =
          want ? want & ~occluded_tables(T, hp, nrm, R, want, omask,
                                         a.robust ? S.LTI + LT_I * i0 : nullptr, sw)
               : 0u;
      for (int k = 0; k < nk; ++k) {
        const int i = i0 + k;
        const float okf = ((lit >> k) & 1u) ? R.at(R.WGT, k) : 0.f;
        const float bp = (R.at(R.VAL, k) * okf) * lobe_scale;
        const V emit_l = ld3(a.light_emit + 3 * i);
        ld = ld + (col_nee * emit_l) * bp;
        const float caw = has_phong ? vdot(wr_w, R.wi(k)) : 0.f;
        if (MODE == MODE_RESIDUAL) {
          put(rp.B(bounce, i), bp);
          if (texp) put(rp.Bk(bounce, i), lobe_is_phong ? bp * kappa_dot(exponent, caw) : 0.f);
        }
        if (MODE == MODE_REPLAY) {
          add3(acc, 3 + 3 * i, (gb * col_nee) * bp);
          const V addc = (gb * emit_l) * bp;
          addc_spec = addc_spec + (lobe_is_phong ? addc : zero3);
          addc_diff = addc_diff + (lobe_is_phong ? zero3 : addc);
          if (texp)
            addx = addx + (lobe_is_phong ? vdot(addc, col_nee) * kappa_dot(exponent, caw) : 0.f);
        }
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
      if (TEX) {
        // a textured row's diffuse adjoint goes to its texture
        const bool on_img = trec >= 0 && tex_img;
        if (trec >= 0 && !tex_img)
          add3(acc, (tex_even ? col_ta : col_tb) + 3 * __ldg(S.TXI + TX_I * trec + 1), addc_diff);
        if (S.has_img) {
          const bool sep = on_img && __ldg(S.TXI + TX_I * trec + 5) != 0;
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const bool ok_t = on_img && taps.t[s] >= 0;
            tex_put(bounce, s, ok_t ? taps.t[s] + 1 : 0,
                    ok_t ? vmk(texel_entry(taps, sep, s, addc_diff.x),
                               texel_entry(taps, sep, s, addc_diff.y),
                               texel_entry(taps, sep, s, addc_diff.z))
                         : zero3);
          }
        }
        if (trec >= 0) addc_diff = zero3;
      }
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
          (grow + 1) + (lobe_is_phong ? RES_PHONG : 0) + (to_spec ? RES_TO_SPEC : 0) +
          (trec >= 0 && !tex_img && tex_even ? RES_EVEN : 0);
      if (rp.img) {
        put(rp.tx(bounce), tex_img ? tex_x : 0.f);
        put(rp.ty(bounce), tex_img ? tex_y : 0.f);
      }
    }
    if (alive_n) {
      o = offset_origin(hp, nrm, wi_w);
      d = wi_w;
      beta = beta_new;
      if (S.has_delta) spec_prev = delta_s;
      pdf_prev = pdf_s;
      hp_prev = hp;
    }
    alive = alive_n;
    if (!alive) next_bounce = bounce + 1;
    return alive;
  };

  // the warp's threads stay in the loop until its last lane ends (step 1)
  bool live = in;
  for (int bounce = 0; bounce <= a.max_depth; ++bounce) {
    const uint32_t mask = __ballot_sync(0xffffffffu, live);
    if (!mask) break;
    if (live) live = step(bounce, mask);
  }
  if (!in) return;
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
        if (rp.img) {
          put(rp.tx(b), 0.f);
          put(rp.ty(b), 0.f);
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
      if (TEX && S.has_img && b < a.max_depth)
        for (int s = 0; s < 4; ++s) tex_put(b, s, 0, zero3);
    }
    return;
  }
  a.out[3 * (size_t)lane_id] = Lr.x;
  a.out[3 * (size_t)lane_id + 1] = Lr.y;
  a.out[3 * (size_t)lane_id + 2] = Lr.z;
}

// K5, K6 and K8 are this one template: K6 adds the cache stores and K8 the
// adjoint terms, so their draws, hits and branches are K5's by construction.
// Dynamic shared memory: the shadow rays' block (step 2). COUNT: a.swept is
// not null.
template <int MODE, bool SOBOL, bool TEX, bool WIDE, bool COUNT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) bigscene_fwd_kernel(const BigArgs a) {
  extern __shared__ float4 smem4[];
  const int lane_id = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = lane_id < a.n;
  Scene S;
  S.init(a.F, a.I);
  Tables T;
  T.init(a);
  const Rays R{(float*)smem4 + threadIdx.x, a.nee_rays};
  Swept<COUNT> sw;
  if constexpr (MODE == MODE_REPLAY && WIDE) {
    // a row past the local array (past ROW_LIGHTS lights or ROW_TEXTURES
    // textures): this thread's column of the block's accumulator in device
    // memory, summed in the same order
    const WideAcc acc{a.wide + (size_t)blockIdx.x * a.n_cols * THREADS + threadIdx.x};
    for (int k = 0; k < a.n_cols; ++k) acc[k] = 0.f;
    trace_lane<MODE, SOBOL, TEX>(a, S, T, R, lane_id, in, acc, sw);
    block_partials(acc, a.n_cols, a.partial);
  } else if constexpr (MODE == MODE_REPLAY) {
    // per-thread env, light-emission (and checker) adjoints, then the
    // fixed-order block sum
    float acc[LOCAL_COLS<TEX>];
    for (int k = 0; k < a.n_cols; ++k) acc[k] = 0.f;
    trace_lane<MODE, SOBOL, TEX>(a, S, T, R, lane_id, in, acc, sw);
    block_partials(acc, a.n_cols, a.partial);
  } else {
    trace_lane<MODE, SOBOL, TEX>(a, S, T, R, lane_id, in, static_cast<float*>(nullptr), sw);
  }
  if constexpr (COUNT) {
    // the warp's counts, added once at its exit
    unsigned long long c[5] = {sw.rows, sw.sweeps, sw.bounds, sw.tri_rows, sw.tri_bounds};
    for (int off = 16; off; off >>= 1)
      for (int k = 0; k < 5; ++k) c[k] += __shfl_down_sync(0xffffffffu, c[k], off);
    if ((threadIdx.x & 31) == 0)
      for (int k = 0; k < 5; ++k) atomicAdd(a.swept + k, c[k]);
  }
}

template <int MODE, bool TEX, bool WIDE, bool COUNT>
void launch_sampler(const BigArgs& a, int blocks, int smem, void* stream) {
  if (a.sampler == S_SOBOL)
    bigscene_fwd_kernel<MODE, true, TEX, WIDE, COUNT>
        <<<blocks, THREADS, smem, (cudaStream_t)stream>>>(a);
  else
    bigscene_fwd_kernel<MODE, false, TEX, WIDE, COUNT>
        <<<blocks, THREADS, smem, (cudaStream_t)stream>>>(a);
}

// the counting instance where a.swept is not null (a traced launch)
template <int MODE, bool TEX, bool WIDE>
void launch_count(const BigArgs& a, int blocks, int smem, void* stream) {
  if (a.swept) return launch_sampler<MODE, TEX, WIDE, true>(a, blocks, smem, stream);
  launch_sampler<MODE, TEX, WIDE, false>(a, blocks, smem, stream);
}

// K8's rows past the local array (a.wide) only
template <int MODE, bool TEX>
void launch_kernel(const BigArgs& a, int blocks, int smem, void* stream) {
  if constexpr (MODE == MODE_REPLAY)
    if (a.wide) return launch_count<MODE, TEX, true>(a, blocks, smem, stream);
  launch_count<MODE, TEX, false>(a, blocks, smem, stream);
}

// textured: the scene has texture records (texa, texb and timg are then its
// tables, and K8 writes texel entries where it has image textures)
template <int MODE>
int launch(BigArgs& a, int textured, void* stream) {
  if (a.sampler == S_SOBOL) {
    if (a.max_depth > MAX_SOBOL_DEPTH) return (int)cudaErrorInvalidValue;
    cudaError_t err = upload_sites();
    if (err != cudaSuccess) return err;
  }
  if (a.nee_rays < 0 || a.nee_rays > NEE_CHUNK) return (int)cudaErrorInvalidValue;
  // at most 36 KB: no opt-in past 48 KB
  const int smem = 4 * Rays::FIELDS * a.nee_rays * THREADS;
  const int blocks = a.n > 0 ? (a.n + THREADS - 1) / THREADS : (MODE == MODE_REPLAY ? 1 : 0);
  if (blocks > 0 && textured)
    launch_kernel<MODE, true>(a, blocks, smem, stream);
  else if (blocks > 0)
    launch_kernel<MODE, false>(a, blocks, smem, stream);
  const cudaError_t err = cudaGetLastError();
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
// emissions, the (3,) env, the texture tables texa, texb (T, 3) and timg
// (texels, 3) (one zero row each in an untextured scene), tex_rec (M,) and
// bnd and links, each class's tree over its 8-row blocks, depth first
// (kbs.tree_bounds: the entries' spheres, (entries, 4) float, and their
// (skip, block) links, (entries, 2) int, tri | rect | disk | sphere)
// (textured: the scene has texture records); lanes: o, d (n, 3), si and
// pix (n,) int32 (null under the "random" sampler); out (n, 3), and under
// residual resf (res_n, n) and resi (max_depth + 1, n), plane-major.
// sampler: 0 random, 1 hash, 2 sobol;
// cull: skip the nodes a lane's rays cannot meet (1) or sweep every row
// (0); nee_rays: min(L, NEE_CHUNK); swept: null, or 5 counts (the rows its
// warps' leaf phases tested and the node steps its warps took, each summed
// over the lanes in each sweep, and the lane-sweeps: rows, sweeps, node
// steps, then the rows and node steps of the tri tree's walks) that the
// launch adds to.
extern "C" int kytpu_bigscene_fwd(const float* F, const int* I, const float* geo, const int* rows,
                                  const int* mat_i, const float* mat_f, const float* diffuse,
                                  const float* specular, const float* emission,
                                  const float* exponent, const float* light_emit,
                                  const float* env, const float* texa, const float* texb,
                                  const float* timg, const int* tex_rec, const float* bnd,
                                  const int* links, const float* o, const float* d,
                                  const int* si, const int* pix,
                                  float* out, float* resf, int* resi, int n, int n_tri,
                                  int n_rect, int n_disk, int n_sph, int M, int seed,
                                  int max_depth, int rr_start, int rows_per_tile, int sampler,
                                  int robust, int texp, int residual, int textured, int cull,
                                  int nee_rays, unsigned long long* swept, void* stream) {
  BigArgs a{};
  a.F = F; a.I = I; a.geo = geo; a.rows = rows; a.mat_i = mat_i; a.mat_f = mat_f;
  a.diffuse = diffuse; a.specular = specular; a.emission = emission; a.exponent = exponent;
  a.light_emit = light_emit; a.env = env; a.texa = texa; a.texb = texb; a.timg = timg;
  a.tex_rec = tex_rec; a.bnd = (const float4*)bnd; a.link = (const int2*)links;
  a.o = o; a.d = d; a.si = si; a.pix = pix; a.out = out; a.resf = resf; a.resi = resi;
  a.n = n; a.n_tri = n_tri; a.n_rect = n_rect; a.n_disk = n_disk; a.n_sph = n_sph; a.M = M;
  a.seed = seed; a.max_depth = max_depth; a.rr_start = rr_start; a.rows_per_tile = rows_per_tile;
  a.sampler = sampler; a.robust = robust; a.texp = texp; a.cull = cull; a.nee_rays = nee_rays;
  a.swept = swept;
  return residual ? launch<MODE_RESIDUAL>(a, textured, stream)
                  : launch<MODE_FWD>(a, textured, stream);
}

// K8 on `stream` (PyTorch's current stream): the tables and lanes of
// kytpu_bigscene_fwd, the upstream gradient g (n, 3) and the forward's
// radiance big_l (n, 3) -> the row-tagged adjoint planes dout ((PB *
// max_depth + 3), n), their row tags (max_depth + 1, n) and, through the
// (max(1, ceil(n / 128)), n_cols) scratch `partial`, the (n_cols = 3 + 3L
// [+ 6T],) lane sums of the env, light-emission [and checker] adjoints, and
// on an image scene the texel entries tex_dout (12 max_depth, n) and their
// tags tex_tags (4 max_depth, n), as K4 writes them; wide: null, or, for
// more columns than the local row holds (past ROW_LIGHTS lights or
// ROW_TEXTURES textures), a (blocks, n_cols, 128) scratch for the rows in
// device memory; swept: as kytpu_bigscene_fwd's. Returns
// cudaGetLastError() (or cudaErrorInvalidValue for what it does not take).
extern "C" int kytpu_bigscene_bwd_replay(
    const float* F, const int* I, const float* geo, const int* rows, const int* mat_i,
    const float* mat_f, const float* diffuse, const float* specular, const float* emission,
    const float* exponent, const float* light_emit, const float* env, const float* texa,
    const float* texb, const float* timg, const int* tex_rec, const float* bnd, const int* links,
    const float* o, const float* d, const int* si, const int* pix, const float* g,
    const float* big_l,
    float* dout, int* tags, float* partial, float* lane_sums, float* tex_dout, int* tex_tags,
    int n, int n_cols, int n_tri, int n_rect, int n_disk, int n_sph, int M, int seed,
    int max_depth, int rr_start, int rows_per_tile, int sampler, int robust, int texp,
    int textured, int cull, int nee_rays, float* wide, unsigned long long* swept, void* stream) {
  if ((!wide && n_cols > (textured ? LOCAL_COLS<true> : LOCAL_COLS<false>)) || n_cols < 3)
    return (int)cudaErrorInvalidValue;
  BigArgs a{};
  a.F = F; a.I = I; a.geo = geo; a.rows = rows; a.mat_i = mat_i; a.mat_f = mat_f;
  a.diffuse = diffuse; a.specular = specular; a.emission = emission; a.exponent = exponent;
  a.light_emit = light_emit; a.env = env; a.texa = texa; a.texb = texb; a.timg = timg;
  a.tex_rec = tex_rec; a.bnd = (const float4*)bnd; a.link = (const int2*)links;
  a.o = o; a.d = d; a.si = si; a.pix = pix;
  a.g = g; a.l_in = big_l; a.dout = dout; a.tags = tags; a.partial = partial;
  a.lane_sums = lane_sums; a.tex_dout = tex_dout; a.tex_tags = tex_tags;
  a.n = n; a.n_cols = n_cols; a.n_tri = n_tri; a.n_rect = n_rect; a.n_disk = n_disk;
  a.n_sph = n_sph; a.M = M; a.seed = seed; a.max_depth = max_depth; a.rr_start = rr_start;
  a.rows_per_tile = rows_per_tile; a.sampler = sampler; a.robust = robust; a.texp = texp;
  a.cull = cull; a.nee_rays = nee_rays; a.wide = wide; a.swept = swept;
  return launch<MODE_REPLAY>(a, textured, stream);
}
