// Coefficient-cache backward for NVIDIA Hopper (sm_90a), K3.
//
// Replaces kytpu/kernels/wavefront.py::_make_bwd_res_kernel, the Pallas TPU
// kernel behind the backward of every train step on a scene with at most 64
// surfaces. Its plain PyTorch transcription is
// kytpu_torch/kernels/wavefront.py::bwd_res_plain (the fixed-order sums in
// sum_kept); this file follows it statement by statement, and chip_smoke.py
// holds the two against each other.
//
// Design. One thread per lane (128 a block). A lane reads its upstream
// gradient g, its radiance L and its column of the coefficient cache that K2
// wrote (wavefront_fwd.cu), and walks the bounces peeling the tail radiance
// R_{b+1} = (R_b - E_b) / T_b, with E_b and T_b rebuilt from the cache and
// the colour tables: no intersection, no random numbers (bwd_lane, a device
// function of its own, which tests/test_torch_csrc_bwd.py runs on the host).
// Under nee="single" the light K2 picked is read from the int cache, never
// recomputed. Each adjoint term goes to one column of the thread's adjoint
// row of 9M+3 columns (dd, ds, de, denv), and M more (dexp) under
// trainable_exponent, picked at run time. The exponent adjoint is bilinear
// in the cache: the "Bk"/"tuk" planes K2 wrote weigh each NEE term's and
// the extension's colour cotangent.
//
// The row keeps only the columns a lane of the scene can add to
// (wavefront.py acc_columns, sent there by the column map `cmap`: a mirror
// row has no diffuse column, a matte row no specular, a non-light row no
// emission), 64 of Veach's 102, plus one that no lane adds to. It is a
// column of the block's accumulator in dynamic shared memory (ACC_SHARED,
// lane_sum.cuh's ColAcc: column k of thread t at k * 128 + t, so a warp's
// read-modify-writes hit 32 banks whatever rows its lanes hit) where the
// block stays within ACC_BUDGET (wavefront.py acc_route): 32 KB at Veach,
// six blocks an SM at its registers. A larger row (32 lights' 199 kept
// columns) stays in local memory (ACC_LOCAL, RowAcc), as every row did
// before: 408 B a thread at Veach, whose read-modify-writes went to L2 once
// the ~900 threads an SM holds overflowed its L1. Both routes then sum the
// block's columns in one fixed order (lane_sum.cuh: four 32-thread chains
// a column, one a warp, in place of 5 shuffles a column in every thread)
// into a column-major partials table whose second pass reads coalesced
// rows; the gradient repeats to the last bit and is the same on both
// routes. kytpu_torch/kernels/wavefront.py::sum_kept, which bwd_res_plain
// uses, adds in the same order, so the two agree to the last bit.
//
// Past DENSE_MAX_ROWS surfaces (ROWTAG, a compile-time switch) a dense row
// of 9M+3 columns does not fit a thread. As K7 does, each bounce's adjoints
// of its hit row go to row-tagged planes (dd, ds, de [, dexp], the horizon's
// de) with a row-tag plane (the row + 1 read from the cache, 0 for a miss);
// the per-thread row keeps denv, each light's emission and the checker
// adjoints, and the host sorts the tags and sums the planes by row in a
// fixed order (bigscene_bwd_res.cu's segment sums). The row field of the
// int cache is 23 bits wide (pack_row), so rows past 255 decode whole.
//
// On a textured scene (TEX, a compile-time switch) a textured row's diffuse
// is its texture's value, rebuilt from the cache: a checker's colour by the
// parity K2 stored in bit 10 of the int plane, an image's bilinear value at
// the texel coordinates of the "tx"/"ty" planes (texture.cuh). The row's
// diffuse adjoint goes to the texture, as in K4: a checker's to 6 more
// accumulator columns a texture, an image's as four texel-tagged entries a
// bounce that the host sums by texel in a fixed order.
//
// What bounds it on the H100: bytes. A lane reads the whole cache
// ((res_n + max_depth + 1) * 4 B), g and L (24 B) once and writes nothing;
// the arithmetic is a few dozen FP32 operations per bounce. The cache is
// read plane-major, a warp's loads of one plane in one 128-byte line. Built
// with --fmad=false and without fast math, as the forward is, so it rounds
// as the plain version does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_sum.cuh"
#include "texture.cuh"
#include "wavefront_tables.cuh"

namespace {

using namespace kytpu;

constexpr int THREADS = LANE_THREADS;
static_assert(DENSE_MAX_ROWS < 255, "the dense route decodes rows from 8 bits");

struct V {
  float x, y, z;
};

__device__ __forceinline__ V operator+(V a, V b) { return V{a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V operator-(V a, V b) { return V{a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V operator*(V a, V b) { return V{a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V operator*(V a, float s) { return V{a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V ld3(const float* p) { return V{__ldg(p), __ldg(p + 1), __ldg(p + 2)}; }
__device__ __forceinline__ float safe_div(float a, float b) { return b != 0.f ? a / b : 0.f; }
__device__ __forceinline__ V sel(bool c, V a, V b) { return c ? a : b; }
__device__ __forceinline__ float vdot(V a, V b) { return (a.x * b.x + a.y * b.y) + a.z * b.z; }

// v to columns col .. col + 2 of the accumulator view (lane_sum.cuh)
template <class A>
__device__ __forceinline__ void add3(const A& acc, int col, V v) {
  float* q = acc.at(col);
  q[0] = q[0] + v.x;
  q[A::STRIDE] = q[A::STRIDE] + v.y;
  q[2 * A::STRIDE] = q[2 * A::STRIDE] + v.z;
}

// the textures K3 reads: the int table's texture records, the checker
// colours and the atlas; out, the texel entries and their tags
struct Tex {
  const float *texa, *texb, *timg;
  float* dout;
  int* tags;
};

// ROWTAG: the row-tagged planes and their tags out
struct Rows {
  float* dout;
  int* tags;
};

// One launch's arguments
struct BwdArgs {
  const int* I;
  const float *diffuse_t, *specular_t, *emission_t, *light_emit_t, *env_t, *g_in, *l_in, *resf;
  const int* resi;
  // K: the row's columns; cmap: each column of the gradient vector's column
  // in the row (lane_sum.cuh)
  int n, K, max_depth;
  const int* cmap;
  Tex tx;
  Rows rw;
};

// K3's lane body: lane `lane`'s adjoints added to its row `acc` (a RowAcc
// or ColAcc view, lane_sum.cuh), and under ROWTAG (TEX: with image
// textures) written to its row-tagged planes (texel entries)
template <bool TEX, bool ROWTAG, class A>
__device__ __forceinline__ void bwd_lane(const BwdArgs& a, int lane, A acc) {
  const int* __restrict__ I = a.I;
  const float* __restrict__ diffuse_t = a.diffuse_t;
  const float* __restrict__ specular_t = a.specular_t;
  const float* __restrict__ emission_t = a.emission_t;
  const float* __restrict__ light_emit_t = a.light_emit_t;
  const float* __restrict__ env_t = a.env_t;
  const float* __restrict__ g_in = a.g_in;
  const float* __restrict__ l_in = a.l_in;
  const float* __restrict__ resf = a.resf;
  const int* __restrict__ resi = a.resi;
  const int n = a.n, max_depth = a.max_depth;
  const Tex& tx = a.tx;
  const Rows& rw = a.rw;
  const int n_pl = __ldg(I), n_sp = __ldg(I + 1);
  const int M = __ldg(I + H_M), L = __ldg(I + H_L);
  const int* MATI = I + HDR_I + PL_I * n_pl + SP_I * n_sp;
  const int* LTI = MATI + MAT_I * M;
  const int* TXI = LTI + LT_I * L;
  const bool single = __ldg(I + H_SINGLE) != 0;
  const bool has_env = __ldg(I + H_ENV_I) >= 0;
  const bool texp = __ldg(I + H_TEXP) != 0;
  const bool has_img = TEX && __ldg(I + H_IMG) != 0;
  const ResPlanes rp = res_planes(has_env, single, L, texp, has_img);
  // the per-thread row: dd | ds | de | denv | dexp | dta | dtb, or under
  // ROWTAG denv | each light's emission | dta | dtb
  const int col_d = 0, col_s = 3 * M, col_e = 6 * M, col_env = ROWTAG ? 0 : 9 * M,
            col_x = 9 * M + 3;
  const int col_ta = ROWTAG ? 3 + 3 * L : col_x + (texp ? M : 0),
            col_tb = col_ta + 3 * __ldg(I + H_TEX);
  const V zero3 = V{0.f, 0.f, 0.f};
  const int PB = texp ? 10 : 9;

  const V g = ld3(g_in + 3 * (size_t)lane);
  V r_tail = ld3(l_in + 3 * (size_t)lane);
  V beta = V{1.f, 1.f, 1.f};
  auto plane = [&](int k) { return __ldg(resf + (size_t)k * n + lane); };
  // ROWTAG: plane k of this lane's row-tagged adjoints
  auto put3 = [&](int k, V v) {
    rw.dout[(size_t)k * n + lane] = v.x;
    rw.dout[(size_t)(k + 1) * n + lane] = v.y;
    rw.dout[(size_t)(k + 2) * n + lane] = v.z;
  };
  for (int b = 0; b <= max_depth; ++b) {
    const int ib = __ldg(resi + (size_t)b * n + lane);
    // the dense route's rows fit the field's low 8 bits (DENSE_MAX_ROWS <
    // 255), where the high part is 0: it decodes them as kytpu does
    const int sid = (ROWTAG ? unpack_row(ib) : (ib & 255)) - 1;
    const float wb = plane(rp.wb(b));
    const V gb = g * beta;
    int mk = MAT_MATTE, li = -1;
    if (sid >= 0) {
      mk = __ldg(MATI + MAT_I * sid);
      li = __ldg(MATI + MAT_I * sid + 1);
    }
    // adjoint-eligible rows: a mirror row never reads the diffuse table, a
    // matte row the specular one, a non-light row the emission one
    const bool ok_d = sid >= 0 && mk != MAT_MIRROR;
    const bool ok_s = sid >= 0 && mk != MAT_MATTE;
    const bool ok_e = sid >= 0 && li >= 0;
    V de_b = zero3;
    if constexpr (ROWTAG) {
      if (ok_e) de_b = gb * wb;
      rw.tags[(size_t)b * n + lane] = sid + 1;
    } else {
      if (ok_e) add3(acc, col_e + 3 * sid, gb * wb);
    }
    float wenv = 0.f;
    if (has_env) {
      wenv = plane(rp.wenv(b));
      add3(acc, col_env, gb * wenv);
    }
    if (b == max_depth) {
      if constexpr (ROWTAG) put3(PB * b, de_b);
      break;
    }

    const bool phong = (ib & RESI_PHONG) != 0;
    const bool to_spec = (ib & RESI_TO_SPEC) != 0;
    V diff_sel = ok_d ? ld3(diffuse_t + 3 * sid) : zero3;
    // a textured row's diffuse, rebuilt from the parity bit or "tx"/"ty"
    const int trec = (TEX && sid >= 0) ? __ldg(MATI + MAT_I * sid + 2) : -1;
    const bool tex_img = trec >= 0 && __ldg(TXI + TX_I * trec) != 0;
    const bool tex_even = (ib & RESI_EVEN) != 0;
    Taps taps;
    if (trec >= 0 && tex_img) {
      const int* ti = TXI + TX_I * trec;
      taps = image_taps(__ldg(ti + 2), __ldg(ti + 3), __ldg(ti + 4), plane(rp.tx(b)),
                        plane(rp.ty(b)));
      float c[3];
      image_color(taps, __ldg(ti + 5) != 0, tx.timg, c);
      diff_sel = V{c[0], c[1], c[2]};
    } else if (trec >= 0) {
      diff_sel = ld3((tex_even ? tx.texa : tx.texb) + 3 * __ldg(TXI + TX_I * trec + 1));
    }
    const V spec_sel = ok_s ? ld3(specular_t + 3 * sid) : zero3;
    const V emit_sel = ok_e ? ld3(emission_t + 3 * sid) : zero3;
    const V col_nee = sel(phong, spec_sel, diff_sel);
    V e_term = emit_sel * wb;
    if (has_env) e_term = e_term + ld3(env_t) * wenv;
    V addc = zero3;
    float addx = 0.f;
    for (int j = 0; j < rp.n_b; ++j) {
      const int light = single ? (ib >> RESI_PICK_SHIFT) & 31 : j;
      const float bp = plane(rp.B(b, j));
      const V e_l = ld3(light_emit_t + 3 * light);
      e_term = e_term + (col_nee * e_l) * bp;
      const V add = (gb * col_nee) * bp;
      // the NEE emission adjoint: to the light's emitting row, or to env
      // (under ROWTAG to the light's column, routed by the host)
      if constexpr (ROWTAG) {
        add3(acc, 3 + 3 * light, add);
      } else {
        const int lrow = __ldg(LTI + LT_I * light + 2);
        if (lrow >= 0)
          add3(acc, col_e + 3 * lrow, add);
        else if (__ldg(LTI + LT_I * light) == L_ENV)
          add3(acc, col_env, add);
      }
      addc = addc + (gb * e_l) * bp;
      if (texp) addx = addx + vdot(gb * e_l, col_nee) * plane(rp.Bk(b, j));
    }
    const float tu = plane(rp.tu(b));
    const V t_eff = sel(to_spec, spec_sel, diff_sel) * tu;
    const V r_next = V{safe_div(r_tail.x - e_term.x, t_eff.x),
                       safe_div(r_tail.y - e_term.y, t_eff.y),
                       safe_div(r_tail.z - e_term.z, t_eff.z)};
    const V addt = (gb * r_next) * tu;
    V addc_diff = sel(phong, zero3, addc) + sel(to_spec, zero3, addt);
    if (TEX) {
      // a textured row's diffuse adjoint goes to its texture
      if (trec >= 0 && !tex_img)
        add3(acc, (tex_even ? col_ta : col_tb) + 3 * __ldg(TXI + TX_I * trec + 1), addc_diff);
      if (has_img) {
        const bool sep = tex_img && __ldg(TXI + TX_I * trec + 5) != 0;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const bool ok = tex_img && taps.t[s] >= 0;
          const size_t j = 4 * (size_t)b + s;
          tx.tags[j * n + lane] = ok ? taps.t[s] + 1 : 0;
          tx.dout[(3 * j) * n + lane] = ok ? texel_entry(taps, sep, s, addc_diff.x) : 0.f;
          tx.dout[(3 * j + 1) * n + lane] = ok ? texel_entry(taps, sep, s, addc_diff.y) : 0.f;
          tx.dout[(3 * j + 2) * n + lane] = ok ? texel_entry(taps, sep, s, addc_diff.z) : 0.f;
        }
      }
      if (trec >= 0) addc_diff = zero3;
    }
    if constexpr (ROWTAG) {
      // "tuk" is 0 off phong lanes, whose extension read specular
      if (texp) addx = addx + vdot(gb * r_next, spec_sel) * plane(rp.tuk(b));
      const int p = PB * b;
      put3(p, ok_d ? addc_diff : zero3);
      put3(p + 3, ok_s ? sel(phong, addc, zero3) + sel(to_spec, addt, zero3) : zero3);
      put3(p + 6, de_b);
      if (texp) rw.dout[(size_t)(p + 9) * n + lane] = (sid >= 0 && mk == MAT_PLASTIC) ? addx : 0.f;
    } else {
      if (ok_d) add3(acc, col_d + 3 * sid, addc_diff);
      if (ok_s) add3(acc, col_s + 3 * sid, sel(phong, addc, zero3) + sel(to_spec, addt, zero3));
      if (texp) {
        // "tuk" is 0 off phong lanes, whose extension read specular
        addx = addx + vdot(gb * r_next, spec_sel) * plane(rp.tuk(b));
        if (sid >= 0 && mk == MAT_PLASTIC) {
          float* q = acc.at(col_x + sid);
          *q = *q + addx;
        }
      }
    }
    beta = beta * t_eff;
    r_tail = r_next;
  }
}

// K3: one lane a thread; the block's rows summed by column (ACC, an
// AccRoute: each thread's row in local memory, or a column of the block's
// accumulator in dynamic shared memory)
template <bool TEX, bool ROWTAG, int ACC>
__global__ void __launch_bounds__(THREADS) bwd_res_kernel(const BwdArgs a, float* partial) {
  extern __shared__ float4 smem4[];
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if constexpr (ACC == ACC_SHARED) {
    float* cols = (float*)smem4;
    for (int k = 0; k < a.K; ++k) cols[k * THREADS + threadIdx.x] = 0.f;
    if (lane < a.n) bwd_lane<TEX, ROWTAG>(a, lane, ColAcc{cols + threadIdx.x, a.cmap});
    block_col_sums(cols, a.K, partial, gridDim.x);
  } else {
    float row[ROWTAG ? ROW_COLS : MAX_ROW];
    for (int k = 0; k < a.K; ++k) row[k] = 0.f;
    if (lane < a.n) bwd_lane<TEX, ROWTAG>(a, lane, RowAcc{row, a.cmap});
    block_row_sums(row, a.K, partial, gridDim.x);
  }
}

constexpr int MAX_DEVICES = 64;

// the dynamic shared memory each kernel of a shared-memory route may take on
// each device
// (cudaFuncSetAttribute once a size)
struct SmemLimit {
  int bytes[MAX_DEVICES];
};

template <class K>
cudaError_t allow_smem(SmemLimit& lim, K k, int smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < MAX_DEVICES && lim.bytes[dev] >= smem)) return err;
  err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < MAX_DEVICES) lim.bytes[dev] = smem;
  return err;
}

// kernel k on `blocks` blocks with `smem` bytes of dynamic shared memory
// (lim: opted in to, for the shared-memory routes)
template <class K>
cudaError_t launch_k3(K k, SmemLimit* lim, int blocks, int smem, const BwdArgs& a,
                      float* partial, void* stream) {
  if (lim) {
    const cudaError_t err = allow_smem(*lim, k, smem);
    if (err != cudaSuccess) return err;
  }
  k<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(a, partial);
  return cudaGetLastError();
}

}  // namespace

// K3 on `stream` (PyTorch's current stream): the table adjoints as one
// (n_out,) vector dd | ds | de | denv [| dexp] [| dta | dtb] in `out`
// (n_out = 9 * m_rows + 3, m_rows more under trainable_exponent, 6 a
// texture on a textured scene), through the column-major (n_cols, max(1,
// ceil(n / 128))) scratch `partial`; where the scene has image textures
// (textured: it has texture records), the texel entries tex_dout (12
// max_depth, n) and their tags tex_tags (4 max_depth, n), as K4 writes
// them. The row: n_cols columns, the gradient vector's column c at column
// cmap[c] (wavefront.py acc_map), and on the dense route a last one that no
// lane adds to; acc_route (an AccRoute): each lane's row
// in local memory, or a column of the block's accumulator in shared memory
// (n_cols * 512 bytes a block). Past DENSE_MAX_ROWS surfaces (row_tags not
// null; local rows only) `out`
// holds denv | each light's emission | dta | dtb, and the hit rows'
// adjoints are row_dout ((PB max_depth + 3), n) with their tags row_tags
// (max_depth + 1, n), as K7 writes them. Returns cudaGetLastError().
extern "C" int kytpu_wavefront_bwd_res(const int* I, const float* diffuse, const float* specular,
                                       const float* emission, const float* light_emit,
                                       const float* env, const float* texa, const float* texb,
                                       const float* timg, const float* g, const float* big_l,
                                       const float* resf, const int* resi, float* partial,
                                       float* out, float* tex_dout, int* tex_tags,
                                       float* row_dout, int* row_tags, const int* cmap, int n,
                                       int m_rows, int n_cols, int n_out, int max_depth,
                                       int textured, int acc_route, void* stream) {
  const bool rowtag = row_tags != nullptr;
  const int smem = acc_route == ACC_SHARED ? 4 * n_cols * THREADS : 0;
  if ((!rowtag && m_rows > DENSE_MAX_ROWS) || n_cols > (rowtag ? ROW_COLS : MAX_ROW) ||
      acc_route < ACC_LOCAL || acc_route > ACC_SHARED || (acc_route != ACC_LOCAL && rowtag) ||
      smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const int blocks = n > 0 ? (n + THREADS - 1) / THREADS : 1;
  const BwdArgs a{I, diffuse, specular, emission, light_emit, env, g, big_l, resf, resi, n, n_cols,
                  max_depth, cmap, Tex{texa, texb, timg, tex_dout, tex_tags},
                  Rows{row_dout, row_tags}};
  static SmemLimit lim[2];
  cudaError_t err;
  if (acc_route == ACC_SHARED)
    err = textured ? launch_k3(bwd_res_kernel<true, false, ACC_SHARED>, &lim[1], blocks, smem, a,
                               partial, stream)
                   : launch_k3(bwd_res_kernel<false, false, ACC_SHARED>, &lim[0], blocks, smem,
                               a, partial, stream);
  else if (rowtag)
    err = textured ? launch_k3(bwd_res_kernel<true, true, ACC_LOCAL>, nullptr, blocks, 0, a,
                               partial, stream)
                   : launch_k3(bwd_res_kernel<false, true, ACC_LOCAL>, nullptr, blocks, 0, a,
                               partial, stream);
  else
    err = textured ? launch_k3(bwd_res_kernel<true, false, ACC_LOCAL>, nullptr, blocks, 0, a,
                               partial, stream)
                   : launch_k3(bwd_res_kernel<false, false, ACC_LOCAL>, nullptr, blocks, 0, a,
                               partial, stream);
  if (err != cudaSuccess) return (int)err;
  return sum_cols(partial, out, blocks, cmap, rowtag ? n_cols : n_cols - 1, n_out,
                  (cudaStream_t)stream);
}
