// Coefficient-cache backward for NVIDIA Hopper (sm_90a), K3.
//
// Replaces kytpu/kernels/wavefront.py::_make_bwd_res_kernel, the Pallas TPU
// kernel behind the backward of every train step on a scene with at most 64
// surfaces. Its plain PyTorch transcription is
// kytpu_torch/kernels/wavefront.py::bwd_res_plain (the fixed-order sums in
// sum_lanes); this file follows it statement by statement, and chip_smoke.py
// holds the two against each other.
//
// Design. One thread per lane (128 a block). A lane reads its upstream
// gradient g, its radiance L and its column of the coefficient cache that K2
// wrote (wavefront_fwd.cu), and walks the bounces peeling the tail radiance
// R_{b+1} = (R_b - E_b) / T_b, with E_b and T_b rebuilt from the cache and
// the colour tables: no intersection, no random numbers. Under
// nee="single" the light K2 picked is read from the int cache, never
// recomputed. Each adjoint term goes to one row of a per-thread accumulator
// of 9M+3 floats (dd, ds, de, denv), and M more (dexp) under
// trainable_exponent, indexed at run time, so it lives in local memory:
// 408 B a thread at Veach's M = 11, 2.5 KB at M = 64. The exponent adjoint
// is bilinear in the cache: the "Bk"/"tuk" planes K2 wrote weigh each NEE
// term's and the extension's colour cotangent.
//
// The sum over lanes is the fixed-order two-pass reduction of
// lane_sum.cuh, shared with K4: the gradient repeats to the last bit.
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
// read plane-major, a warp's loads of one plane in one 128-byte line. What
// keeps it from that bound today: the local-memory accumulators of the
// ~900 threads an SM holds overflow its L1, so their read-modify-writes go
// to L2 (PERF.md). Built with --fmad=false and without fast math, as the
// forward is, so it rounds as the plain version does.

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

__device__ __forceinline__ void add3(float* acc, int col, V v) {
  acc[col] = acc[col] + v.x;
  acc[col + 1] = acc[col + 1] + v.y;
  acc[col + 2] = acc[col + 2] + v.z;
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

template <bool TEX, bool ROWTAG>
__global__ void __launch_bounds__(THREADS)
bwd_res_kernel(const int* __restrict__ I, const float* __restrict__ diffuse_t,
               const float* __restrict__ specular_t, const float* __restrict__ emission_t,
               const float* __restrict__ light_emit_t, const float* __restrict__ env_t,
               const float* __restrict__ g_in, const float* __restrict__ l_in,
               const float* __restrict__ resf, const int* __restrict__ resi,
               float* __restrict__ partial, int n, int K, int max_depth, const Tex tx,
               const Rows rw) {
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

  float acc[ROWTAG ? ROW_COLS : MAX_COLS];
  for (int k = 0; k < K; ++k) acc[k] = 0.f;

  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane < n) {
    const V g = ld3(g_in + 3 * (size_t)lane);
    V r_tail = ld3(l_in + 3 * (size_t)lane);
    V beta = V{1.f, 1.f, 1.f};
    auto plane = [&](int k) { return resf[(size_t)k * n + lane]; };
    // ROWTAG: plane k of this lane's row-tagged adjoints
    auto put3 = [&](int k, V v) {
      rw.dout[(size_t)k * n + lane] = v.x;
      rw.dout[(size_t)(k + 1) * n + lane] = v.y;
      rw.dout[(size_t)(k + 2) * n + lane] = v.z;
    };
    for (int b = 0; b <= max_depth; ++b) {
      const int ib = resi[(size_t)b * n + lane];
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
          if (sid >= 0 && mk == MAT_PLASTIC) acc[col_x + sid] = acc[col_x + sid] + addx;
        }
      }
      beta = beta * t_eff;
      r_tail = r_next;
    }
  }

  block_partials(acc, K, partial);
}

}  // namespace

// K3 on `stream` (PyTorch's current stream): the table adjoints as one
// (n_cols,) vector dd | ds | de | denv [| dexp] [| dta | dtb] in `out`
// (n_cols = 9 * m_rows + 3, m_rows more under trainable_exponent, 6 a
// texture on a textured scene), through the (max(1, ceil(n / 128)), n_cols)
// scratch `partial`; where the scene has image textures (textured: it has
// texture records), the texel entries tex_dout (12 max_depth, n) and their
// tags tex_tags (4 max_depth, n), as K4 writes them. Past DENSE_MAX_ROWS
// surfaces (row_tags not null) `out` holds denv | each light's emission |
// dta | dtb, and the hit rows' adjoints are row_dout ((PB max_depth + 3), n)
// with their tags row_tags (max_depth + 1, n), as K7 writes them. Returns
// cudaGetLastError().
extern "C" int kytpu_wavefront_bwd_res(const int* I, const float* diffuse, const float* specular,
                                       const float* emission, const float* light_emit,
                                       const float* env, const float* texa, const float* texb,
                                       const float* timg, const float* g, const float* big_l,
                                       const float* resf, const int* resi, float* partial,
                                       float* out, float* tex_dout, int* tex_tags,
                                       float* row_dout, int* row_tags, int n, int m_rows,
                                       int n_cols, int max_depth, int textured, void* stream) {
  const bool rowtag = row_tags != nullptr;
  if ((!rowtag && m_rows > DENSE_MAX_ROWS) || n_cols > (rowtag ? ROW_COLS : MAX_COLS))
    return (int)cudaErrorInvalidValue;
  const int blocks = n > 0 ? (n + THREADS - 1) / THREADS : 1;
  const Tex tx{texa, texb, timg, tex_dout, tex_tags};
  const Rows rw{row_dout, row_tags};
#define KYTPU_K3(TEX_, ROWTAG_)                                                                 \
  bwd_res_kernel<TEX_, ROWTAG_><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(                  \
      I, diffuse, specular, emission, light_emit, env, g, big_l, resf, resi, partial, n, n_cols, \
      max_depth, tx, rw)
  if (rowtag && textured)
    KYTPU_K3(true, true);
  else if (rowtag)
    KYTPU_K3(false, true);
  else if (textured)
    KYTPU_K3(true, false);
  else
    KYTPU_K3(false, false);
#undef KYTPU_K3
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sum_partials(partial, out, blocks, n_cols, (cudaStream_t)stream);
}
