// The big-scene coefficient-cache backward for NVIDIA Hopper (sm_90a), K7,
// and the fixed-order sums by row that follow it.
//
// Replaces kytpu/kernels/bigscene.py::_make_res_bwd_kernel, the Pallas TPU
// kernel behind the backward of every train step on a scene past 64
// surfaces, together with the segment sum by row and the light-emission
// routing that follow the call in bigscene.py::_bwd. Its plain PyTorch
// transcription is kytpu_torch/kernels/bigscene.py::bwd_res_plain
// (bwd_lanes_plain, sort_rows, segment_sums_plain, kwf.sum_lanes); this file
// follows it statement by statement, and chip_smoke.py holds the two against
// each other.
//
// Design. bigscene_bwd_lanes: one thread per lane (128 a block). A lane
// reads its upstream gradient g, its radiance L and its column of the cache
// that K6 (bigscene_fwd.cu) wrote, and walks the bounces forward peeling the
// tail radiance R_{b+1} = (R_b - E_b) / T_b, every term bilinear in a cached
// coefficient, a cached colour and a light emission: no intersection, no
// random numbers. At thousands of rows a per-row accumulator does not fit a
// thread, so, as on the TPU, each lane writes its adjoints tagged with the
// row it hit: PB planes a bounce (dd, ds, de [, dexp]) and the horizon's
// de, plane-major. Its env and light-emission adjoints (3 + 3L columns) are
// summed over lanes by lane_sum.cuh's two passes, as K3's are. The host
// then sorts the (bounce, lane) entries by row tag with a stable integer
// sort (no float moves), and bigscene_segment_sums gives each row one block
// of SEG_THREADS threads: thread t adds the row's entries t, t + SEG_THREADS,
// ... in sorted order, then a shared-memory tree. No float atomics: the
// gradient repeats to the last bit and equals the plain version's.
//
// Textures (TEX, a compile-time switch): a textured row's diffuse adjoint
// goes to its texture, as in kytpu's kernel: the row comes from the cache,
// its texture record from the (M,) tex_rec table; a checker's adjoint to 6
// more lane columns a texture by the parity bit 22 of the int plane, an
// atlas's to the four taps rebuilt from the "tx"/"ty" planes (texture.cuh),
// as texel-tagged entries summed by texel by the segment sums; its
// row-tagged diffuse share is 0. The cached "dif" is already the textured
// value, so no texture table is read.
//
// What bounds it on the H100: bytes. The cache ((res_n + max_depth + 1) * 4
// B a lane), g and L are read once; the row-tagged planes ((PB * max_depth +
// 3) * 4 B a lane) are written and read back once more by the segment sums,
// whose longest row (the ground of a big scene) is one block's serial work.
// Built with --fmad=false and without fast math, as the forward is.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_sum.cuh"
#include "texture.cuh"

namespace {

using namespace kytpu;

constexpr int THREADS = LANE_THREADS;
constexpr int SEG_THREADS = 512;  // SEG_THREADS in bigscene.py
constexpr int MAX_PB = 10;        // dd, ds, de, dexp
constexpr int RES_PHONG = 1 << 20, RES_TO_SPEC = 1 << 21, RES_EVEN = 1 << 22,
              RES_ROW_MASK = (1 << 20) - 1;

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

// K6's cache planes (bigscene.py::bigres_layout, bigscene_fwd.cu BigRes)
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

__device__ __forceinline__ void add3(float* acc, int col, V v) {
  acc[col] = acc[col] + v.x;
  acc[col + 1] = acc[col + 1] + v.y;
  acc[col + 2] = acc[col + 2] + v.z;
}

// the textures K7 reads: the int table (header, lights, texture records),
// each row's texture record (-1: none); out, the texel entries and their tags
struct Tex {
  const int *I, *tex_rec;
  float* dout;
  int* tags;
};

template <bool TEX>
__global__ void __launch_bounds__(THREADS)
bigscene_bwd_lanes(const float* __restrict__ light_emit, const float* __restrict__ env_t,
                   const float* __restrict__ g_in, const float* __restrict__ l_in,
                   const float* __restrict__ resf, const int* __restrict__ resi,
                   float* __restrict__ dout, float* __restrict__ partial, int n, int L,
                   int has_env, int max_depth, int texp, int K, const Tex tx) {
  // the big-scene tables' header counts no planar, sphere or material
  // records: the texture records follow the lights
  const int* TXI = tx.I + HDR_I + LT_I * L;
  const bool has_img = TEX && __ldg(tx.I + H_IMG) != 0;
  BigRes rp;
  rp.env = has_env ? 1 : 0;
  rp.L = L;
  rp.texp = texp ? 1 : 0;
  rp.img = has_img ? 1 : 0;
  rp.stride = 11 + rp.env + L * (1 + rp.texp) + rp.texp + 2 * rp.img;
  const int PB = texp ? 10 : 9;
  const int col_ta = 3 + 3 * L, col_tb = col_ta + 3 * (TEX ? __ldg(tx.I + H_TEX) : 0);
  const V zero3 = V{0.f, 0.f, 0.f};
  // this lane's env (0-2), per-light emission (3 + 3i ..) and checker
  // (3 + 3L ..) adjoints
  float acc[TEX ? ROW_COLS : 3 + 3 * MAX_LIGHTS];
  for (int k = 0; k < K; ++k) acc[k] = 0.f;

  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane < n) {
    const V g = ld3(g_in + 3 * (size_t)lane);
    V r_tail = ld3(l_in + 3 * (size_t)lane);
    V beta = V{1.f, 1.f, 1.f};
    auto plane = [&](int k) { return resf[(size_t)k * n + lane]; };
    auto plane3 = [&](int k) { return V{plane(k), plane(k + 1), plane(k + 2)}; };
    auto put = [&](int k, float v) { dout[(size_t)k * n + lane] = v; };
    for (int b = 0; b <= max_depth; ++b) {
      const float wb = plane(rp.wb(b));
      const V emi = plane3(rp.emi(b, 0));
      const V gb = g * beta;
      const V de_b = gb * wb;
      V e_term = emi * wb;
      if (has_env) {
        const float wenv = plane(rp.wenv(b));
        e_term = e_term + ld3(env_t) * wenv;
        const V ae = gb * wenv;
        acc[0] = acc[0] + ae.x;
        acc[1] = acc[1] + ae.y;
        acc[2] = acc[2] + ae.z;
      }
      if (b == max_depth) {
        put(PB * b, de_b.x);
        put(PB * b + 1, de_b.y);
        put(PB * b + 2, de_b.z);
        break;
      }
      const int ib = resi[(size_t)b * n + lane];
      const bool phong = (ib & RES_PHONG) != 0;
      const bool spec_t = (ib & RES_TO_SPEC) != 0;
      const V dif = plane3(rp.dif(b, 0)), spc = plane3(rp.spc(b, 0));
      const V col_nee = sel(phong, spc, dif);
      V addc_diff = zero3, addc_spec = zero3;
      float addx = 0.f;
      for (int i = 0; i < L; ++i) {
        const float bp = plane(rp.B(b, i));
        const V e_l = ld3(light_emit + 3 * i);
        e_term = e_term + (col_nee * e_l) * bp;
        const V al = (gb * col_nee) * bp;
        acc[3 + 3 * i] = acc[3 + 3 * i] + al.x;
        acc[4 + 3 * i] = acc[4 + 3 * i] + al.y;
        acc[5 + 3 * i] = acc[5 + 3 * i] + al.z;
        const V addc = (gb * e_l) * bp;
        addc_spec = addc_spec + sel(phong, addc, zero3);
        addc_diff = addc_diff + sel(phong, zero3, addc);
        if (texp)
          addx = addx + (((gb.x * e_l.x) * col_nee.x + (gb.y * e_l.y) * col_nee.y) +
                         (gb.z * e_l.z) * col_nee.z) * plane(rp.Bk(b, i));
      }
      // extension: T_b = ext colour * tu; peel the tail radiance
      const float tu = plane(rp.tu(b));
      const V t_eff = sel(spec_t, spc, dif) * tu;
      const V r_next = V{safe_div(r_tail.x - e_term.x, t_eff.x),
                         safe_div(r_tail.y - e_term.y, t_eff.y),
                         safe_div(r_tail.z - e_term.z, t_eff.z)};
      const V addt = (gb * r_next) * tu;
      addc_spec = addc_spec + sel(spec_t, addt, zero3);
      addc_diff = addc_diff + sel(spec_t, zero3, addt);
      if (texp)
        // "tuk" is 0 off phong lanes, whose extension read the specular
        addx = addx + (((gb.x * r_next.x) * spc.x + (gb.y * r_next.y) * spc.y) +
                       (gb.z * r_next.z) * spc.z) * plane(rp.tuk(b));
      if (TEX) {
        // a textured row's diffuse adjoint goes to its texture
        const int row1 = ib & RES_ROW_MASK;
        const int trec = row1 > 0 ? __ldg(tx.tex_rec + row1 - 1) : -1;
        const int* ti = TXI + TX_I * (trec >= 0 ? trec : 0);
        const bool tex_img = trec >= 0 && __ldg(ti) != 0;
        if (trec >= 0 && !tex_img)
          add3(acc, ((ib & RES_EVEN) ? col_ta : col_tb) + 3 * __ldg(ti + 1), addc_diff);
        if (has_img) {
          Taps taps;
          if (tex_img)
            taps = image_taps(__ldg(ti + 2), __ldg(ti + 3), __ldg(ti + 4), plane(rp.tx(b)),
                              plane(rp.ty(b)));
          const bool sep = tex_img && __ldg(ti + 5) != 0;
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
      put(PB * b, addc_diff.x);
      put(PB * b + 1, addc_diff.y);
      put(PB * b + 2, addc_diff.z);
      put(PB * b + 3, addc_spec.x);
      put(PB * b + 4, addc_spec.y);
      put(PB * b + 5, addc_spec.z);
      put(PB * b + 6, de_b.x);
      put(PB * b + 7, de_b.y);
      put(PB * b + 8, de_b.z);
      if (texp) put(PB * b + 9, addx);
      beta = beta * t_eff;
      r_tail = r_next;
    }
  }
  block_partials(acc, K, partial);
}

// out[m - 1, c] = the sum of column c over row m's entries, m = 1 .. M, in
// sorted order (bigscene.py::segment_sums_plain). Entry e = b * n + i is
// bounce b of lane i: its columns are dout's planes PB*b .. PB*b+PB-1 below
// the horizon, and at the horizon 0 except de (columns 6-8).
__global__ void __launch_bounds__(SEG_THREADS)
bigscene_segment_sums(const float* __restrict__ dout, const int64_t* __restrict__ perm,
                      const int64_t* __restrict__ starts, float* __restrict__ out, int n,
                      int B, int PB) {
  __shared__ float s[SEG_THREADS];
  const int m = blockIdx.x + 1;
  const int64_t e0 = starts[m], e1 = starts[m + 1];
  float a[MAX_PB];
  for (int c = 0; c < MAX_PB; ++c) a[c] = 0.f;
  for (int64_t j = e0 + threadIdx.x; j < e1; j += SEG_THREADS) {
    const int64_t e = perm[j];
    const int64_t b = e / n;
    const int64_t lane = e - b * n;
    if (b < B) {
      for (int c = 0; c < PB; ++c) a[c] = a[c] + dout[(size_t)(PB * b + c) * n + lane];
    } else {
      for (int c = 6; c < 9; ++c) a[c] = a[c] + dout[(size_t)(PB * B + c - 6) * n + lane];
    }
  }
  for (int c = 0; c < PB; ++c) {
    s[threadIdx.x] = a[c];
    __syncthreads();
    for (int off = SEG_THREADS / 2; off > 0; off >>= 1) {
      if (threadIdx.x < off) s[threadIdx.x] = s[threadIdx.x] + s[threadIdx.x + off];
      __syncthreads();
    }
    if (threadIdx.x == 0) out[(size_t)blockIdx.x * PB + c] = s[0];
    __syncthreads();
  }
}

}  // namespace

// K7's per-lane pass on `stream` (PyTorch's current stream): the row-tagged
// adjoint planes dout ((PB * max_depth + 3), n) and, through the (max(1,
// ceil(n / 128)), n_cols) scratch `partial`, the (n_cols = 3 + 3L [+ 6T],)
// lane sums of the env, light-emission [and checker] adjoints in
// `lane_sums`; on a textured scene (I: the header, light and texture
// records, tex_rec (M,)) an image scene's texel entries tex_dout (12
// max_depth, n) and tags tex_tags (4 max_depth, n). Returns
// cudaGetLastError() (or cudaErrorInvalidValue for what it does not take).
extern "C" int kytpu_bigscene_bwd_res(const int* I, const int* tex_rec, const float* light_emit,
                                      const float* env, const float* g, const float* big_l,
                                      const float* resf, const int* resi, float* dout,
                                      float* partial, float* lane_sums, float* tex_dout,
                                      int* tex_tags, int n, int L, int has_env, int max_depth,
                                      int texp, int n_cols, int textured, void* stream) {
  if (L > MAX_LIGHTS || L < 0 || n_cols < 3 + 3 * L ||
      n_cols > (textured ? ROW_COLS : 3 + 3 * MAX_LIGHTS))
    return (int)cudaErrorInvalidValue;
  const int blocks = n > 0 ? (n + THREADS - 1) / THREADS : 1;
  const Tex tx{I, tex_rec, tex_dout, tex_tags};
  if (textured)
    bigscene_bwd_lanes<true><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        light_emit, env, g, big_l, resf, resi, dout, partial, n, L, has_env, max_depth, texp,
        n_cols, tx);
  else
    bigscene_bwd_lanes<false><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        light_emit, env, g, big_l, resf, resi, dout, partial, n, L, has_env, max_depth, texp,
        n_cols, tx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sum_partials(partial, lane_sums, blocks, n_cols, (cudaStream_t)stream);
}

// The sums by row: for each row m = 1 .. M, its entries perm[starts[m] ..
// starts[m + 1]) of the stable sort of the row tags -> out (M, PB). Returns
// cudaGetLastError().
extern "C" int kytpu_bigscene_segment_sums(const float* dout, const int64_t* perm,
                                           const int64_t* starts, float* out, int n, int M, int B,
                                           int PB, void* stream) {
  if (PB > MAX_PB || M < 0) return (int)cudaErrorInvalidValue;
  if (M > 0)
    bigscene_segment_sums<<<M, SEG_THREADS, 0, (cudaStream_t)stream>>>(dout, perm, starts, out, n,
                                                                        B, PB);
  return (int)cudaGetLastError();
}
