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
// of 9M+3 floats (dd, ds, de, denv), indexed at run time, so it lives in
// local memory: 408 B a thread at Veach's M = 11, 2.3 KB at M = 64.
//
// The TPU kernel carries its accumulators across a sequential grid; blocks
// here run in no order, so the sum over lanes is two passes in a fixed
// order and without atomics, and the gradient repeats to the last bit: each
// block reduces its lanes (a shuffle tree inside each warp, then
// (w0 + w1) + (w2 + w3)) into one row of a (blocks, 9M+3) partials table;
// sum_partials_kernel reduces each column (thread t adds rows t, t + 256, ...
// in turn, then a shared-memory tree). sum_lanes in wavefront.py does the
// same additions in the same order.
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

#include "wavefront_tables.cuh"

namespace {

using namespace kytpu;

constexpr int THREADS = 128;       // BWD_THREADS in wavefront.py
constexpr int SUM_THREADS = 256;   // SUM_THREADS in wavefront.py
constexpr int MAX_COLS = 9 * MAX_SURFACES + 3;

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

__device__ __forceinline__ void add3(float* acc, int col, V v) {
  acc[col] = acc[col] + v.x;
  acc[col + 1] = acc[col + 1] + v.y;
  acc[col + 2] = acc[col + 2] + v.z;
}

__global__ void __launch_bounds__(THREADS)
bwd_res_kernel(const int* __restrict__ I, const float* __restrict__ diffuse_t,
               const float* __restrict__ specular_t, const float* __restrict__ emission_t,
               const float* __restrict__ light_emit_t, const float* __restrict__ env_t,
               const float* __restrict__ g_in, const float* __restrict__ l_in,
               const float* __restrict__ resf, const int* __restrict__ resi,
               float* __restrict__ partial, int n, int max_depth) {
  const int n_pl = __ldg(I), n_sp = __ldg(I + 1);
  const int M = __ldg(I + H_M), L = __ldg(I + H_L);
  const int* MATI = I + HDR_I + PL_I * n_pl + SP_I * n_sp;
  const int* LTI = MATI + MAT_I * M;
  const bool single = __ldg(I + H_SINGLE) != 0;
  const bool has_env = __ldg(I + H_ENV_I) >= 0;
  const ResPlanes rp = res_planes(has_env, single, L);
  const int K = 9 * M + 3;
  const int col_d = 0, col_s = 3 * M, col_e = 6 * M, col_env = 9 * M;
  const V zero3 = V{0.f, 0.f, 0.f};

  float acc[MAX_COLS];
  for (int k = 0; k < K; ++k) acc[k] = 0.f;

  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane < n) {
    const V g = ld3(g_in + 3 * (size_t)lane);
    V r_tail = ld3(l_in + 3 * (size_t)lane);
    V beta = V{1.f, 1.f, 1.f};
    auto plane = [&](int k) { return resf[(size_t)k * n + lane]; };
    for (int b = 0; b <= max_depth; ++b) {
      const int ib = resi[(size_t)b * n + lane];
      const int sid = (ib & 255) - 1;
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
      if (ok_e) add3(acc, col_e + 3 * sid, gb * wb);
      float wenv = 0.f;
      if (has_env) {
        wenv = plane(rp.wenv(b));
        add3(acc, col_env, gb * wenv);
      }
      if (b == max_depth) break;

      const bool phong = (ib & RESI_PHONG) != 0;
      const bool to_spec = (ib & RESI_TO_SPEC) != 0;
      const V diff_sel = ok_d ? ld3(diffuse_t + 3 * sid) : zero3;
      const V spec_sel = ok_s ? ld3(specular_t + 3 * sid) : zero3;
      const V emit_sel = ok_e ? ld3(emission_t + 3 * sid) : zero3;
      const V col_nee = sel(phong, spec_sel, diff_sel);
      V e_term = emit_sel * wb;
      if (has_env) e_term = e_term + ld3(env_t) * wenv;
      V addc = zero3;
      for (int j = 0; j < rp.n_b; ++j) {
        const int light = single ? (ib >> RESI_PICK_SHIFT) & 31 : j;
        const float bp = plane(rp.B(b, j));
        const V e_l = ld3(light_emit_t + 3 * light);
        e_term = e_term + (col_nee * e_l) * bp;
        const V add = (gb * col_nee) * bp;
        // the NEE emission adjoint: to the light's emitting row, or to env
        const int lrow = __ldg(LTI + LT_I * light + 2);
        if (lrow >= 0)
          add3(acc, col_e + 3 * lrow, add);
        else if (__ldg(LTI + LT_I * light) == L_ENV)
          add3(acc, col_env, add);
        addc = addc + (gb * e_l) * bp;
      }
      const float tu = plane(rp.tu(b));
      const V t_eff = sel(to_spec, spec_sel, diff_sel) * tu;
      const V r_next = V{safe_div(r_tail.x - e_term.x, t_eff.x),
                         safe_div(r_tail.y - e_term.y, t_eff.y),
                         safe_div(r_tail.z - e_term.z, t_eff.z)};
      const V addt = (gb * r_next) * tu;
      if (ok_d) add3(acc, col_d + 3 * sid, sel(phong, zero3, addc) + sel(to_spec, zero3, addt));
      if (ok_s) add3(acc, col_s + 3 * sid, sel(phong, addc, zero3) + sel(to_spec, addt, zero3));
      beta = beta * t_eff;
      r_tail = r_next;
    }
  }

  // this block's partial sums: a shuffle tree in each warp, then the warps
  __shared__ float warp_sum[THREADS / 32][MAX_COLS];
  const int wid = threadIdx.x / 32, lid = threadIdx.x % 32;
  for (int k = 0; k < K; ++k) {
    float v = acc[k];
    for (int off = 16; off > 0; off >>= 1) v = v + __shfl_down_sync(0xffffffffu, v, off);
    if (lid == 0) warp_sum[wid][k] = v;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += THREADS)
    partial[(size_t)blockIdx.x * K + k] =
        (warp_sum[0][k] + warp_sum[1][k]) + (warp_sum[2][k] + warp_sum[3][k]);
}

// out[k] = sum over the nb rows of partial[:, k], one block a column
__global__ void __launch_bounds__(SUM_THREADS)
sum_partials_kernel(const float* __restrict__ partial, float* __restrict__ out, int nb, int K) {
  __shared__ float s[SUM_THREADS];
  const int k = blockIdx.x;
  float v = 0.f;
  for (int b = threadIdx.x; b < nb; b += SUM_THREADS) v = v + partial[(size_t)b * K + k];
  s[threadIdx.x] = v;
  __syncthreads();
  for (int off = SUM_THREADS / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) s[threadIdx.x] = s[threadIdx.x] + s[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[k] = s[0];
}

}  // namespace

// K3 on `stream` (PyTorch's current stream): the table adjoints as one
// (9 * m_rows + 3,) vector dd | ds | de | denv in `out`, through the
// (max(1, ceil(n / 128)), 9 * m_rows + 3) scratch `partial`. Returns
// cudaGetLastError().
extern "C" int kytpu_wavefront_bwd_res(const int* I, const float* diffuse, const float* specular,
                                       const float* emission, const float* light_emit,
                                       const float* env, const float* g, const float* big_l,
                                       const float* resf, const int* resi, float* partial,
                                       float* out, int n, int m_rows, int max_depth,
                                       void* stream) {
  const int K = 9 * m_rows + 3;
  const int blocks = n > 0 ? (n + THREADS - 1) / THREADS : 1;
  bwd_res_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      I, diffuse, specular, emission, light_emit, env, g, big_l, resf, resi, partial, n,
      max_depth);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<K, SUM_THREADS, 0, (cudaStream_t)stream>>>(partial, out, blocks, K);
  return (int)cudaGetLastError();
}
