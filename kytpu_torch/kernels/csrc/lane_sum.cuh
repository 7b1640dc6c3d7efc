// The fixed-order sums over lanes that the backwards share: K3
// (wavefront_bwd_res.cu), K4 (wavefront_fwd.cu, MODE_REPLAY), K7
// (bigscene_bwd_res.cu) and K8 (bigscene_fwd.cu, MODE_REPLAY).
//
// The TPU kernels carry their per-lane accumulators across a sequential
// grid; blocks here run in no order, so each sum is two passes in a fixed
// order and without atomics, and a gradient repeats to the last bit.
//
// K3 and K4 (column sums): a thread's adjoint row is a column of the
// block's (K, LANE_THREADS) accumulator, in dynamic shared memory (ColAcc,
// column k of thread t at k * LANE_THREADS + t: a warp's 32 threads on 32
// banks whatever column each adds to), or, where that does not fit, a row
// of its own in local memory (RowAcc) that block_row_sums passes through
// shared memory 32 columns at a time. Either way the block sums column k
// as four chains, one a warp, each over the warp's 32 threads in thread
// order from thread k % 32 on, wrapping round (so a warp's 32 threads read
// 32 banks), and adds the four as (q0 + q1) + (q2 + q3), into row k of a
// column-major (K, blocks) partials table; sum_cols_kernel reduces each
// row (thread t adds blocks t, t + SUM_THREADS, ... in turn, then a
// shared-memory tree, reading coalesced rows). The two routes add the same
// floats in the same order. kytpu_torch/kernels/wavefront.py::sum_columns
// does the same.
//
// K7 and K8 (block_partials, sum_partials): each block of LANE_THREADS
// lanes reduces its per-thread rows (a shuffle tree inside each warp, then
// (w0 + w1) + (w2 + w3)) into one row of a (blocks, K) partials table;
// sum_partials_kernel reduces each column in the order above.
// wavefront.py::sum_lanes does the same additions in the same order.
#pragma once

#include <cuda_runtime.h>

#include "wavefront_tables.cuh"

// Everything here has internal linkage (static): each source that includes
// the header gets its own copy.
namespace kytpu {

constexpr int LANE_THREADS = 128;  // BWD_THREADS in wavefront.py
constexpr int SUM_THREADS = 256;   // SUM_THREADS in wavefront.py
// the most dynamic shared memory a block may opt in to on the H100
constexpr int MAX_SMEM = 227 * 1024;
// K3's and K4's dense row: dd, ds, de (3M each), denv (3), dexp (M), dta,
// dtb (3T each)
constexpr int MAX_COLS = 10 * DENSE_MAX_ROWS + 3 + 6 * MAX_TEXTURES;
// a dense row's columns at most: the kept ones and the one no lane adds to
constexpr int MAX_ROW = MAX_COLS + 1;
// the row-tagged backwards' lane columns (K3 and K4 past DENSE_MAX_ROWS
// surfaces, K7, K8): denv (3), each light's emission (3L), dta, dtb (3T
// each)
constexpr int ROW_COLS = 3 + 3 * MAX_LIGHTS + 6 * MAX_TEXTURES;

// K3's and K4's accumulator routes (wavefront.py ACC_ROUTES)
enum AccRoute { ACC_LOCAL = 0, ACC_SHARED = 1 };

// K3's and K4's views of a thread's adjoint row. The kernels name a column
// by its place in the gradient vector (wavefront.py split_grads); `cmap`
// (wavefront.py acc_map) sends it to the row's column: only the columns a
// lane of the scene can add to are kept, in order, and the others go to one
// last column that no lane adds to and the host drops. at(col) is column
// col's float, the next column of the row STRIDE floats on.
//
// ACC_LOCAL: a row of its own (local memory)
struct RowAcc {
  static constexpr int STRIDE = 1;
  float* p;
  const int* cmap;
  __device__ __forceinline__ float* at(int col) const { return p + __ldg(cmap + col); }
};
// ACC_SHARED: this thread's column of the block's accumulator in shared
// memory, row column k at p[k * LANE_THREADS], p the accumulator plus
// threadIdx.x
struct ColAcc {
  static constexpr int STRIDE = LANE_THREADS;
  float* p;
  const int* cmap;
  __device__ __forceinline__ float* at(int col) const {
    return p + __ldg(cmap + col) * LANE_THREADS;
  }
};

// Columns k0 .. k0 + kc - 1 (kc <= 32) of the block's accumulator, column
// k0 + j of thread t at c[j * LANE_THREADS + t], summed into
// partial[k * nb + blockIdx.x]: each of the block's four warps (quarters)
// sums its 32 threads in thread order from thread k % 32 on, wrapping round
// (a warp's 32 threads then read 32 banks), and the quarters add as (q0 +
// q1) + (q2 + q3). Overwrites the columns; every thread of the block must
// call it.
static __device__ __forceinline__ void col_sums(float* c, int k0, int kc, float* partial, int nb) {
  static_assert(LANE_THREADS == 128, "four quarters a block");
  const int l = threadIdx.x & 31, q = threadIdx.x >> 5;
  float s = 0.f;
  if (l < kc) {
    const float* col = c + l * LANE_THREADS + 32 * q;
    const int r = (k0 + l) & 31;
    s = col[r];
#pragma unroll 8
    for (int i = 1; i < 32; ++i) s = s + col[(r + i) & 31];
  }
  __syncthreads();
  if (l < kc) c[l * LANE_THREADS + 4 * l + q] = s;
  __syncthreads();
  if (threadIdx.x < kc) {
    const float* w = c + threadIdx.x * LANE_THREADS + 4 * threadIdx.x;
    partial[(size_t)(k0 + threadIdx.x) * nb + blockIdx.x] = (w[0] + w[1]) + (w[2] + w[3]);
  }
}

// the shared route: the block's (K, LANE_THREADS) accumulator `cols` ->
// its column sums in partial (K, nb); every thread of the block must call it
static __device__ __forceinline__ void block_col_sums(float* cols, int K, float* partial, int nb) {
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += 32)
    col_sums(cols + k0 * LANE_THREADS, k0, K - k0 < 32 ? K - k0 : 32, partial, nb);
}

// the local route: each thread's row acc[0..K) -> the same column sums, the
// rows passed through shared memory 32 columns at a time; every thread of
// the block must call it
static __device__ __forceinline__ void block_row_sums(const float* acc, int K, float* partial,
                                                      int nb) {
  __shared__ float buf[32 * LANE_THREADS];
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int kc = K - k0 < 32 ? K - k0 : 32;
    __syncthreads();
    for (int j = 0; j < kc; ++j) buf[j * LANE_THREADS + threadIdx.x] = acc[k0 + j];
    __syncthreads();
    col_sums(buf, k0, kc, partial, nb);
  }
}

// out[c] = the sum over the nb entries of row cmap[c] of partial (rows,
// nb), in sum_partials_kernel's order, or 0 where cmap[c] >= kept (the
// column no lane adds to); one block an entry of out
static __global__ void __launch_bounds__(SUM_THREADS)
sum_cols_kernel(const float* __restrict__ partial, float* __restrict__ out, int nb,
                const int* __restrict__ cmap, int kept) {
  __shared__ float s[SUM_THREADS];
  const int k = __ldg(cmap + blockIdx.x);
  if (k >= kept) {
    if (threadIdx.x == 0) out[blockIdx.x] = 0.f;
    return;
  }
  const float* row = partial + (size_t)k * nb;
  float v = 0.f;
  for (int b = threadIdx.x; b < nb; b += SUM_THREADS) v = v + row[b];
  s[threadIdx.x] = v;
  __syncthreads();
  for (int off = SUM_THREADS / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) s[threadIdx.x] = s[threadIdx.x] + s[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = s[0];
}

// K3's and K4's second pass on `stream`: the n_out entries of the gradient
// vector out of the kept rows of partial; returns cudaGetLastError()
static inline int sum_cols(const float* partial, float* out, int nb, const int* cmap, int kept,
                           int n_out, cudaStream_t stream) {
  sum_cols_kernel<<<n_out, SUM_THREADS, 0, stream>>>(partial, out, nb, cmap, kept);
  return (int)cudaGetLastError();
}

// K7's and K8's first pass:
// this block's partial sums of acc[0..K) into row blockIdx.x of `partial`;
// every thread of the block must call it
static __device__ __forceinline__ void block_partials(const float* acc, int K, float* partial) {
  __shared__ float warp_sum[LANE_THREADS / 32][MAX_COLS];
  const int wid = threadIdx.x / 32, lid = threadIdx.x % 32;
  for (int k = 0; k < K; ++k) {
    float v = acc[k];
    for (int off = 16; off > 0; off >>= 1) v = v + __shfl_down_sync(0xffffffffu, v, off);
    if (lid == 0) warp_sum[wid][k] = v;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += LANE_THREADS)
    partial[(size_t)blockIdx.x * K + k] =
        (warp_sum[0][k] + warp_sum[1][k]) + (warp_sum[2][k] + warp_sum[3][k]);
}

// out[k] = sum over the nb rows of partial[:, k], one block a column
static __global__ void __launch_bounds__(SUM_THREADS)
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

// K7's and K8's second pass on `stream`; returns cudaGetLastError()
static inline int sum_partials(const float* partial, float* out, int nb, int K, cudaStream_t stream) {
  sum_partials_kernel<<<K, SUM_THREADS, 0, stream>>>(partial, out, nb, K);
  return (int)cudaGetLastError();
}

}  // namespace kytpu
