// The fixed-order sum over lanes that the backwards share: K3
// (wavefront_bwd_res.cu), K4 (wavefront_fwd.cu, MODE_REPLAY), K7
// (bigscene_bwd_res.cu) and K8 (bigscene_fwd.cu, MODE_REPLAY).
//
// The TPU kernels carry their per-lane accumulators across a sequential
// grid; blocks here run in no order, so the sum is two passes in a fixed
// order and without atomics, and a gradient repeats to the last bit: each
// block of LANE_THREADS lanes reduces its per-thread accumulator rows (a
// shuffle tree inside each warp, then (w0 + w1) + (w2 + w3)) into one row
// of a (blocks, K) partials table; sum_partials_kernel reduces each column
// (thread t adds rows t, t + SUM_THREADS, ... in turn, then a
// shared-memory tree). kytpu_torch/kernels/wavefront.py::sum_lanes does the
// same additions in the same order.
#pragma once

#include <cuda_runtime.h>

#include "wavefront_tables.cuh"

// Everything here has internal linkage (static): each source that includes
// the header gets its own copy.
namespace kytpu {

constexpr int LANE_THREADS = 128;  // BWD_THREADS in wavefront.py
constexpr int SUM_THREADS = 256;   // SUM_THREADS in wavefront.py
// K3's and K4's dense row: dd, ds, de (3M each), denv (3), dexp (M), dta,
// dtb (3T each)
constexpr int MAX_COLS = 10 * DENSE_MAX_ROWS + 3 + 6 * MAX_TEXTURES;
// the row-tagged backwards' lane columns (K3 and K4 past DENSE_MAX_ROWS
// surfaces, K7, K8): denv (3), each light's emission (3L), dta, dtb (3T
// each)
constexpr int ROW_COLS = 3 + 3 * MAX_LIGHTS + 6 * MAX_TEXTURES;

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

// the second pass on `stream`; returns cudaGetLastError()
static inline int sum_partials(const float* partial, float* out, int nb, int K, cudaStream_t stream) {
  sum_partials_kernel<<<K, SUM_THREADS, 0, stream>>>(partial, out, nb, K);
  return (int)cudaGetLastError();
}

}  // namespace kytpu
