// A stand-in for the CUDA runtime header with which g++ compiles the port's
// CUDA sources (kytpu_torch/kernels/csrc) on a machine without nvcc, so that
// a host program can call their device functions one thread at a time
// (tests/test_torch_csrc_lane.py). Qualifiers compile away, the built-ins
// the lane bodies use have host definitions, and the runtime calls succeed
// and do nothing (the test strips the <<<...>>> launch configurations and
// never calls the extern "C" launchers). blockDim is 1 and threadIdx 0, so
// a block-cooperative loop runs whole on the one thread. The votes treat
// the calling thread as a warp of one (a lane harness that needs more
// emulates the warp itself), and so does the warp maximum
// (__reduce_max_sync); the shuffle aborts. With KYTPU_WARP_EMU
// defined, a harness runs a warp as 32 host threads instead: each sets its
// own threadIdx and blockIdx (blockDim is 32, a block a warp) and
// `warp_emu` to the warp's WarpVotes, and the votes are barriers of the
// threads in their mask, each thread waiting until every thread of the
// mask has cast its vote, as the card's warps vote (and take a maximum).
#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include <algorithm>
#include <cmath>
#ifdef KYTPU_WARP_EMU
#include <condition_variable>
#include <map>
#include <mutex>
#endif

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__ static
#define __shared__ static
#define __launch_bounds__(...)

using std::max;
using std::min;

struct float4 {
  float x, y, z, w;
};
struct int2 {
  int x, y;
};
struct uint3 {
  unsigned x, y, z;
};
#ifdef KYTPU_WARP_EMU
static thread_local uint3 threadIdx = {0, 0, 0}, blockIdx = {0, 0, 0};
static const uint3 blockDim = {32, 1, 1}, gridDim = {1, 1, 1};
#else
static const uint3 threadIdx = {0, 0, 0}, blockIdx = {0, 0, 0}, blockDim = {1, 1, 1},
                   gridDim = {1, 1, 1};
#endif

template <class T>
inline T __ldg(const T* p) { return *p; }
inline float __int_as_float(int i) {
  float f;
  memcpy(&f, &i, 4);
  return f;
}
inline float __uint_as_float(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline int __float_as_int(float f) {
  int i;
  memcpy(&i, &f, 4);
  return i;
}
// the high word of (hi:lo) << (shift & 31)
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, uint32_t shift) {
  return (uint32_t)(((((uint64_t)hi << 32) | lo) << (shift & 31)) >> 32);
}
inline uint32_t __brev(uint32_t x) {
  x = ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
  x = ((x >> 2) & 0x33333333u) | ((x & 0x33333333u) << 2);
  x = ((x >> 4) & 0x0F0F0F0Fu) | ((x & 0x0F0F0F0Fu) << 4);
  x = ((x >> 8) & 0x00FF00FFu) | ((x & 0x00FF00FFu) << 8);
  return (x >> 16) | (x << 16);
}
inline int __popc(uint32_t x) { return __builtin_popcount(x); }
inline int __ffs(uint32_t x) { return __builtin_ffs(x); }
inline void __syncthreads() {}
#ifdef KYTPU_WARP_EMU
// One emulated warp's votes: the threads of `mask` meet at a barrier of
// their own, which returns the ballot of their predicates
struct WarpVotes {
  struct Round {
    int arrived = 0;
    unsigned gen = 0;
    uint32_t ballot = 0, result = 0;
  };
  std::mutex m;
  std::condition_variable cv;
  std::map<uint32_t, Round> rounds;
  // each thread of `mask` folds its value into the round's with add(acc,
  // bit) and waits until every thread of the mask has -> the round's value
  template <class Add>
  uint32_t meet(uint32_t mask, Add&& add) {
    const uint32_t bit = 1u << (threadIdx.x & 31);
    if (!(mask & bit)) abort();  // a thread votes only in its own mask
    std::unique_lock<std::mutex> lk(m);
    Round& r = rounds[mask];
    const unsigned gen = r.gen;
    add(r.ballot, bit);
    if (++r.arrived == __builtin_popcount(mask)) {
      r.result = r.ballot;
      r.ballot = 0;
      r.arrived = 0;
      ++r.gen;
      cv.notify_all();
    } else {
      cv.wait(lk, [&] { return r.gen != gen; });
    }
    return r.result;
  }
  uint32_t vote(uint32_t mask, bool pred) {
    return meet(mask, [&](uint32_t& acc, uint32_t bit) { acc |= pred ? bit : 0u; });
  }
  // the largest v of the threads of `mask`
  uint32_t reduce_max(uint32_t mask, uint32_t v) {
    return meet(mask, [&](uint32_t& acc, uint32_t) { acc = std::max(acc, v); });
  }
};
static thread_local WarpVotes* warp_emu = nullptr;
inline uint32_t __ballot_sync(uint32_t mask, bool pred) { return warp_emu->vote(mask, pred); }
inline bool __any_sync(uint32_t mask, bool pred) { return warp_emu->vote(mask, pred) != 0; }
#else
inline uint32_t __ballot_sync(uint32_t mask, bool pred) { return pred ? mask & 1u : 0u; }
inline bool __any_sync(uint32_t mask, bool pred) { return pred && (mask & 1u); }
#endif
#ifdef KYTPU_WARP_EMU
inline unsigned __reduce_max_sync(uint32_t mask, unsigned v) {
  return warp_emu->reduce_max(mask, v);
}
#else
inline unsigned __reduce_max_sync(uint32_t mask, unsigned v) { return (mask & 1u) ? v : 0u; }
#endif
inline float __shfl_down_sync(uint32_t, float, int) { abort(); }
inline unsigned long long __shfl_down_sync(uint32_t, unsigned long long, int) { abort(); }
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  const unsigned long long old = *p;
  *p += v;
  return old;
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaDevAttrMultiProcessorCount = 16, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = 1;
  return cudaSuccess;
}
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
template <class T>
inline cudaError_t cudaMemcpyToSymbol(T& symbol, const void* src, size_t n) {
  memcpy(&symbol, src, n);
  return cudaSuccess;
}
