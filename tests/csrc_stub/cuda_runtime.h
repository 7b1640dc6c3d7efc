// A stand-in for the CUDA runtime header with which g++ compiles the port's
// CUDA sources (kytpu_torch/kernels/csrc) on a machine without nvcc, so that
// a host program can call their device functions one thread at a time
// (tests/test_torch_csrc_lane.py). Qualifiers compile away, the built-ins
// the lane bodies use have host definitions, and the runtime calls succeed
// and do nothing (the test strips the <<<...>>> launch configurations and
// never calls the extern "C" launchers). blockDim is 1 and threadIdx 0, so
// a block-cooperative loop runs whole on the one thread. The warp built-ins
// abort: a lane harness emulates the warp itself.
#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include <algorithm>
#include <cmath>

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
struct uint3 {
  unsigned x, y, z;
};
static const uint3 threadIdx = {0, 0, 0}, blockIdx = {0, 0, 0}, blockDim = {1, 1, 1};

template <class T>
inline T __ldg(const T* p) { return *p; }
inline float __int_as_float(int i) {
  float f;
  memcpy(&f, &i, 4);
  return f;
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
inline uint32_t __ballot_sync(uint32_t, bool) { abort(); }
inline bool __any_sync(uint32_t, bool) { abort(); }
inline float __shfl_down_sync(uint32_t, float, int) { abort(); }

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
