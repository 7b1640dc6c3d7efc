// Camera jitter and primary rays for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: on the TPU, jax.random (Threefry-2x32) and XLA
// make the camera jitter and the rays of kytpu's train step and frame passes
// (kytpu/diff/inverse.py, kytpu/kernels/wavefront.py::render_pallas). Here
// one launch a train step and one a frame pass makes them, in place of the
// chain of int64 and float64 torch ops that is its plain version
// (kytpu_torch/kernels/camera.py::lane_rays_plain: core/rng.py's draws, then
// scene/scene.py::generate_rays), and gives the same bits.
//
// Lane l of n, at pixel q = l % npix of a film w pixels wide:
//   random: the words of counters 2l and 2l + 1 of bits(key, 2n);
//   hash:   the lane's key fold_in(key, base + l) (base = the sample base
//           times npix, all mod 2^32) and the words of its counters 0, 1;
//   u = float((word >> 9) | 0x3F800000) - 1, at least 0, for each film axis;
//   the film point (q % w + u0, q / w + u1) and its direction as
//   generate_rays rounds it: each multiply-add in double, rounded once to
//   float; the norm's first square in float, then two multiply-adds in
//   double; the root a double root rounded to float; one IEEE division.
//
// What bounds it on the H100: int32 operations. A Threefry-2x32 block is 20
// rounds of add, rotate and xor and 5 key injections, about 80 operations; a
// lane takes two blocks (random) or three (hash). At the train step's
// 10,092,544 lanes that is about 1.6 G operations, 0.097 ms at the card's
// 16.7 T int32 operations a second (132 SMs x 64 int32 lanes x 1.98 GHz).
// Bytes are the lesser limit: a lane reads nothing and writes its 12-byte
// direction, 121 MB, 0.036 ms at 3.35 TB/s.
//
// Design: one lane a thread, everything in registers. The key words, the
// mode, the film and the camera's basis come as kernel arguments, nothing is
// read from device memory and no shared memory is used; each lane writes its
// direction once (three neighbouring floats: a warp's stores are 384
// contiguous bytes). Rotations are __funnelshift_l. Built with --fmad=false
// and no fast math; the double multiply-adds would round alike fused, since
// the product of two floats is exact in double.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RAYS_THREADS = 256;
constexpr int MODE_RANDOM = 0, MODE_HASH = 1;  // camera.py MODES

struct RayArgs {
  float* d;  // (n, 3)
  int n, npix, w, mode;
  uint32_t k0, k1, base;
  float inv_w, inv_h;               // float32(1 / W), float32(1 / H)
  float front[3], right[3], up[3];  // the camera's basis
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

// four rounds of Threefry-2x32 with rotations a, b, c, e
__device__ __forceinline__ void rounds4(uint32_t& x0, uint32_t& x1, int a, int b, int c, int e) {
  x0 += x1;
  x1 = rotl(x1, a) ^ x0;
  x0 += x1;
  x1 = rotl(x1, b) ^ x0;
  x0 += x1;
  x1 = rotl(x1, c) ^ x0;
  x0 += x1;
  x1 = rotl(x1, e) ^ x0;
}

// Threefry-2x32 (20 rounds) of the counter (x0, x1) under the key (k0, k1),
// in place: core/rng.py threefry2x32
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  rounds4(x0, x1, 13, 15, 26, 6);
  x0 += k1;
  x1 += k2 + 1u;
  rounds4(x0, x1, 17, 29, 16, 24);
  x0 += k2;
  x1 += k0 + 2u;
  rounds4(x0, x1, 13, 15, 26, 6);
  x0 += k0;
  x1 += k1 + 3u;
  rounds4(x0, x1, 17, 29, 16, 24);
  x0 += k1;
  x1 += k2 + 4u;
  rounds4(x0, x1, 13, 15, 26, 6);
  x0 += k2;
  x1 += k0 + 5u;
}

// bits(key, .)'s word of counter c: the xor of the block's two outputs
__device__ __forceinline__ uint32_t word(uint32_t k0, uint32_t k1, uint32_t c) {
  uint32_t x0 = 0u, x1 = c;
  threefry(k0, k1, x0, x1);
  return x0 ^ x1;
}

// core/rng.py uniform: a word's top 23 bits as a float in [0, 1)
__device__ __forceinline__ float unit(uint32_t w) {
  const float u = __uint_as_float((w >> 9) | 0x3F800000u) - 1.0f;
  return u > 0.0f ? u : 0.0f;
}

// round(a * b + c) to float, taken in double (generate_rays' fma)
__device__ __forceinline__ float fma_d(float a, float b, float c) {
  return (float)((double)a * (double)b + (double)c);
}

// lane l's direction into d[0 .. 2]
__device__ __forceinline__ void camera_ray(const RayArgs& a, uint32_t l, float* d) {
  uint32_t w0, w1;
  if (a.mode == MODE_HASH) {
    uint32_t y0 = 0u, y1 = a.base + l;  // fold_in(key, base + l)
    threefry(a.k0, a.k1, y0, y1);
    w0 = word(y0, y1, 0u);
    w1 = word(y0, y1, 1u);
  } else {
    w0 = word(a.k0, a.k1, 2u * l);
    w1 = word(a.k0, a.k1, 2u * l + 1u);
  }
  const uint32_t q = l % (uint32_t)a.npix;
  const float px = (float)(q % (uint32_t)a.w) + unit(w0);
  const float py = (float)(q / (uint32_t)a.w) + unit(w1);
  const float sx = fma_d(px, a.inv_w, -0.5f);
  const float sy = fma_d(-py, a.inv_h, 0.5f);
  float v[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = fma_d(sy, a.up[c], fma_d(sx, a.right[c], a.front[c]));
  float s = v[0] * v[0];
  s = fma_d(v[1], v[1], s);
  s = fma_d(v[2], v[2], s);
  const float root = (float)sqrt((double)s);
#pragma unroll
  for (int c = 0; c < 3; ++c) d[c] = v[c] / root;
}

__global__ void __launch_bounds__(RAYS_THREADS) camera_rays_kernel(const RayArgs a) {
  const size_t l = (size_t)blockIdx.x * RAYS_THREADS + threadIdx.x;
  if (l >= (size_t)a.n) return;
  camera_ray(a, (uint32_t)l, a.d + 3 * l);
}

}  // namespace

// The directions d (n, 3) float32 of lanes 0 .. n - 1 on `stream` (mode 0
// "random", 1 "hash" with base = sample base * npix mod 2^32; see above).
// Returns cudaGetLastError() (or cudaErrorInvalidValue for what it does not
// take).
extern "C" int kytpu_camera_rays(float* d, int n, int npix, int w, int mode, unsigned k0,
                                 unsigned k1, unsigned base, float inv_w, float inv_h, float f0,
                                 float f1, float f2, float r0, float r1, float r2, float up0,
                                 float up1, float up2, void* stream) {
  if (n < 0 || npix <= 0 || w <= 0 || (mode != MODE_RANDOM && mode != MODE_HASH))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const RayArgs a{d,     n,     npix,         w,            mode,          k0, k1,
                  base,  inv_w, inv_h, {f0, f1, f2}, {r0, r1, r2}, {up0, up1, up2}};
  const int blocks = (int)(((long long)n + RAYS_THREADS - 1) / RAYS_THREADS);
  camera_rays_kernel<<<blocks, RAYS_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
