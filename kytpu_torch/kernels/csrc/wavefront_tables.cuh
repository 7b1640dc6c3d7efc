// What the wavefront kernels share: the layout of the two flat scene tables
// that kytpu_torch/kernels/wavefront.py::pack_tables writes, the enums of the
// JAX package, and the plane order of the coefficient cache
// (wavefront.py::residual_layout) that K2 writes and K3 reads.
#pragma once

namespace kytpu {

// table layout: must match kytpu_torch/kernels/wavefront.py
constexpr int HDR_I = 16, PL_I = 4, SP_I = 1, MAT_I = 2, LT_I = 3;
constexpr int HDR_F = 4, PL_F = 32, SP_F = 8, MAT_F = 4, LT_F = 28;
// one skip bit per light in a uint32 mask, one hit pdf per light in phits[]
constexpr int MAX_LIGHTS = 32;
constexpr int MAX_SURFACES = 64;

// kinds
constexpr int TRI = 0, RECT = 1, DISK = 2;
constexpr int LAMBERT = 0, MIRROR = 1, GLASS = 2, PHONG = 3;
constexpr int MAT_MATTE = 0, MAT_MIRROR = 1, MAT_GLASS = 2, MAT_PLASTIC = 3;
constexpr int L_POINT = 0, L_DIRECTION = 1, L_RECT = 2, L_SPHERE = 3, L_ENV = 4;

// int table header fields
constexpr int H_M = 2, H_L = 3, H_ENV_I = 9, H_SINGLE = 12, H_TEXP = 13;

// Coefficient cache, plane-major (plane k of lane i at k * n + i). Per
// bounce b: "wb", "wenv" (env scenes), then below the horizon n_b "B"
// planes (one per NEE light, one under nee="single") and "tu"; under
// trainable_exponent each "B" is followed by its "Bk" and "tu" by its
// "tuk". The int cache holds one plane per bounce: sid+1 in bits 0-7,
// lobe_is_phong in bit 8, to_spec_t in bit 9, the nee="single" pick in
// bits 11-15.
struct ResPlanes {
  int stride, env, n_b, texp;
  __device__ __forceinline__ int wb(int b) const { return b * stride; }
  __device__ __forceinline__ int wenv(int b) const { return b * stride + 1; }
  __device__ __forceinline__ int B(int b, int i) const {
    return b * stride + 1 + env + i * (1 + texp);
  }
  __device__ __forceinline__ int Bk(int b, int i) const { return B(b, i) + 1; }
  __device__ __forceinline__ int tu(int b) const {
    return b * stride + 1 + env + n_b * (1 + texp);
  }
  __device__ __forceinline__ int tuk(int b) const { return tu(b) + 1; }
};

__device__ __forceinline__ ResPlanes res_planes(int has_env, int single, int n_lights,
                                                int texp) {
  ResPlanes r;
  r.env = has_env ? 1 : 0;
  r.n_b = single ? 1 : n_lights;
  r.texp = texp ? 1 : 0;
  r.stride = 2 + r.env + r.n_b * (1 + r.texp) + r.texp;
  return r;
}

constexpr int RESI_PHONG = 1 << 8, RESI_TO_SPEC = 1 << 9, RESI_PICK_SHIFT = 11;

}  // namespace kytpu
