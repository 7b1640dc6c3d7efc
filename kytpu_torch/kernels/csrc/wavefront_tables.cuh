// What the wavefront kernels share: the layout of the two flat scene tables
// that kytpu_torch/kernels/wavefront.py::pack_tables writes, the enums of the
// JAX package, and the plane order of the coefficient cache
// (wavefront.py::residual_layout) that K2 writes and K3 reads.
#pragma once

#include <cuda_runtime.h>

namespace kytpu {

// table layout: must match kytpu_torch/kernels/wavefront.py
constexpr int HDR_I = 17, PL_I = 4, SP_I = 1, MAT_I = 3, LT_I = 3, TX_I = 6;
constexpr int HDR_F = 4, PL_F = 32, SP_F = 8, MAT_F = 4, LT_F = 28, TX_F = 12;
// one skip bit per light in a uint32 mask (the hit pdf of a light is
// recomputed from the previous vertex, light_phit)
constexpr int MAX_LIGHTS = 32;
// K3 and K4 keep a dense row of adjoint columns a thread for scenes of at
// most this many surfaces, and write row-tagged entries past it
// (DENSE_MAX_ROWS in wavefront.py)
constexpr int DENSE_MAX_ROWS = 64;
// K3 and K4 keep 6 checker-adjoint columns a texture in a thread
constexpr int MAX_TEXTURES = 64;

// kinds
constexpr int TRI = 0, RECT = 1, DISK = 2;
constexpr int LAMBERT = 0, MIRROR = 1, GLASS = 2, PHONG = 3;
constexpr int MAT_MATTE = 0, MAT_MIRROR = 1, MAT_GLASS = 2, MAT_PLASTIC = 3;
constexpr int L_POINT = 0, L_DIRECTION = 1, L_RECT = 2, L_SPHERE = 3, L_ENV = 4;

// int table header fields
constexpr int H_M = 2, H_L = 3, H_ENV_I = 9, H_SINGLE = 12, H_TEXP = 13, H_TREC = 14, H_TEX = 15,
              H_IMG = 16;

// Coefficient cache, plane-major (plane k of lane i at k * n + i). Per
// bounce b: "wb", "wenv" (env scenes), then below the horizon n_b "B"
// planes (one per NEE light, one under nee="single") and "tu"; under
// trainable_exponent each "B" is followed by its "Bk" and "tu" by its
// "tuk"; with image textures "tx", "ty" follow. The int cache holds one
// plane per bounce: sid+1 in bits 0-7 and 16-30 (pack_row), lobe_is_phong
// in bit 8, to_spec_t in bit 9, the checker parity in bit 10, the
// nee="single" pick in bits 11-15.
struct ResPlanes {
  int stride, env, n_b, texp, img;
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
  __device__ __forceinline__ int tx(int b) const { return tu(b) + 1 + texp; }
  __device__ __forceinline__ int ty(int b) const { return tx(b) + 1; }
};

__device__ __forceinline__ ResPlanes res_planes(int has_env, int single, int n_lights,
                                                int texp, int img) {
  ResPlanes r;
  r.env = has_env ? 1 : 0;
  r.n_b = single ? 1 : n_lights;
  r.texp = texp ? 1 : 0;
  r.img = img ? 1 : 0;
  r.stride = 2 + r.env + r.n_b * (1 + r.texp) + r.texp + 2 * r.img;
  return r;
}

constexpr int RESI_PHONG = 1 << 8, RESI_TO_SPEC = 1 << 9, RESI_EVEN = 1 << 10,
              RESI_PICK_SHIFT = 11;

// the int cache's row field (wavefront.py pack_row, unpack_row): r1 = row
// + 1 in bits 0-7, as kytpu writes it, and its high part in bits 16-30, so
// a scene past 254 surfaces does not run into the lobe bits
__host__ __device__ __forceinline__ int pack_row(int r1) { return (r1 & 255) | ((r1 >> 8) << 16); }
__host__ __device__ __forceinline__ int unpack_row(int ib) { return (ib & 255) | ((ib >> 16) << 8); }

}  // namespace kytpu
