// The bilinear image fetch that the textured kernels share: K1, K2 and K4
// (wavefront_fwd.cu) and K3 (wavefront_bwd_res.cu).
//
// kytpu fetches an atlas of at most 64 texels with power-of-two sides
// through a select chain over every texel (wavefront.py::_image_color) and
// any other through two MXU contractions (_image_sep_color); both exist
// because the TPU has no per-lane gather. Here every atlas is one explicit
// four-tap gather from the (Ti*H*W, 3) table in global memory through
// __ldg, with kytpu's tap indices (the wrap of _image_sep_axes, which
// equals _image_taps_from_xy's mask on power-of-two sides) and its f32
// weights, and each route's addition order: texel order for the select
// chain, each row's two columns and then the rows for the separable route.
// No texture object with hardware filtering: its low-precision fractional
// weights are another function. Plain version: kernels/wavefront.py
// `_image_taps`, `_image_color`, `_texel_entries`.
#pragma once

#include <cuda_runtime.h>

// Everything here has internal linkage (static): each source that includes
// the header gets its own copy.
namespace kytpu {

// The four taps of texel coordinates (x, y), in ascending texel order: slot
// 2a + b is the a-th lowest row and the b-th lowest column. A tap that
// coincides with another (a side of one texel) is merged into the first
// slot; the others are unused (t = -1). w: the select chain's weight, its
// per-texel sum of tap weights in tap order; wr, wc: the separable route's
// row and column weights.
struct Taps {
  int t[4];
  float w[4], wr[4], wc[4];
};

static __device__ __forceinline__ Taps image_taps(int img, int tw, int th, float x, float y) {
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = x - x0, fy = y - y0;
  int xi0 = (int)x0, yi0 = (int)y0;
  xi0 = xi0 < 0 ? tw - 1 : xi0;
  yi0 = yi0 < 0 ? th - 1 : yi0;
  const int xi1 = xi0 + 1 >= tw ? 0 : xi0 + 1;
  const int yi1 = yi0 + 1 >= th ? 0 : yi0 + 1;
  const float a[2] = {1.0f - fx, fx}, b[2] = {1.0f - fy, fy};
  const bool xd = xi0 == xi1, yd = yi0 == yi1;
  // the tap (row r, column c) weighs a[c] * b[r]: kytpu's (1-fx)(1-fy),
  // fx(1-fy), (1-fx)fy, fx fy
  const float both = ((a[0] * b[0] + a[1] * b[0]) + a[0] * b[1]) + a[1] * b[1];
  const bool c_hi_first = !xd && xi1 < xi0, r_hi_first = !yd && yi1 < yi0;
  const int base = img * th * tw;
  Taps T;
#pragma unroll
  for (int ra = 0; ra < 2; ++ra) {
#pragma unroll
    for (int cb = 0; cb < 2; ++cb) {
      const int s = 2 * ra + cb;
      const int r = (ra == 0) == r_hi_first ? 1 : 0;
      const int c = (cb == 0) == c_hi_first ? 1 : 0;
      const bool ok = (ra == 0 || !yd) && (cb == 0 || !xd);
      const float w_rc = a[c] * b[r];
      const float w_x = a[0] * b[r] + a[1] * b[r];
      const float w_y = a[c] * b[0] + a[c] * b[1];
      T.w[s] = (xd && yd) ? both : xd ? w_x : yd ? w_y : w_rc;
      T.wr[s] = yd ? b[0] + b[1] : b[r];
      T.wc[s] = xd ? a[0] + a[1] : a[c];
      T.t[s] = ok ? base + (r ? yi1 : yi0) * tw + (c ? xi1 : xi0) : -1;
    }
  }
  return T;
}

// The bilinear colour out[0..2] of the taps from the (texels, 3) atlas
// timg, in the addition order of the route kytpu takes (sep: separable)
static __device__ __forceinline__ void image_color(const Taps& T, bool sep, const float* timg,
                                                   float* out) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (!sep) {
      float v = 0.f;
#pragma unroll
      for (int s = 0; s < 4; ++s)
        if (T.t[s] >= 0) v = v + __ldg(timg + 3 * T.t[s] + c) * T.w[s];
      out[c] = v;
    } else {
      float v = 0.f;
#pragma unroll
      for (int ra = 0; ra < 2; ++ra) {
        const int s = 2 * ra;
        if (T.t[s] < 0) continue;
        float rs = __ldg(timg + 3 * T.t[s] + c) * T.wc[s];
        if (T.t[s + 1] >= 0) rs = rs + __ldg(timg + 3 * T.t[s + 1] + c) * T.wc[s + 1];
        v = v + rs * T.wr[s];
      }
      out[c] = v;
    }
  }
}

// slot s's texel-tagged adjoint entry of a bounce: the value of adjoint adj
// (kytpu's scatter: adj * w for the select chain, (w_row * adj) * w_col for
// the separable route) and its tag, texel + 1 (0: unused)
static __device__ __forceinline__ float texel_entry(const Taps& T, bool sep, int s, float adj) {
  return sep ? (T.wr[s] * adj) * T.wc[s] : adj * T.w[s];
}

}  // namespace kytpu
