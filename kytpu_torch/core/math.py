"""Constants and small tensor helpers of the port (kytpu/core/math.py).

Only what the forward render path uses is ported: the behavioural
constants of the reference renderer (the epsilons are needed for pixel
parity) and the guarded division / square root every kernel helper leans on.
All tensors are float32; python floats here are the same doubles the JAX
package folds in at trace time.
"""

from __future__ import annotations

import math

import torch

PI = math.pi
TWO_PI = 2.0 * PI
PI_OVER_2 = PI / 2.0
PI_OVER_4 = PI / 4.0
INV_PI = 1.0 / PI
INV_2PI = 0.5 / PI
INV_4PI = 0.25 / PI

SHAPE_EPSILON = 1e-3       # minimum hit distance             (ky.cpp:1093)
RAY_OFFSET = 1e-2          # self-intersection origin offset  (ky.cpp:616)
SHADOW_EPSILON = 2e-3      # shadow-ray tmax shrink           (ky.cpp:3193)

INF = math.inf


def luminance(c: torch.Tensor) -> torch.Tensor:
    """Rec.709 luminance over the trailing axis (ky.cpp:249-255)."""
    return 0.212671 * c[..., 0] + 0.715160 * c[..., 1] + 0.072169 * c[..., 2]


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (IEEE, as CUDA's sqrtf and
    XLA's sqrt are). PyTorch's vectorised CPU sqrt is off by an ulp on about
    1% of inputs; a float64 root rounded once to float32 is exact."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    return sqrt(torch.clamp_min(x, 0.0))


def div(a, b) -> torch.Tensor:
    """a / b as one IEEE division, whatever mix of tensors and python floats.

    PyTorch computes ``float / tensor`` as ``reciprocal(tensor) * float`` and,
    on CUDA, ``tensor / float`` as ``tensor * (1 / float)``: both round twice.
    The kernels divide once, so the plain versions route every division
    through here."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    elif not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return a / b


def safe_div(num, den: torch.Tensor, fallback: float = 0.0) -> torch.Tensor:
    """num / den with `fallback` where den == 0."""
    ok = den != 0.0
    den_safe = torch.where(ok, den, torch.ones_like(den))
    return torch.where(ok, div(num, den_safe),
                       torch.full_like(den, fallback))


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(x), both correctly rounded. The CUDA kernel computes
    ``1.0f / sqrtf(x)`` (not the approximate ``rsqrtf``), so the two agree
    bit for bit; against XLA's rsqrt they differ by at most an ulp."""
    return div(1.0, sqrt(x))
