# Frozen copy of kytpu_torch/core/math.py at commit 35fb5ad, imports
# rewritten to this package: the benchmark's plain reference.
"""Constants, vector helpers, Monte-Carlo warps, MIS heuristics and Fresnel
(kytpu/core/math.py).

Vectors are (..., 3) float32 tensors, batched over the leading axes, as in
kytpu. The behavioural constants of the reference renderer (the epsilons
are needed for pixel parity) and the guarded division and square root
every kernel helper leans on come first; python floats here are the same
doubles the JAX package folds in at trace time.

The transcendental functions (`sqrt`, `cos`, `sin`, `arccos`, `arctan2`,
`power`) are taken in float64 and rounded once to float32. On the CPU
PyTorch computes a float32 transcendental with a vector routine in the
body of a tensor and a scalar one in its tail, whose last bits differ, so
a lane's value would depend on where in the batch it sits; rounded from
float64 both agree, and a lane traces the same bits in any batch (a
region render reproduces its crop of the frame).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


def _f64(fn, *xs) -> torch.Tensor:
    return fn(*(x.to(torch.float64) for x in xs)).to(torch.float32)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (IEEE, as CUDA's sqrtf and
    XLA's sqrt are). PyTorch's vectorised CPU sqrt is off by an ulp on about
    1% of inputs; a float64 root rounded once to float32 is exact."""
    return _f64(torch.sqrt, x)


def cos(x: torch.Tensor) -> torch.Tensor:
    return _f64(torch.cos, x)


def sin(x: torch.Tensor) -> torch.Tensor:
    return _f64(torch.sin, x)


def arccos(x: torch.Tensor) -> torch.Tensor:
    return _f64(torch.acos, x)


def arctan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return _f64(torch.atan2, y, x)


def power(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    return _f64(torch.pow, x, e)


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
    """num / den with `fallback` where den == 0 (no NaN in masked lanes, nor
    in their gradients)."""
    ok = den != 0.0
    den_safe = torch.where(ok, den, torch.ones_like(den))
    return torch.where(ok, div(num, den_safe),
                       torch.full_like(den, fallback))


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(x), both correctly rounded. The CUDA kernel computes
    ``1.0f / sqrtf(x)`` (not the approximate ``rsqrtf``), so the two agree
    bit for bit; against XLA's rsqrt they differ by at most an ulp."""
    return div(1.0, sqrt(x))


def gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for a float table (M,) or (M, C), through F.embedding:
    its backward sums each row's lanes in a fixed order on the card too,
    where indexing's backward adds them with atomics."""
    idx = idx.long()
    if table.dim() == 1:
        return F.embedding(idx, table[:, None])[..., 0]
    return F.embedding(idx, table)


# ---------------------------------------------------------------------------
# vectors over the trailing axis of size 3
# ---------------------------------------------------------------------------

def dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (u * v).sum(dim=-1)


def absdot(u, v) -> torch.Tensor:
    return torch.abs(dot(u, v))


def cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    u, v = torch.broadcast_tensors(u, v)
    return torch.stack([u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
                        u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
                        u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]], -1)


def length_squared(v: torch.Tensor) -> torch.Tensor:
    return dot(v, v)


def length(v: torch.Tensor) -> torch.Tensor:
    return sqrt(length_squared(v))


def normalize(v: torch.Tensor) -> torch.Tensor:
    return v / length(v)[..., None]


def safe_normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return v / torch.clamp_min(length(v), eps)[..., None]


def distance(p, q) -> torch.Tensor:
    return length(p - q)


def distance_squared(p, q) -> torch.Tensor:
    return length_squared(p - q)


def max_component(c: torch.Tensor) -> torch.Tensor:
    """NaN-propagating, as jnp.max is."""
    return torch.maximum(c[..., 0], torch.maximum(c[..., 1], c[..., 2]))


def spherical_theta(v: torch.Tensor) -> torch.Tensor:
    return arccos(torch.clamp(v[..., 2], -1.0, 1.0))


def spherical_phi(v: torch.Tensor) -> torch.Tensor:
    phi = arctan2(v[..., 1], v[..., 0])
    return torch.where(phi < 0.0, phi + TWO_PI, phi)


def spherical_to_direction(sin_theta, cos_theta, phi) -> torch.Tensor:
    return torch.stack([sin_theta * cos(phi), sin_theta * sin(phi),
                        cos_theta], dim=-1)


def spherical_to_direction_in_frame(sin_theta, cos_theta, phi, x, y, z):
    """Direction with respect to an explicit basis (x, y, z)."""
    return ((sin_theta * cos(phi))[..., None] * x
            + (sin_theta * sin(phi))[..., None] * y
            + cos_theta[..., None] * z)


# ---------------------------------------------------------------------------
# Monte-Carlo warps: u in [0,1)^2 -> disk / hemisphere / sphere / cone
# ---------------------------------------------------------------------------

def uniform_disk_sample(u: torch.Tensor) -> torch.Tensor:
    r = sqrt(u[..., 0])
    theta = TWO_PI * u[..., 1]
    return torch.stack([r * cos(theta), r * sin(theta)], dim=-1)


def concentric_disk_sample(u: torch.Tensor) -> torch.Tensor:
    """Shirley-Chiu concentric mapping, branch-free."""
    ofs = 2.0 * u - 1.0
    x, y = ofs[..., 0], ofs[..., 1]
    x_dominant = torch.abs(x) > torch.abs(y)
    r = torch.where(x_dominant, x, y)
    ratio = torch.where(x_dominant, safe_div(y, x), safe_div(x, y))
    theta = torch.where(x_dominant, PI_OVER_4 * ratio,
                        PI_OVER_2 - PI_OVER_4 * ratio)
    degenerate = (x == 0.0) & (y == 0.0)
    zero = torch.zeros_like(x)
    return torch.stack([torch.where(degenerate, zero, r * cos(theta)),
                        torch.where(degenerate, zero, r * sin(theta))], -1)


def cosine_hemisphere_sample(u: torch.Tensor) -> torch.Tensor:
    p = concentric_disk_sample(u)
    z = safe_sqrt(1.0 - p[..., 0] ** 2 - p[..., 1] ** 2)
    return torch.stack([p[..., 0], p[..., 1], z], dim=-1)


def cosine_hemisphere_pdf(cos_theta):
    return cos_theta * INV_PI


def uniform_hemisphere_sample(u: torch.Tensor) -> torch.Tensor:
    z = u[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = TWO_PI * u[..., 1]
    return torch.stack([r * cos(phi), r * sin(phi), z], dim=-1)


def uniform_hemisphere_pdf():
    return INV_2PI


def uniform_sphere_sample(u: torch.Tensor) -> torch.Tensor:
    z = 1.0 - 2.0 * u[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = TWO_PI * u[..., 1]
    return torch.stack([r * cos(phi), r * sin(phi), z], dim=-1)


def uniform_sphere_pdf():
    return INV_4PI


def uniform_cone_sample(u: torch.Tensor, cos_theta_max) -> torch.Tensor:
    cos_theta = (1.0 - u[..., 0]) + u[..., 0] * cos_theta_max
    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    return spherical_to_direction(sin_theta, cos_theta, TWO_PI * u[..., 1])


def uniform_cone_pdf(cos_theta_max):
    return 1.0 / (TWO_PI * (1.0 - cos_theta_max))


def uniform_triangle_sample(u: torch.Tensor) -> torch.Tensor:
    su0 = sqrt(u[..., 0])
    return torch.stack([1.0 - su0, u[..., 1] * su0], dim=-1)


# ---------------------------------------------------------------------------
# MIS heuristics
# ---------------------------------------------------------------------------

def balance_heuristic(nf, f_pdf, ng, g_pdf):
    return (nf * f_pdf) / (nf * f_pdf + ng * g_pdf)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    f = nf * f_pdf
    g = ng * g_pdf
    return (f * f) / (f * f + g * g)


# ---------------------------------------------------------------------------
# reflection, refraction, Fresnel (z is the shading normal)
# ---------------------------------------------------------------------------

def reflect(wo, n):
    """Mirror wo about the unit normal n."""
    return -wo + 2.0 * dot(wo, n)[..., None] * n


def refract(wi, n, eta_ratio):
    """Snell refraction -> (wt, ok), ok False on total internal reflection.
    `eta_ratio` = eta_i / eta_t; `n` lies in wi's hemisphere."""
    cos_theta_i = dot(n, wi)
    sin2_i = torch.clamp_min(1.0 - cos_theta_i * cos_theta_i, 0.0)
    sin2_t = (eta_ratio * eta_ratio) * sin2_i
    ok = sin2_t < 1.0
    cos_theta_t = safe_sqrt(1.0 - torch.clamp_max(sin2_t, 1.0))
    wt = (eta_ratio[..., None] * (-wi)
          + (eta_ratio * cos_theta_i - cos_theta_t)[..., None] * n)
    return wt, ok


def fresnel_dielectric(cos_theta_i, eta_i, eta_t):
    """Exact unpolarised dielectric Fresnel reflectance, from either side
    (cos_theta_i < 0 swaps the media); 1 on total internal reflection."""
    cos_theta_i = torch.clamp(cos_theta_i, -1.0, 1.0)
    entering = cos_theta_i > 0.0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    ci = torch.abs(cos_theta_i)
    sin_theta_i = safe_sqrt(1.0 - ci * ci)
    sin_theta_t = ei / et * sin_theta_i
    tir = sin_theta_t >= 1.0
    ct = safe_sqrt(1.0 - torch.clamp_max(sin_theta_t, 1.0) ** 2)
    r_para = (et * ci - ei * ct) / (et * ci + ei * ct)
    r_perp = (ei * ci - et * ct) / (ei * ci + et * ct)
    fr = 0.5 * (r_para * r_para + r_perp * r_perp)
    return torch.where(tir, torch.ones_like(fr), fr)


def fresnel_schlick_f0(cos_theta_i, f0):
    t = (1.0 - cos_theta_i) ** 5
    return f0 + t * (1.0 - f0)


def fresnel_schlick(cos_theta_i, eta_i, eta_t):
    return fresnel_schlick_f0(cos_theta_i,
                              ((eta_t - eta_i) / (eta_t + eta_i)) ** 2)


def offset_ray_origin(position, normal, direction):
    """Self-intersection offset: +-1e-2 n by the sign of n.d
    (ky.cpp:614-620)."""
    s = torch.where(dot(normal, direction) < 0.0, -1.0, 1.0)
    return position + (RAY_OFFSET * s)[..., None] * normal
