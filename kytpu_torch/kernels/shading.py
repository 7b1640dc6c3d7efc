"""The plain per-lane shading that both kernel families' plain versions run
(`_trace_plain` of kernels/wavefront.py, K1-K4, and of kernels/bigscene.py,
K5-K8), each helper the transcription of its kytpu counterpart that the
card's kernels (csrc/megakernel.cuh) reproduce: the lane RNG, the ray
epsilons, the BSDF, light and pdf helpers, the textures, and the exponent
adjoint's kappa.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from kytpu_torch import bsdf as kbsdf
from kytpu_torch.core import lds
from kytpu_torch.core import math as km
from kytpu_torch.kernels import tables as ktab
from kytpu_torch.kernels.launch import LANE, M32
from kytpu_torch.kernels.v3 import (V3, cv3, make_frame, to_world, v3_full,
                                    v3_zeros)
from kytpu_torch.light import lights as klights


def sphere_area_f32(r: float) -> float:
    """np.float32(4.0 * np.pi * r * r) with r an np.float32: under numpy's
    scalar promotion every product rounds to float32 (light_sample)."""
    r32 = np.float32(r)
    return float(np.float32(4.0 * np.pi) * r32 * r32)


def u32(x) -> torch.Tensor:
    """An int tensor's bits as uint32 values held in int64."""
    return x.to(torch.int64) & M32


mul32 = lds.mul32


def bits_to_unit(x: torch.Tensor) -> torch.Tensor:
    """uint32 word -> float32 in [0, 1) from its top 24 bits."""
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def pix_hash(pid: torch.Tensor, seed) -> torch.Tensor:
    """lowbias32 of (pixel id, seed), on uint32 words (kytpu's
    wavefront.py:477)."""
    x = pid ^ mul32(seed if isinstance(seed, torch.Tensor)
                    else torch.tensor(seed & M32), 0x9E3779B9)
    x = x ^ (x >> 16)
    x = mul32(x, 0x21F0AAAD)
    x = x ^ (x >> 15)
    x = mul32(x, 0x735A2D97)
    return x ^ (x >> 15)


def _lowbias(x: torch.Tensor) -> torch.Tensor:
    """The hash stream's finaliser (kytpu's wavefront.py:574-580), with the
    constants as written there."""
    x = x ^ (x >> 17)
    x = mul32(x, -315667899)
    x = x ^ (x >> 11)
    x = mul32(x, -1404298415)
    x = x ^ (x >> 15)
    x = mul32(x, 830770091)
    return x ^ (x >> 14)


def superset_xor(x: torch.Tensor) -> torch.Tensor:
    """z_j = XOR over k >= j, j a subset of k, of x_k: the GF(2) superset
    transform in 5 word-parallel stages (kytpu's wavefront.py:451);
    bit-reversed, a (0,2)-sequence partner of the radical inverse."""
    x = x ^ ((x >> 1) & 0x55555555)
    x = x ^ ((x >> 2) & 0x33333333)
    x = x ^ ((x >> 4) & 0x0F0F0F0F)
    x = x ^ ((x >> 8) & 0x00FF00FF)
    return x ^ ((x >> 16) & 0x0000FFFF)


def site_seeds(ctr: int) -> list[int]:
    """Three decorrelated 32-bit words for draw site `ctr`: splitmix64 of
    the counter (kytpu's wavefront.py:487)."""
    m64 = (1 << 64) - 1
    out = []
    x = (ctr * 0x9E3779B97F4A7C15 + 0x632BE59BD9B4E019) & m64
    for _ in range(3):
        x = (x + 0x9E3779B97F4A7C15) & m64
        z = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & m64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m64
        out.append((z ^ (z >> 31)) & M32)
    return out


class Rng:
    """The JAX package's `_Rng(hw=False)` on (N,) lanes.

    "random": key = tile seed, mixed with the lane's position inside its
    rows*128 tile. "hash" (per_lane): key = a per-lane hash of (seed,
    pixel id, sample id). "sobol" (sobol=(sample index, pixel hash)): every
    draw shuffles and Owen-scrambles the lane's reversed sample index with
    the words of its site; uniform2() is one point of a (0,2) pair and
    advances the counter once. Every draw is a pure function of (key, lane,
    draw counter), and the counter advances the same on every lane."""

    def __init__(self, key: torch.Tensor | None, lane: torch.Tensor | None,
                 sobol=None):
        self.key = key
        self.lane = lane
        self.ctr = 0
        self.sobol = sobol is not None
        if self.sobol:
            si, self.ph = sobol
            self.si_rev = lds.reverse_bits(si)

    def _sobol_site(self):
        """(shuffled index i, the site's third word, dimension 0 of i)."""
        self.ctr += 1
        c1, c2, c3 = site_seeds(self.ctr)
        i = lds.reverse_bits(lds.laine_karras(self.si_rev, self.ph ^ c1))
        u1 = bits_to_unit(lds.reverse_bits(lds.laine_karras(i,
                                                            self.ph ^ c2)))
        return i, c3, u1

    def uniform(self) -> torch.Tensor:
        if self.sobol:
            return self._sobol_site()[2]
        self.ctr += 1
        step = (self.ctr * 668265263) & M32
        if self.lane is None:
            x = (self.key + step) & M32
        else:
            x = (self.key + mul32(self.lane, 374761393) + step) & M32
        return bits_to_unit(_lowbias(x))

    def uniform2(self):
        if not self.sobol:
            return self.uniform(), self.uniform()
        i, c3, u1 = self._sobol_site()
        u2 = bits_to_unit(lds.reverse_bits(lds.laine_karras(
            superset_xor(i), self.ph ^ c3)))
        return u1, u2


EPS = ktab.f32(km.SHAPE_EPSILON)
OFF = ktab.f32(km.RAY_OFFSET)
SHADOW_EPS = ktab.f32(km.SHADOW_EPSILON)
TWO_PI = ktab.f32(km.TWO_PI)
_INV_PI = ktab.f32(km.INV_PI)
_INV_2PI = ktab.f32(km.INV_2PI)
_ENV_PDF = ktab.f32(1.0 / (2.0 * np.pi * np.pi))


def where(c, a, b):
    """torch.where that takes python numbers on either side (float32 when
    both are)."""
    if isinstance(a, torch.Tensor):
        like = a
    elif isinstance(b, torch.Tensor):
        like = b
    else:
        like = torch.empty(c.shape, dtype=torch.float32, device=c.device)
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(like, a)
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(like, b)
    return torch.where(c, a, b)


def sphere_consts(s):
    r = ktab.f32(s["r"])
    return cv3(s["c"]), r, ktab.f32(np.float32(r) * np.float32(r))


def sphere_occludes(neg_b, discr, tmax):
    """Root of a sphere crossing in (eps, tmax), without the square root
    (kytpu's wavefront.py:901-916)."""
    a_c = neg_b - EPS
    b_c = neg_b - tmax
    a2 = a_c * a_c
    b2 = b_c * b_c
    a_pos = a_c > 0.0
    b_neg = b_c < 0.0
    in1 = a_pos & (discr < a2) & (b_neg | (discr > b2))
    in2 = (a_pos | (discr > a2)) & b_neg & (discr < b2)
    return (discr >= 0) & (in1 | in2)


def offset_origin(p: V3, n: V3, d: V3) -> V3:
    return p + n * where(n.dot(d) < 0.0, -OFF, OFF)


def _ipow(x, n: int):
    """x**n for a static integer n >= 1 by square-and-multiply."""
    r = None
    while n:
        if n & 1:
            r = x if r is None else r * x
        n >>= 1
        if n:
            x = x * x
    return r


def _fresnel_dielectric(ci, eta):
    ci = torch.clamp(ci, -1.0, 1.0)
    entering = ci > 0.0
    ei = where(entering, 1.0, eta)
    et = where(entering, eta, 1.0)
    c = torch.abs(ci)
    si = km.safe_sqrt(1.0 - c * c)
    st = ei / et * si
    tir = st >= 1.0
    ct = km.safe_sqrt(1.0 - torch.clamp_max(st, 1.0) ** 2)
    r_par = km.safe_div(et * c - ei * ct, et * c + ei * ct)
    r_per = km.safe_div(ei * c - et * ct, ei * c + et * ct)
    fr = 0.5 * (r_par * r_par + r_per * r_per)
    return where(tir, 1.0, fr)


def sin_from_phi_cos(cos_phi, u):
    """sin(2 pi u) from cos(2 pi u): sign(sin) = +1 iff u <= 0.5."""
    s = km.safe_sqrt(1.0 - cos_phi * cos_phi)
    return torch.where(u <= 0.5, s, -s)


def _concentric_disk(u1, u2):
    x = 2.0 * u1 - 1.0
    y = 2.0 * u2 - 1.0
    xd = torch.abs(x) > torch.abs(y)
    r = torch.where(xd, x, y)
    ratio = torch.where(xd, km.safe_div(y, x), km.safe_div(x, y))
    pi4 = ktab.f32(km.PI_OVER_4)
    theta = torch.where(xd, pi4 * ratio, ktab.f32(km.PI_OVER_2) - pi4 * ratio)
    deg = (x == 0.0) & (y == 0.0)
    ct = torch.cos(theta)
    st = km.safe_sqrt(1.0 - ct * ct)
    st = torch.where(theta >= 0.0, st, -st)
    px = where(deg, 0.0, r * ct)
    py = where(deg, 0.0, r * st)
    return px, py


def _phong_pow(cos_alpha, exponent, static_exp):
    """(cos^e, (e+2)/2pi, (e+1)/2pi): `_ipow` and host-folded factors for
    a static exponent, pow with the per-lane exponent otherwise."""
    if static_exp is not None:
        return (_ipow(cos_alpha, int(static_exp)),
                ktab.f32((static_exp + 2.0) * km.INV_2PI),
                ktab.f32((static_exp + 1.0) * km.INV_2PI))
    return (torch.pow(cos_alpha, exponent), (exponent + 2.0) * _INV_2PI,
            (exponent + 1.0) * _INV_2PI)


def bsdf_sample(kind, color: V3, color2: V3, eta, exponent, wo: V3, u1, u2,
                lobes=frozenset((kbsdf.LAMBERT, kbsdf.MIRROR, kbsdf.GLASS,
                                 kbsdf.PHONG)), static_exp=None):
    """Local-frame sample of the lobes present, selected by `kind`
    (kytpu's wavefront.py:1228-1330). Returns (f, wi, pdf, delta, f_unit,
    glass_refract)."""
    mirror_wi = V3(-wo.x, -wo.y, wo.z)
    zero = torch.zeros_like(u1)
    cand = {}
    if kbsdf.LAMBERT in lobes:
        px, py = _concentric_disk(u1, u2)
        lz = km.safe_sqrt(1.0 - px * px - py * py)
        wi_lam = V3(px, py, torch.where(wo.z < 0, -lz, lz))
        same_lam = wo.z * wi_lam.z > 0
        f_lam = (color * _INV_PI).where(same_lam, v3_zeros(wo.x))
        pdf_lam = where(same_lam, torch.abs(wi_lam.z) * _INV_PI, 0.0)
        unit_lam = where(same_lam, _INV_PI, 0.0)
        cand[kbsdf.LAMBERT] = (wi_lam, f_lam, pdf_lam, unit_lam)
    if kbsdf.MIRROR in lobes:
        abs_cos_m = torch.clamp_min(torch.abs(mirror_wi.z), 1e-12)
        inv_m = km.div(1.0, abs_cos_m)
        cand[kbsdf.MIRROR] = (mirror_wi, color * inv_m,
                              torch.ones_like(u1), inv_m)
    take_refl = None
    if kbsdf.GLASS in lobes:
        fr = _fresnel_dielectric(wo.z, eta)
        take_refl = u1 < fr
        into = wo.z > 0
        nz = where(into, 1.0, -1.0)
        n_loc = V3(torch.zeros_like(nz), torch.zeros_like(nz), nz)
        eta_ratio = where(into, km.div(1.0, eta), eta)
        cos_i = n_loc.dot(wo)
        sin2_i = torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
        sin2_t = eta_ratio * eta_ratio * sin2_i
        refr_ok = sin2_t < 1.0
        cos_t = km.safe_sqrt(1.0 - torch.clamp_max(sin2_t, 1.0))
        wt = (-wo) * eta_ratio + n_loc * (eta_ratio * cos_i - cos_t)
        wi_gl = mirror_wi.where(take_refl, wt)
        abs_cos_g = torch.clamp_min(torch.abs(wi_gl.z), 1e-12)
        refl_unit = fr / abs_cos_g
        refr_unit = (1.0 - fr) / abs_cos_g
        unit_gl = torch.where(take_refl, refl_unit,
                              where(refr_ok, refr_unit, 0.0))
        f_gl = (color * refl_unit).where(
            take_refl, (color2 * refr_unit).where(refr_ok, v3_zeros(wo.x)))
        pdf_gl = torch.where(take_refl, fr, where(refr_ok, 1.0 - fr, 0.0))
        cand[kbsdf.GLASS] = (wi_gl, f_gl, pdf_gl, unit_gl)
    if kbsdf.PHONG in lobes:
        phi = TWO_PI * u1
        if static_exp is not None:
            cos_t_p = torch.pow(u2, ktab.f32(1.0 / (static_exp + 1.0)))
        else:
            cos_t_p = torch.pow(u2, km.div(1.0, exponent + 1.0))
        sin_t_p = km.safe_sqrt(1.0 - cos_t_p * cos_t_p)
        cphi = torch.cos(phi)
        lobe = V3(cphi * sin_t_p, sin_from_phi_cos(cphi, u1) * sin_t_p,
                  cos_t_p)
        s_f, t_f, n_f = make_frame(mirror_wi)
        wi_ph = to_world(s_f, t_f, n_f, lobe)
        wi_ph = V3(wi_ph.x, wi_ph.y, torch.where(wo.z < 0, -wi_ph.z, wi_ph.z))
        cos_alpha = torch.clamp_min(mirror_wi.dot(wi_ph), 0.0)
        same_ph = wo.z * wi_ph.z > 0
        powa, e2, e1 = _phong_pow(cos_alpha, exponent, static_exp)
        ph_val = where(same_ph, e2 * powa, 0.0)
        pdf_ph = e1 * powa
        cand[kbsdf.PHONG] = (wi_ph, color * ph_val, pdf_ph, ph_val)

    order = [k for k in (kbsdf.LAMBERT, kbsdf.MIRROR, kbsdf.GLASS,
                         kbsdf.PHONG) if k in cand]
    wi, f, pdf, f_unit = cand[order[-1]]
    for k in reversed(order[:-1]):
        is_k = kind == k
        wi_k, f_k, pdf_k, unit_k = cand[k]
        wi = wi_k.where(is_k, wi)
        f = f_k.where(is_k, f)
        pdf = torch.where(is_k, pdf_k, pdf)
        f_unit = torch.where(is_k, unit_k, f_unit)
    false_mask = zero > 0
    is_gls = (kind == kbsdf.GLASS) if kbsdf.GLASS in cand else false_mask
    is_mir = (kind == kbsdf.MIRROR) if kbsdf.MIRROR in cand else false_mask
    glass_refract = (is_gls & ~take_refl) if take_refl is not None \
        else false_mask
    return f, wi, pdf, is_mir | is_gls, f_unit, glass_refract


def _eval_lobes(kind, same, wi_z, cos_alpha, exponent, lobes, static_exp):
    """Lambert / Phong eval + pdf shared by the two eval entry points."""
    has_lam = kbsdf.LAMBERT in lobes
    has_ph = kbsdf.PHONG in lobes
    zero = torch.zeros_like(wi_z)
    if has_lam:
        unit_lam = where(same, _INV_PI, 0.0)
        pdf_lam = where(same, torch.abs(wi_z) * _INV_PI, 0.0)
    if has_ph:
        powa, e2, e1 = _phong_pow(torch.clamp_min(cos_alpha, 0.0), exponent,
                                  static_exp)
        ph = where(same, e2 * powa, 0.0)
        pdf_ph = e1 * powa
    if has_lam and has_ph:
        is_lam = kind == kbsdf.LAMBERT
        is_ph = kind == kbsdf.PHONG
        f_unit = torch.where(is_lam, unit_lam, where(is_ph, ph, 0.0))
        pdf = torch.where(is_lam, pdf_lam, where(is_ph, pdf_ph, 0.0))
    elif has_lam:
        is_lam = kind == kbsdf.LAMBERT
        f_unit = where(is_lam, unit_lam, 0.0)
        pdf = where(is_lam, pdf_lam, 0.0)
    elif has_ph:
        is_ph = kind == kbsdf.PHONG
        f_unit = where(is_ph, ph, 0.0)
        pdf = where(is_ph, pdf_ph, 0.0)
    else:
        f_unit = pdf = zero
    return pdf, f_unit


def bsdf_eval_pdf(kind, color: V3, exponent, wo: V3, wi: V3,
                  lobes=frozenset((kbsdf.LAMBERT, kbsdf.PHONG)),
                  static_exp=None):
    """Local-frame eval + pdf of the non-delta lobes -> (f, pdf, f_unit)."""
    wr = V3(-wo.x, -wo.y, wo.z)
    cos_alpha = wr.dot(wi) if kbsdf.PHONG in lobes else None
    pdf, f_unit = _eval_lobes(kind, wo.z * wi.z > 0, wi.z, cos_alpha,
                              exponent, lobes, static_exp)
    return color * f_unit, pdf, f_unit


def bsdf_eval_pdf_dots(kind, exponent, wo_z, wi_z, cos_alpha,
                       lobes=frozenset((kbsdf.LAMBERT, kbsdf.PHONG)),
                       static_exp=None):
    """`bsdf_eval_pdf` on the frame-invariant dots n.wo, n.wi and the
    mirror dot -> (pdf, f_unit)."""
    return _eval_lobes(kind, wo_z * wi_z > 0, wi_z, cos_alpha, exponent,
                       lobes, static_exp)


def light_sample(lt, world_radius, p: V3, n_shade: V3, u1, u2, azim=None):
    """sample_Li for light lt -> (wi, pdf, li_scalar, dist, phit); Li =
    emit * li_scalar. phit is the light's direction-free solid-angle pdf
    for a BSDF ray leaving p, or None where it depends on the direction
    (kytpu's wavefront.py:1441-1590)."""
    kind = lt["kind"]
    ones = torch.ones_like(u1)
    zeros = torch.zeros_like(u1)
    if kind == klights.POINT:
        vec = cv3(lt["position"]) - p
        d2 = torch.clamp_min(vec.length_squared(), 1e-20)
        dist = km.sqrt(d2)
        wi = vec * km.div(1.0, dist)
        return wi, ones, km.div(1.0, d2), dist, zeros
    if kind == klights.DIRECTION:
        dr = cv3(lt["direction"])
        wi = v3_full(u1, -dr.x, -dr.y, -dr.z)
        dist = torch.full_like(u1, ktab.f32(2.0 * world_radius))
        return wi, ones, ones, dist, zeros
    if kind == klights.AREA_RECT:
        p0, p1, p2 = cv3(lt["p0"]), cv3(lt["p1"]), cv3(lt["p2"])
        n_l = cv3(lt["normal"])
        area = ktab.f32(lt["area"])
        lp = p1 + (p0 - p1) * u1 + (p2 - p1) * u2
        vec = lp - p
        d2 = torch.clamp_min(vec.length_squared(), 1e-20)
        dist = km.sqrt(d2)
        wi = vec * km.div(1.0, dist)
        cos_l = n_l.dot(-wi)
        pdf = km.safe_div(d2, torch.abs(cos_l) * area)
        facing = cos_l > 0
        li_s = where(facing, 1.0, 0.0)
        pdf = where(facing & (pdf > 0) & torch.isfinite(pdf), pdf, 0.0)
        return wi, pdf, li_s, dist, None
    if kind == klights.AREA_SPHERE:
        c, r, r2 = sphere_consts(dict(c=lt["center"], r=lt["radius"]))
        vec_c = c - p
        d2c = torch.clamp_min(vec_c.length_squared(), 1e-20)
        inv_dc = km.rsqrt(d2c)
        dist_c = d2c * inv_dc
        inv_d2c = inv_dc * inv_dc
        sin2_max = torch.clamp_max(r2 * inv_d2c, 1.0)
        cos_max = km.safe_sqrt(1.0 - sin2_max)
        cos_t = (cos_max - 1.0) * u1 + 1.0
        sin2 = 1.0 - cos_t * cos_t
        tiny = sin2_max < ktab.f32(0.00068523)
        sin2 = torch.where(tiny, sin2_max * u1, sin2)
        cos_t = torch.where(tiny, km.safe_sqrt(1.0 - sin2), cos_t)
        sin_t = km.safe_sqrt(sin2)
        if azim is None:
            cphi = torch.cos(u2 * TWO_PI)
            sphi = sin_from_phi_cos(cphi, u2)
        else:
            cphi, sphi = azim
        to_c = vec_c * inv_dc
        s_f, t_f, n_f = make_frame(to_c)
        wi_cone = s_f * (-sin_t * cphi) + t_f * (-sin_t * sphi) \
            + n_f * cos_t
        depth2 = r2 - d2c * sin2
        ds = dist_c * cos_t - km.safe_sqrt(depth2)
        q_cone = TWO_PI * (1.0 - cos_max)
        pdf_cone = where(q_cone > 0.0, km.div(1.0, q_cone), 0.0)
        outside = d2c > r2
        ok_cone = (depth2 > 0) & (q_cone > 0.0) & outside
        if not lt.get("inside_possible", True):
            li_s = where(ok_cone, 1.0, 0.0)
            phit = where(outside, pdf_cone, 0.0)
            return wi_cone, pdf_cone, li_s, ds, phit
        inside = ~outside
        z_u = 1.0 - 2.0 * u1
        r_u = km.safe_sqrt(1.0 - z_u * z_u)
        dir_u = V3(r_u * cphi, r_u * sphi, z_u)
        lp_in = c + dir_u * r
        vec_in = lp_in - p
        d2_in = torch.clamp_min(vec_in.length_squared(), 1e-20)
        inv_d_in = km.rsqrt(d2_in)
        wi_in = vec_in * inv_d_in
        area = sphere_area_f32(lt["radius"])
        pdf_in = km.safe_div(d2_in, area * torch.abs(n_shade.dot(-wi_in)))
        pdf_in = where(torch.isfinite(pdf_in), pdf_in, 0.0)
        ok_in = (dir_u.dot(-wi_in) > 0) & (pdf_in > 0)
        wi = wi_in.where(inside, wi_cone)
        pdf = torch.where(inside, pdf_in, pdf_cone)
        ok = torch.where(inside, ok_in, ok_cone)
        dist = torch.where(inside, d2_in * inv_d_in, ds)
        return wi, pdf, where(ok, 1.0, 0.0), dist, None
    if kind == klights.ENV:
        # replicated reference quirk: uniform-sphere direction, angle-space
        # pdf (ky.cpp:3029-3035)
        z_u = 1.0 - 2.0 * u1
        r_u = km.safe_sqrt(1.0 - z_u * z_u)
        if azim is None:
            cphi = torch.cos(TWO_PI * u2)
            sphi = sin_from_phi_cos(cphi, u2)
        else:
            cphi, sphi = azim
        wi = V3(r_u * cphi, r_u * sphi, z_u)
        pdf = env_pdf(wi)
        dist = torch.full_like(u1, ktab.f32(2.0 * world_radius))
        return wi, pdf, ones, dist, zeros
    raise ValueError(f"unknown light kind {kind}")


def env_pdf(wi: V3):
    sin_theta = km.safe_sqrt(1.0 - wi.z * wi.z)
    return where(sin_theta == 0.0, 0.0,
                 km.div(_ENV_PDF, torch.clamp_min(sin_theta, 1e-20)))


def _sphere_cone_pdf(c: V3, r2, p: V3):
    """(inside, uniform-cone pdf) of a sphere light seen from p."""
    d2c = torch.clamp_min((c - p).length_squared(), 1e-20)
    inside = d2c <= r2
    sin2_max = torch.clamp_max(km.div(r2, d2c), 1.0)
    cos_max = km.safe_sqrt(1.0 - sin2_max)
    pdf_cone = km.safe_div(1.0, TWO_PI * (1.0 - cos_max))
    return inside, where(torch.isfinite(pdf_cone), pdf_cone, 0.0)


def hit_light_pdf(lights, li_idx, o: V3, d: V3, t, nrm: V3):
    """Solid-angle pdf of the area light the extension ray hit, from the
    hit record: squared distance t^2, light cosine |nrm.d|."""
    pdf = torch.zeros_like(t)
    t2 = t * t
    cos_l = torch.abs(nrm.dot(d))
    for i, lt in enumerate(lights):
        kind = lt["kind"]
        if kind == klights.AREA_RECT:
            pi = km.safe_div(t2, cos_l * ktab.f32(lt["area"]))
        elif kind == klights.AREA_SPHERE:
            c, _, r2 = sphere_consts(dict(c=lt["center"], r=lt["radius"]))
            inside, pdf_cone = _sphere_cone_pdf(c, r2, o)
            if not lt.get("inside_possible", True):
                pi = where(inside, 0.0, pdf_cone)
            else:
                area = ktab.f32(4.0 * np.pi * lt["radius"] ** 2)
                pi = torch.where(inside, km.safe_div(t2, cos_l * area),
                                 pdf_cone)
        else:
            continue
        pdf = torch.where(li_idx == i, pi, pdf)
    return pdf


def light_pdf(lt, p: V3, n_shade: V3, wi: V3):
    """pdf_Li of light lt along wi from p (lights.py:232-266)."""
    kind = lt["kind"]
    if kind in (klights.POINT, klights.DIRECTION):
        return torch.zeros_like(wi.x)
    if kind == klights.AREA_RECT:
        p0, p1 = cv3(lt["p0"]), cv3(lt["p1"])
        p2, p3 = cv3(lt["p2"]), cv3(lt["p3"])
        n_l = cv3(lt["normal"])
        area = ktab.f32(lt["area"])
        o = offset_origin(p, n_shade, wi)
        oa, ob, oc, od = p0 - o, p1 - o, p2 - o, p3 - o
        v0d = oc.cross(ob).dot(wi)
        v1d = ob.cross(oa).dot(wi)
        v2d = oa.cross(od).dot(wi)
        v3d = od.cross(oc).dot(wi)
        inside = ((v0d < 0) & (v1d < 0) & (v2d < 0) & (v3d < 0)) | \
                 ((v0d >= 0) & (v1d >= 0) & (v2d >= 0) & (v3d >= 0))
        t = km.safe_div(n_l.dot(oa), n_l.dot(wi), math.inf)
        hit = inside & (t > EPS) & torch.isfinite(t)
        hp = o + wi * t
        d2 = (hp - p).length_squared()
        pdf = km.safe_div(d2, torch.abs(n_l.dot(-wi)) * area)
        return where(hit & torch.isfinite(pdf), pdf, 0.0)
    if kind == klights.AREA_SPHERE:
        c, r, r2 = sphere_consts(dict(c=lt["center"], r=lt["radius"]))
        inside, pdf_cone = _sphere_cone_pdf(c, r2, p)
        if not lt.get("inside_possible", True):
            return where(inside, 0.0, pdf_cone)
        o = offset_origin(p, n_shade, wi)
        oc = c - o
        neg_b = oc.dot(wi)
        discr = neg_b * neg_b - oc.length_squared() + r2
        sq = km.safe_sqrt(discr)
        t1, t2 = neg_b - sq, neg_b + sq
        t1_ok = t1 > EPS
        t2_ok = t2 > EPS
        t = torch.where(t1_ok, t1, t2)
        hit = (discr >= 0) & (t1_ok | t2_ok)
        hp = o + wi * t
        n_hit = hp - c
        n_hit = n_hit * km.rsqrt(torch.clamp_min(n_hit.length_squared(),
                                                 1e-20))
        area = sphere_area_f32(lt["radius"])
        pdf_in = km.safe_div((hp - p).length_squared(),
                             torch.abs(n_hit.dot(-wi)) * area)
        pdf_in = where(hit & torch.isfinite(pdf_in), pdf_in, 0.0)
        return torch.where(inside, pdf_in, pdf_cone)
    if kind == klights.ENV:
        return env_pdf(wi)
    raise ValueError(f"unknown light kind {kind}")


def _uv(static, rec, hp: V3):
    """(u, v) of hit hp on a textured planar row, from the baked anchor and
    dual basis (disks: frame coordinates shifted by 0.5)."""
    s = static["planar"][rec["row"]]
    rel = hp - cv3(s["uv_anchor"])
    u, v = rel.dot(cv3(s["uv_f1"])), rel.dot(cv3(s["uv_f2"]))
    if s.get("uv_disk"):
        u, v = u + 0.5, v + 0.5
    return u, v


def _checker_even(static, rec, hp: V3):
    """The checker's "even"-cell mask at hp (`_checker_parity`)."""
    u, v = _uv(static, rec, hp)
    pu = torch.floor(u * ktab.f32(rec["scale"][0])).to(torch.int32)
    pv = torch.floor(v * ktab.f32(rec["scale"][1])).to(torch.int32)
    return ((pu + pv) & 1) == 0


def _image_xy(static, rec, hp: V3):
    """Continuous texel coordinates (x, y) of hp on an image row, in
    [-0.5, dim - 0.5) (`_image_uv_xy`): what K2 caches as "tx", "ty"."""
    u, v = _uv(static, rec, hp)
    su = u * ktab.f32(rec["scale"][0])
    sv = v * ktab.f32(rec["scale"][1])
    x = (su - torch.floor(su)) * float(rec["tw"]) - 0.5
    y = (sv - torch.floor(sv)) * float(rec["th"]) - 0.5
    return x, y


def image_taps(rec, x, y):
    """The bilinear taps of texel coordinates (x, y) on an image row, as the
    kernels list them (csrc/megakernel.cuh `image_taps`): four slots in
    ascending texel order, slot 2a + b the a-th lowest row and the b-th
    lowest column; a tap that coincides with another (a side of 1 texel) is
    merged into the first slot, the others left unused. Each slot: (texel
    index into the flattened atlas, -1 if unused; the select chain's weight,
    kytpu's per-texel sum of tap weights in tap order; the separable
    route's row and column weights). The tap indices and the weights are
    kytpu's (`_image_taps_from_xy`, `_image_sep_axes`)."""
    tw, th = rec["tw"], rec["th"]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    xi0, yi0 = x0.to(torch.int64), y0.to(torch.int64)
    xi0 = torch.where(xi0 < 0, tw - 1, xi0)
    yi0 = torch.where(yi0 < 0, th - 1, yi0)
    xi1 = torch.where(xi0 + 1 >= tw, 0, xi0 + 1)
    yi1 = torch.where(yi0 + 1 >= th, 0, yi0 + 1)
    a = (1.0 - fx, fx)
    b = (1.0 - fy, fy)
    xd, yd = xi0 == xi1, yi0 == yi1

    def wt(r, c):   # tap (row r, column c): kytpu's (1-fx)(1-fy), fx(1-fy) ..
        return a[c] * b[r]

    both = ((wt(0, 0) + wt(0, 1)) + wt(1, 0)) + wt(1, 1)
    c_hi_first = ~xd & (xi1 < xi0)   # the lower column is tap column 1
    r_hi_first = ~yd & (yi1 < yi0)
    base = rec["img"] * th * tw
    slots = []
    for ra in (0, 1):
        r = r_hi_first if ra == 0 else ~r_hi_first
        for cb in (0, 1):
            c = c_hi_first if cb == 0 else ~c_hi_first
            ok = (~yd if ra else torch.ones_like(yd)) & (
                ~xd if cb else torch.ones_like(xd))
            w_rc = torch.where(r, torch.where(c, wt(1, 1), wt(1, 0)),
                               torch.where(c, wt(0, 1), wt(0, 0)))
            w_x = torch.where(r, wt(1, 0) + wt(1, 1), wt(0, 0) + wt(0, 1))
            w_y = torch.where(c, wt(0, 1) + wt(1, 1), wt(0, 0) + wt(1, 0))
            w = torch.where(xd & yd, both, torch.where(
                xd, w_x, torch.where(yd, w_y, w_rc)))
            wr = torch.where(yd, b[0] + b[1], torch.where(r, b[1], b[0]))
            wc = torch.where(xd, a[0] + a[1], torch.where(c, a[1], a[0]))
            idx = base + torch.where(r, yi1, yi0) * tw + torch.where(
                c, xi1, xi0)
            slots.append((torch.where(ok, idx, -1), w, wr, wc))
    return slots


def image_color(rec, slots, timg) -> V3:
    """The bilinear colour of an image row in the addition order of the
    route kytpu takes for its atlas: the select chain adds the texels in
    texel order, the separable route each row's two columns, then the
    rows."""
    def texel(idx):
        return timg[idx.clamp_min(0)]

    if not rec.get("sep"):
        col = torch.zeros((slots[0][0].shape[0], 3), device=timg.device)
        for idx, w, _, _ in slots:
            col = col + where0(idx >= 0, texel(idx) * w[:, None])
        return V3(col[:, 0], col[:, 1], col[:, 2])
    rows = []
    for ra in (0, 1):
        (i0, _, wr, wc0), (i1, _, _, wc1) = slots[2 * ra], slots[2 * ra + 1]
        rs = texel(i0) * wc0[:, None] + where0(i1 >= 0,
                                               texel(i1) * wc1[:, None])
        rows.append(where0(i0 >= 0, rs * wr[:, None]))
    col = rows[0] + rows[1]
    return V3(col[:, 0], col[:, 1], col[:, 2])


def _texel_entries(rec, slots, adj: torch.Tensor, onrow):
    """K3's and K4's texel-tagged adjoint entries of one bounce: per slot
    (the value (N, 3), the tag: texel + 1, or 0 off the row or for an unused
    slot). The select chain's value is adj * w, the separable route's
    (w_row * adj) * w_col, as kytpu's scatters form them."""
    out = []
    for idx, w, wr, wc in slots:
        tag = torch.where(onrow & (idx >= 0), idx + 1, 0).to(torch.int32)
        val = (adj * w[:, None] if not rec.get("sep")
               else (wr[:, None] * adj) * wc[:, None])
        out.append((where0(tag > 0, val), tag))
    return out


def textures_at(static, tables, sid, hp: V3, diffuse: V3):
    """The textured rows' diffuse at hit hp (`_apply_textures`) -> (the
    diffuse, [(rec, onrow, checker even mask or None, image (x, y) or None,
    image slots or None)]), the hits kept for the cache and the adjoints."""
    hits = []
    for rec in static["textures"]:
        onrow = sid == rec["row"]
        if rec["kind"] == "image":
            x, y = _image_xy(static, rec, hp)
            slots = image_taps(rec, x, y)
            col = image_color(rec, slots, tables.timg)
            hits.append((rec, onrow, None, (x, y), slots))
        else:
            even = _checker_even(static, rec, hp)
            t = rec["tex"]
            ca, cb = tables.texa[t], tables.texb[t]
            col = V3(*(torch.where(even, ca[c], cb[c]) for c in range(3)))
            hits.append((rec, onrow, even, None, None))
        diffuse = col.where(onrow, diffuse)
    return diffuse, hits


def route_textures(hits, addc_diff, acc_ta, acc_tb, entries):
    """The diffuse-value adjoint of a textured row goes to its texture:
    a checker's to color_a or color_b by the hit's parity (per-lane
    accumulators acc_ta, acc_tb (N, T, 3)), an image's to the four taps
    (appended to `entries` as 4 slots a bounce); the row's diffuse-table
    share is zeroed. -> the remaining diffuse adjoint (N, 3)."""
    slot_entries = None
    for rec, onrow, even, _, slots in hits:
        if even is not None:
            t = rec["tex"]
            acc_ta[:, t] += where0(onrow & even, addc_diff)
            acc_tb[:, t] += where0(onrow & ~even, addc_diff)
        else:
            ent = _texel_entries(rec, slots, addc_diff, onrow)
            slot_entries = ent if slot_entries is None else [
                (torch.where((t1 > 0)[:, None], v1, v0),
                 torch.where(t1 > 0, t1, t0))
                for (v0, t0), (v1, t1) in zip(slot_entries, ent)]
        addc_diff = where0(~onrow, addc_diff)
    if entries is not None and slot_entries is not None:
        entries.extend(slot_entries)
    return addc_diff


def rng_keys(cfg, n: int, seed: int, si, pix, device):
    """(rng, tile_seed per lane, si of each lane's tile head or None)."""
    tile = cfg.rows * LANE
    lane_ids = torch.arange(n, dtype=torch.int64, device=device)
    tile_id = lane_ids // tile
    tile_seed = (seed + mul32(tile_id, 2654435761 & 0x7FFFFFFF)) & M32
    if cfg.sampler in ("hash", "sobol"):
        si_u, pix_u = u32(si), u32(pix)
        ph = pix_hash(pix_u, seed & M32)
        rng = (Rng(None, None, sobol=(si_u, ph)) if cfg.sampler == "sobol"
               else Rng(pix_hash(si_u, ph), None))
        return rng, tile_seed, si_u[tile_id * tile]
    return Rng(tile_seed, lane_ids % tile), tile_seed, None


def kappa_dot(exponent, cos_alpha):
    """d log f_phong / d e at a fixed direction, from the mirror dot:
    1/(e+2) + log cos_alpha, clamped (kytpu's `_kappa_dot`). The one
    definition behind every exponent adjoint: K2's "Bk"/"tuk" planes and
    K4's accumulators use it. Callers mask it to phong lanes."""
    cos_a = torch.clamp_min(cos_alpha, 1e-12)
    return km.safe_div(1.0, exponent + 2.0) + torch.log(cos_a)


def kappa(exponent, wo_l: V3, wi_l: V3):
    """`kappa_dot` of the local mirror direction of wo_l and wi_l."""
    return kappa_dot(exponent, V3(-wo_l.x, -wo_l.y, wo_l.z).dot(wi_l))


def st(v: V3) -> torch.Tensor:
    """V3 of (N,) planes -> (N, 3)."""
    return torch.stack([v.x, v.y, v.z], dim=-1)


def where0(c, v: torch.Tensor) -> torch.Tensor:
    """c ? v : 0 for (N,) masks and (N,) or (N, 3) values."""
    if v.dim() == 2:
        c = c[:, None]
    return torch.where(c, v, torch.zeros_like(v))


def texel_shape(static) -> tuple:
    rec = next(r for r in static["textures"] if r["kind"] == "image")
    return (static["n_texels"] // (rec["th"] * rec["tw"]), rec["th"],
            rec["tw"], 3)
