# Frozen copy of kytpu_torch/bsdf/bsdf.py at commit 35fb5ad, imports
# rewritten to this package: the benchmark's plain reference.
"""Vectorised BSDFs: Lambert, perfect mirror, Fresnel glass, modified Phong
(kytpu/bsdf/bsdf.py).

Every ray lane carries a small `BsdfParams` record (kind + colours +
scalars) resolved from its hit surface's material row; eval, pdf and
sample compute all four models elementwise and select by kind, with no
dispatch. The kernels carry their own copy of these models
(kernels/wavefront.py, csrc/megakernel.cuh); this module is the jnp
engines' (integrator/path.py, integrator/fast.py).

Model parity targets: Lambert rho/pi with cosine-hemisphere sampling
(ky.cpp:2217-2268); the perfect mirror's delta lobe f = R/|cos|, pdf 1
(ky.cpp:2279-2316); Fresnel glass, reflecting with the exact Fresnel
probability (ky.cpp:2337-2412); modified Phong rho (e+2)/2pi cos^e alpha,
sampled as a cosine lobe about the mirror direction (ky.cpp:2477-2555);
plastic's stochastic luminance-weighted lobe pick (ky.cpp:2566-2682).

Differentiability: the integrators detach sampled directions and pdfs;
the throughput numerators (albedo, reflectance, Fresnel factors) and the
Phong exponent keep their gradients.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from perfbench.reference.frozen.core import frame as kframe
from perfbench.reference.frozen.core import math as km

# BSDF kinds (per lane, after material resolution)
LAMBERT = 0
MIRROR = 1
GLASS = 2
PHONG = 3

# material kinds (per surface row)
MAT_MATTE = 0
MAT_MIRROR = 1
MAT_GLASS = 2
MAT_PLASTIC = 3


@dataclass(frozen=True)
class BsdfParams:
    """Per-lane resolved BSDF."""

    kind: torch.Tensor      # (N,) int32 in {LAMBERT, MIRROR, GLASS, PHONG}
    color: torch.Tensor     # (N,3) albedo / reflectance / phong specular
    color2: torch.Tensor    # (N,3) glass transmittance
    eta: torch.Tensor       # (N,) interior IOR (glass)
    exponent: torch.Tensor  # (N,) phong exponent


@dataclass(frozen=True)
class BsdfSample:
    f: torch.Tensor       # (N,3) BSDF value (delta lobes fold 1/|cos| in)
    wi: torch.Tensor      # (N,3) local or world, by the API level
    pdf: torch.Tensor     # (N,)
    delta: torch.Tensor   # (N,) bool: the sampled lobe is specular


def select(conds, choices, default):
    """jnp.select: the choice of the first true condition, else default."""
    out = default
    for c, v in zip(reversed(conds), reversed(choices)):
        out = torch.where(c, v, out)
    return out


def is_delta(params: BsdfParams) -> torch.Tensor:
    return (params.kind == MIRROR) | (params.kind == GLASS)


def resolve_bsdf(mat_kind, diffuse, specular, exponent, eta, d_prob, s_prob,
                 u_lobe) -> BsdfParams:
    """Material rows -> per-lane BSDF, with plastic's stochastic lobe pick:
    the Phong lobe with probability s_prob, the chosen lobe's reflectance
    scaled by 1/prob (ky.cpp:2661-2672). All arguments are per-lane
    gathers; u_lobe (N,) is a uniform draw."""
    pick_spec = u_lobe < s_prob
    plastic_kind = torch.where(pick_spec, PHONG, LAMBERT).to(torch.int32)
    plastic_color = torch.where(
        pick_spec[:, None],
        specular / torch.clamp_min(s_prob, 1e-12)[:, None],
        diffuse / torch.clamp_min(d_prob, 1e-12)[:, None])
    is_m = [mat_kind == MAT_MATTE, mat_kind == MAT_MIRROR,
            mat_kind == MAT_GLASS]
    kind = select(is_m, [torch.full_like(mat_kind, LAMBERT),
                         torch.full_like(mat_kind, MIRROR),
                         torch.full_like(mat_kind, GLASS)], plastic_kind)
    color = select([m[:, None] for m in is_m], [diffuse, specular, specular],
                   plastic_color)
    return BsdfParams(kind=kind, color=color, color2=diffuse, eta=eta,
                      exponent=exponent)


# ---------------------------------------------------------------------------
# local-frame eval / pdf / sample (z = shading normal)
# ---------------------------------------------------------------------------


def _same_hemisphere(wo, wi):
    return wo[..., 2] * wi[..., 2] > 0


def _mirror(wo):
    return torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)


def _phong_lobe(wo, wi, exponent):
    """(scale of eval, pdf) of the modified-Phong lobe; the caller applies
    the colour. cos^e is taken at cos clamped away from 0 and masked after,
    so d val / d exponent = val log(cos) stays finite at grazing alpha (the
    exponent is a trainable parameter)."""
    cos_alpha = km.dot(_mirror(wo), wi)
    powa = km.power(torch.clamp_min(cos_alpha, 1e-12), exponent)
    front = _same_hemisphere(wo, wi) & (cos_alpha > 0.0)
    zero = torch.zeros_like(powa)
    val = torch.where(front, (exponent + 2.0) * km.INV_2PI * powa, zero)
    pdf = torch.where(cos_alpha > 0.0, (exponent + 1.0) * powa * km.INV_2PI,
                      zero)
    return val, pdf


def eval_local(params: BsdfParams, wo, wi) -> torch.Tensor:
    """f(wo, wi) in the local frame; delta lobes evaluate to 0."""
    same = _same_hemisphere(wo, wi)
    zero3 = torch.zeros_like(params.color)
    f_lambert = torch.where(same[:, None], params.color * km.INV_PI, zero3)
    phong_val, _ = _phong_lobe(wo, wi, params.exponent)
    f_phong = params.color * phong_val[:, None]
    return select([(params.kind == LAMBERT)[:, None],
                   (params.kind == PHONG)[:, None]],
                  [f_lambert, f_phong], zero3)


def pdf_local(params: BsdfParams, wo, wi) -> torch.Tensor:
    """Solid-angle pdf. The reference's Phong pdf has no same-hemisphere
    gate (ky.cpp:2502-2508); kept."""
    same = _same_hemisphere(wo, wi)
    pdf_lambert = torch.where(
        same, km.cosine_hemisphere_pdf(torch.abs(wi[..., 2])),
        torch.zeros_like(wi[..., 2]))
    _, pdf_phong = _phong_lobe(wo, wi, params.exponent)
    return select([params.kind == LAMBERT, params.kind == PHONG],
                  [pdf_lambert, pdf_phong], torch.zeros_like(pdf_lambert))


def _phong_cosine_lobe_sample(u, exponent):
    phi = km.TWO_PI * u[..., 0]
    cos_theta = km.power(u[..., 1], km.div(1.0, exponent + 1.0))
    sin_theta = km.safe_sqrt(1.0 - cos_theta * cos_theta)
    return torch.stack([km.cos(phi) * sin_theta, km.sin(phi) * sin_theta,
                        cos_theta], dim=-1)


def sample_local(params: BsdfParams, wo, u2) -> BsdfSample:
    """Sample wi from the lane's lobe -> f, wi, pdf and the delta flag.
    Every model's sample is computed and selected by kind; the glass branch
    takes u2[..., 0] as its reflect/refract draw (ky.cpp:2375)."""
    mirror_wi = _mirror(wo)
    flip = (wo[..., 2] < 0)[:, None]
    neg_z = wo.new_tensor([1.0, 1.0, -1.0])

    # Lambert
    wi_lam = km.cosine_hemisphere_sample(u2)
    wi_lam = torch.where(flip, wi_lam * neg_z, wi_lam)
    same_lam = _same_hemisphere(wo, wi_lam)
    f_lam = torch.where(same_lam[:, None], params.color * km.INV_PI,
                        torch.zeros_like(params.color))
    pdf_lam = torch.where(
        same_lam, km.cosine_hemisphere_pdf(torch.abs(wi_lam[..., 2])),
        torch.zeros_like(wi_lam[..., 2]))

    # mirror
    abs_cos_m = torch.clamp_min(torch.abs(mirror_wi[..., 2]), 1e-12)
    f_mir = params.color / abs_cos_m[:, None]
    pdf_mir = torch.ones_like(abs_cos_m)

    # glass
    fr = km.fresnel_dielectric(wo[..., 2], torch.ones_like(params.eta),
                               params.eta)
    take_reflect = u2[..., 0] < fr
    into = wo[..., 2] > 0
    n_loc = torch.where(into[:, None], wo.new_tensor([0.0, 0.0, 1.0]),
                        wo.new_tensor([0.0, 0.0, -1.0]))
    eta_ratio = torch.where(into, km.div(1.0, params.eta), params.eta)
    wt, refr_ok = km.refract(wo, n_loc, eta_ratio)
    wi_gl = torch.where(take_reflect[:, None], mirror_wi, wt)
    abs_cos_g = torch.clamp_min(torch.abs(wi_gl[..., 2]), 1e-12)
    f_refl = params.color * (fr / abs_cos_g)[:, None]
    f_refr = params.color2 * ((1.0 - fr) / abs_cos_g)[:, None]
    f_gl = torch.where(take_reflect[:, None], f_refl,
                       torch.where(refr_ok[:, None], f_refr,
                                   torch.zeros_like(f_refr)))
    pdf_gl = torch.where(take_reflect, fr,
                         torch.where(refr_ok, 1.0 - fr, torch.zeros_like(fr)))

    # phong: the sample map u -> wi does not carry the exponent's gradient
    # (f/pdf is differentiated at fixed samples)
    lobe = _phong_cosine_lobe_sample(u2, params.exponent.detach())
    s, t, nf = kframe.make_frame(mirror_wi)
    wi_ph = kframe.to_world(s, t, nf, lobe)
    wi_ph = torch.where(flip, wi_ph * neg_z, wi_ph)
    ph_val, pdf_ph = _phong_lobe(wo, wi_ph, params.exponent)
    f_ph = params.color * ph_val[:, None]

    kinds = params.kind
    sel = [kinds == LAMBERT, kinds == MIRROR, kinds == GLASS]
    sel3 = [c[:, None] for c in sel]
    return BsdfSample(
        f=select(sel3, [f_lam, f_mir, f_gl], f_ph),
        wi=select(sel3, [wi_lam, mirror_wi, wi_gl], wi_ph),
        pdf=select(sel, [pdf_lam, pdf_mir, pdf_gl], pdf_ph),
        delta=(kinds == MIRROR) | (kinds == GLASS))


# ---------------------------------------------------------------------------
# world-frame wrappers (the reference's bsdf_t world <-> local shim,
# ky.cpp:2147-2210)
# ---------------------------------------------------------------------------


def eval_world(params: BsdfParams, normal, wo_world, wi_world):
    s, t, n = kframe.make_frame(normal)
    return eval_local(params, kframe.to_local(s, t, n, wo_world),
                      kframe.to_local(s, t, n, wi_world))


def pdf_world(params: BsdfParams, normal, wo_world, wi_world):
    s, t, n = kframe.make_frame(normal)
    return pdf_local(params, kframe.to_local(s, t, n, wo_world),
                     kframe.to_local(s, t, n, wi_world))


def eval_and_pdf_world(params: BsdfParams, normal, wo_world, wi_world):
    s, t, n = kframe.make_frame(normal)
    wo = kframe.to_local(s, t, n, wo_world)
    wi = kframe.to_local(s, t, n, wi_world)
    return eval_local(params, wo, wi), pdf_local(params, wo, wi)


def sample_world(params: BsdfParams, normal, wo_world, u2) -> BsdfSample:
    s, t, n = kframe.make_frame(normal)
    smp = sample_local(params, kframe.to_local(s, t, n, wo_world), u2)
    return BsdfSample(f=smp.f, wi=kframe.to_world(s, t, n, smp.wi),
                      pdf=smp.pdf, delta=smp.delta)
