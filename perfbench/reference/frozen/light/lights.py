# Frozen copy of kytpu_torch/light/lights.py at commit 35fb5ad, imports
# rewritten to this package: the benchmark's plain reference.
"""Lights: point, directional, area (rect, sphere) and a constant
environment (kytpu/light/lights.py).

The lights live in one table whose kinds and emitting-surface bindings are
host metadata, so a per-light loop unrolls in Python into kind-specialised
tensor code. The shape parameters and the emitted colour are float32
tensors, row i for light i. The kernels sample lights with their own copy
(kernels/wavefront.py, csrc/megakernel.cuh); `sample_li` and `pdf_li` are
the jnp engines'.

Parity targets: point light Li = I/d^2, pdf 1 (ky.cpp:2825-2853);
directional light Li = E from a virtual position at 2 world radii
(ky.cpp:2891-2901); one-sided area lights (ky.cpp:2957-2960) sampled by
their shape's solid-angle sampling (rect: bilinear position and the
area -> solid-angle conversion, ky.cpp:1028-1051, 1307-1315; sphere: a
uniform cone with the Taylor fallback, ky.cpp:1419-1513); the environment
light's uniform-sphere direction reported with the 1/(2 pi^2 sin theta)
pdf (ky.cpp:3026-3052). As in kytpu, the reference's inside-a-sphere-light
conversion divides by |dot(shade normal, -wi)| (ky.cpp:1436), and the
environment's pdf mismatch is kept.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from perfbench.reference.frozen.core import frame as kframe
from perfbench.reference.frozen.core import math as km

POINT = 0
DIRECTION = 1
AREA_RECT = 2
AREA_SPHERE = 3
ENV = 4


def is_delta_light(kind: int) -> bool:
    return kind in (POINT, DIRECTION)


@dataclass(frozen=True)
class Lights:
    """Row i is light i; `kinds` and `surface_ids` are host tuples."""

    kinds: tuple
    surface_ids: tuple
    emit: torch.Tensor        # (L,3) intensity I / irradiance E / radiance L
    position: torch.Tensor    # (L,3) point-light position
    direction: torch.Tensor   # (L,3) directional-light direction (unit)
    p0: torch.Tensor          # (L,3) area-rect corners
    p1: torch.Tensor
    p2: torch.Tensor
    p3: torch.Tensor
    normal: torch.Tensor      # (L,3) canonical rect normal
    area: torch.Tensor        # (L,)
    center: torch.Tensor      # (L,3) area-sphere centre
    radius: torch.Tensor      # (L,)

    def to(self, device) -> "Lights":
        return Lights(**{f.name: (getattr(self, f.name).to(device)
                                  if isinstance(getattr(self, f.name),
                                                torch.Tensor)
                                  else getattr(self, f.name))
                         for f in fields(self)})


@dataclass(frozen=True)
class LightSample:
    position: torch.Tensor  # (N,3) point on or towards the light
    wi: torch.Tensor        # (N,3) unit, shade point -> light
    pdf: torch.Tensor       # (N,) solid-angle pdf
    li: torch.Tensor        # (N,3) incident radiance


def _lit(mask, radiance, like):
    """radiance (3,) where mask (N,), else 0 -> (N, 3)."""
    return torch.where(mask[:, None], radiance[None].expand_as(like),
                       torch.zeros_like(like))


def _finite_or_zero(pdf, ok):
    return torch.where(ok & torch.isfinite(pdf), pdf, torch.zeros_like(pdf))


def _rect_sample(p0, p1, p2, n_l, area, radiance, p, u2) -> LightSample:
    light_pos = (p1[None] + u2[:, 0:1] * (p0 - p1)[None]
                 + u2[:, 1:2] * (p2 - p1)[None])
    wi_vec = light_pos - p
    d2 = km.length_squared(wi_vec)
    wi = km.safe_normalize(wi_vec)
    cos_l = km.absdot(n_l[None], -wi)
    pdf = _finite_or_zero(km.safe_div(d2, cos_l * area), d2 > 0)
    facing = km.dot(n_l[None], -wi) > 0.0
    return LightSample(position=light_pos, wi=wi, pdf=pdf,
                       li=_lit(facing & (pdf > 0), radiance, wi))


def _sphere_sample(center, radius, radiance, p, n_shade, u2) -> LightSample:
    c = center[None]
    d2c = km.distance_squared(p, c)
    inside = d2c <= radius * radius

    # outside: a uniform cone towards the sphere (ky.cpp:1445-1500)
    dist = km.sqrt(torch.clamp_min(d2c, 1e-20))
    inv_dist = km.div(1.0, dist)
    sin_max = radius * inv_dist
    sin2_max = sin_max * sin_max
    inv_sin_max = km.safe_div(1.0, sin_max, 1.0)
    cos_max = km.safe_sqrt(1.0 - sin2_max)

    cos_theta = (cos_max - 1.0) * u2[:, 0] + 1.0
    sin2 = 1.0 - cos_theta * cos_theta
    # Taylor fallback for tiny subtended angles (ky.cpp:1470-1476)
    tiny = sin2_max < 0.00068523
    sin2 = torch.where(tiny, sin2_max * u2[:, 0], sin2)
    cos_theta = torch.where(tiny, km.safe_sqrt(1.0 - sin2), cos_theta)

    cos_alpha = sin2 * inv_sin_max + cos_theta * km.safe_sqrt(
        1.0 - sin2 * inv_sin_max * inv_sin_max)
    sin_alpha = km.safe_sqrt(1.0 - cos_alpha * cos_alpha)
    phi = u2[:, 1] * km.TWO_PI

    to_c = (c - p) * inv_dist[:, None]
    s, t, nf = kframe.make_frame(to_c)
    n_cone = km.spherical_to_direction_in_frame(sin_alpha, cos_alpha, phi,
                                                -s, -t, -nf)
    pos_cone = c + radius * n_cone
    pdf_cone = km.safe_div(1.0, km.TWO_PI * (1.0 - cos_max))
    pdf_cone = _finite_or_zero(pdf_cone, torch.ones_like(inside))

    # inside: a uniform area sample (ky.cpp:1422-1443)
    dir_u = km.uniform_sphere_sample(u2)
    pos_in = c + radius * dir_u
    wi_in_vec = pos_in - p
    d2_in = km.length_squared(wi_in_vec)
    wi_in = km.safe_normalize(wi_in_vec)
    area = 4.0 * km.PI * radius * radius
    # the reference divides by |dot(SHADE normal, -wi)| here (ky.cpp:1436)
    pdf_in = _finite_or_zero(
        km.safe_div(d2_in, area * km.absdot(n_shade, -wi_in)), d2_in > 0)

    sel = inside[:, None]
    pos = torch.where(sel, pos_in, pos_cone)
    n_l = torch.where(sel, dir_u, n_cone)
    pdf = torch.where(inside, pdf_in, pdf_cone)
    wi = km.safe_normalize(pos - p)
    facing = km.dot(n_l, -wi) > 0.0
    return LightSample(position=pos, wi=wi, pdf=pdf,
                       li=_lit(facing & (pdf > 0), radiance, wi))


def _env_pdf(wi):
    """The reference's angle-space density 1/(2 pi^2 sin theta) of a
    direction that is uniform on the sphere (ky.cpp:3029-3035)."""
    sin_theta = km.sin(km.spherical_theta(wi))
    return torch.where(
        sin_theta == 0.0, torch.zeros_like(sin_theta),
        km.div(1.0, 2.0 * km.PI * km.PI * torch.clamp_min(sin_theta, 1e-20)))


def sample_li(lights: Lights, i: int, world_radius, p, n_shade,
              u2) -> LightSample:
    """Sample a direction to light i (a python int) from the shade points p
    (N, 3); u2 (N, 2) uniforms."""
    kind = lights.kinds[i]
    n = p.shape[0]
    radiance = lights.emit[i]
    ones = torch.ones(n, dtype=p.dtype, device=p.device)

    if kind == POINT:
        lp = lights.position[i][None]
        wi = km.safe_normalize(lp - p)
        li = radiance[None] / torch.clamp_min(km.distance_squared(lp, p),
                                              1e-20)[:, None]
        return LightSample(position=lp.expand(n, 3), wi=wi, pdf=ones, li=li)
    if kind == DIRECTION:
        wi = (-lights.direction[i])[None].expand(n, 3)
        return LightSample(position=p + wi * (2.0 * world_radius), wi=wi,
                           pdf=ones, li=radiance[None].expand(n, 3))
    if kind == AREA_RECT:
        return _rect_sample(lights.p0[i], lights.p1[i], lights.p2[i],
                            lights.normal[i], lights.area[i], radiance, p, u2)
    if kind == AREA_SPHERE:
        return _sphere_sample(lights.center[i], lights.radius[i], radiance,
                              p, n_shade, u2)
    if kind == ENV:
        wi = km.uniform_sphere_sample(u2)
        return LightSample(position=p + wi * (2.0 * world_radius), wi=wi,
                           pdf=_env_pdf(wi), li=radiance[None].expand(n, 3))
    raise ValueError(f"unknown light kind {kind}")


def _rect_reintersect_pdf(p0, p1, p2, p3, n_l, area, p, n_shade, wi):
    """shape_t::pdf_direction of one rectangle (ky.cpp:1055-1090): spawn an
    offset ray, intersect only this rect, convert area -> solid angle."""
    o = km.offset_ray_origin(p, n_shade, wi)
    oa, ob, oc, od = (q[None] - o for q in (p0, p1, p2, p3))
    v0d = km.dot(km.cross(oc, ob), wi)
    v1d = km.dot(km.cross(ob, oa), wi)
    v2d = km.dot(km.cross(oa, od), wi)
    v3d = km.dot(km.cross(od, oc), wi)
    inside = (((v0d < 0) & (v1d < 0) & (v2d < 0) & (v3d < 0))
              | ((v0d >= 0) & (v1d >= 0) & (v2d >= 0) & (v3d >= 0)))
    denom = km.dot(n_l[None], wi)
    t = km.safe_div(km.dot(n_l[None], oa), denom, km.INF)
    hit = inside & (t > km.SHAPE_EPSILON) & torch.isfinite(t)
    hit_p = o + t[:, None] * wi
    d2 = km.distance_squared(p, hit_p)
    return _finite_or_zero(km.safe_div(d2, km.absdot(n_l[None], -wi) * area),
                           hit)


def _sphere_reintersect_pdf(center, radius, p, n_shade, wi):
    """Re-intersect pdf for shade points inside the sphere."""
    o = km.offset_ray_origin(p, n_shade, wi)
    oc = center[None] - o
    neg_b = km.dot(oc, wi)
    discr = neg_b * neg_b - km.length_squared(oc) + radius * radius
    sq = km.safe_sqrt(discr)
    t1, t2 = neg_b - sq, neg_b + sq
    t1_ok = t1 > km.SHAPE_EPSILON
    t2_ok = t2 > km.SHAPE_EPSILON
    t = torch.where(t1_ok, t1, t2)
    hit = (discr >= 0) & (t1_ok | t2_ok)
    hit_p = o + t[:, None] * wi
    n_hit = km.safe_normalize(hit_p - center[None])
    area = 4.0 * km.PI * radius * radius
    return _finite_or_zero(km.safe_div(km.distance_squared(p, hit_p),
                                       km.absdot(n_hit, -wi) * area), hit)


def pdf_li(lights: Lights, i: int, p, n_shade, wi):
    """Solid-angle pdf of light i for the directions wi from the shade
    points p, light_t::pdf_Li (the BSDF side's MIS weight)."""
    kind = lights.kinds[i]
    if kind in (POINT, DIRECTION):
        return torch.zeros(p.shape[0], dtype=p.dtype, device=p.device)
    if kind == AREA_RECT:
        return _rect_reintersect_pdf(
            lights.p0[i], lights.p1[i], lights.p2[i], lights.p3[i],
            lights.normal[i], lights.area[i], p, n_shade, wi)
    if kind == AREA_SPHERE:
        c, r = lights.center[i], lights.radius[i]
        d2c = km.distance_squared(p, c[None])
        inside = d2c <= r * r
        sin2_max = km.safe_div(r * r, d2c, 1.0)
        cos_max = km.safe_sqrt(1.0 - sin2_max)
        pdf_cone = km.safe_div(1.0, km.TWO_PI * (1.0 - cos_max))
        pdf_cone = _finite_or_zero(pdf_cone, torch.ones_like(inside))
        return torch.where(inside, _sphere_reintersect_pdf(c, r, p, n_shade,
                                                           wi), pdf_cone)
    if kind == ENV:
        return _env_pdf(wi)
    raise ValueError(f"unknown light kind {kind}")


def light_power(lights: Lights, i: int, world_radius):
    """Total emitted power (ky.cpp:2822, 2930, 3555-3574)."""
    kind = lights.kinds[i]
    e = lights.emit[i]
    if kind == POINT:
        return 4.0 * km.PI * e
    if kind in (DIRECTION, ENV):
        return e * (km.PI * world_radius * world_radius)
    if kind == AREA_RECT:
        return e * lights.area[i] * km.PI
    if kind == AREA_SPHERE:
        r = lights.radius[i]
        return e * (4.0 * km.PI * r * r) * km.PI
    raise ValueError(f"unknown light kind {kind}")
