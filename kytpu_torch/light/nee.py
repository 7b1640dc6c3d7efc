"""Next-event estimation: six direct-lighting strategies with MIS
(kytpu/light/nee.py).

Each estimator runs over the whole ray batch; the per-light loop unrolls in
Python, one kind-specialised block a light. The strategies
(direct_sample_enum_t, ky.cpp:3608-3623):
  - "idle":      nothing (emission-only rendering);
  - "bsdf":      sample the BSDF, hit the light             (ky.cpp:3889-3930)
  - "light":     sample the light, test occlusion           (ky.cpp:3933-3962)
  - "bsdf_mis":  BSDF sampling with the folded one-sample balance weight
                 Ld = 2 f cos Li / (pdf_b + pdf_l)           (ky.cpp:3968-4033)
  - "light_mis": light sampling with the dual weight        (ky.cpp:4035-4074)
  - "both_mis":  0.5 bsdf_mis + 0.5 light_mis on the same draws
                 (ky.cpp:4076-4088).
Light selection "all" loops over every light (ky.cpp:3834-3872); "single"
picks one uniformly and scales by L (ky.cpp:3813-3832).

Every pdf and sampled direction is detached; radiance and BSDF numerators
carry gradients.
"""

from __future__ import annotations

import torch

from kytpu_torch import bsdf as kbsdf
from kytpu_torch.core import math as km
from kytpu_torch.core import rng as krng
from kytpu_torch.light import lights as klights
from kytpu_torch.scene import scene as kscene
from kytpu_torch.scene import shapes as kshapes

STRATEGIES = ("idle", "bsdf", "light", "bsdf_mis", "light_mis", "both_mis")


def _black(f):
    """color_t::is_black: every component <= 0 (ky.cpp:258)."""
    return (f <= 0.0).all(dim=-1)


def _masked(ok, x):
    return torch.where(ok[:, None], x, torch.zeros_like(x))


def _estimate_by_bsdf(scene, i, hit, params, u_bsdf, active, mis: bool):
    """BSDF-sampled direct light of light i (ky.cpp:3889-3930 / 3968-4033);
    `active` already leaves out delta-BSDF lanes and misses."""
    kind = scene.lights.kinds[i]
    if klights.is_delta_light(kind):
        return torch.zeros_like(hit.position)
    bs = kbsdf.sample_world(params, hit.normal, hit.wo, u_bsdf)
    wi = bs.wi.detach()
    pdf_b = bs.pdf.detach()
    f_cos = bs.f * km.absdot(wi, hit.normal)[:, None]
    ok = active & ~_black(f_cos) & (pdf_b > 0.0)

    o = kshapes.offset_ray_origin(hit.position, hit.normal, wi)
    h2 = kscene.intersect(scene, o, wi)
    li_hit = _masked(h2.light_index == i, h2.emission)
    if kind == klights.ENV:
        li_miss = scene.env_radiance(wi.shape[0])
    else:
        li_miss = torch.zeros_like(li_hit)
    li = torch.where(h2.valid[:, None], li_hit, li_miss)
    ok = ok & ~_black(li)

    if mis:
        pdf_l = klights.pdf_li(scene.lights, i, hit.position, hit.normal,
                               wi).detach()
        w = torch.where(pdf_l > 0.0, km.safe_div(2.0, pdf_b + pdf_l),
                        torch.zeros_like(pdf_l))
        ld = f_cos * li * w[:, None]
    else:
        ld = f_cos * li * km.safe_div(1.0, pdf_b)[:, None]
    return _masked(ok, ld)


def _estimate_by_emitter(scene, i, hit, params, u_light, active, mis: bool,
                         shadow: str = "parity"):
    """Light-sampled direct light of light i (ky.cpp:3933-3962 /
    4035-4074). shadow="parity" keeps the reference's self-occlusion quirk
    (`scene.occluded`); "robust" measures tmax from the offset origin and
    leaves the light's own surface out."""
    kind = scene.lights.kinds[i]
    ls = klights.sample_li(scene.lights, i, scene.world_radius,
                           hit.position, hit.normal, u_light)
    wi = ls.wi.detach()
    pdf_l = ls.pdf.detach()
    ok = active & ~_black(ls.li) & (pdf_l > 0.0)

    if shadow == "robust":
        o = kshapes.offset_ray_origin(hit.position, hit.normal, wi)
        dist = km.distance(o, ls.position)
        shadowed = kscene.occluded_from(scene, o, wi,
                                        dist - km.SHADOW_EPSILON,
                                        skip_row=scene.lights.surface_ids[i])
    else:
        dist = km.distance(hit.position, ls.position)
        shadowed = kscene.occluded(scene, hit.position, hit.normal, wi, dist)
    ok = ok & ~shadowed

    f_cos = (kbsdf.eval_world(params, hit.normal, hit.wo, wi)
             * km.absdot(wi, hit.normal)[:, None])
    ok = ok & ~_black(f_cos)

    if mis and not klights.is_delta_light(kind):
        pdf_b = kbsdf.pdf_world(params, hit.normal, hit.wo, wi).detach()
        ld = 2.0 * f_cos * ls.li * km.safe_div(1.0, pdf_l + pdf_b)[:, None]
    else:
        ld = f_cos * ls.li * km.safe_div(1.0, pdf_l)[:, None]
    return _masked(ok, ld)


def _estimate_one_light(scene, i, hit, params, u_light, u_bsdf, active,
                        strategy: str, shadow: str = "parity"):
    if strategy == "idle":
        return torch.zeros_like(hit.position)
    if strategy == "bsdf":
        return _estimate_by_bsdf(scene, i, hit, params, u_bsdf, active, False)
    if strategy == "light":
        return _estimate_by_emitter(scene, i, hit, params, u_light, active,
                                    False, shadow)
    if strategy == "bsdf_mis":
        return _estimate_by_bsdf(scene, i, hit, params, u_bsdf, active, True)
    if strategy == "light_mis":
        return _estimate_by_emitter(scene, i, hit, params, u_light, active,
                                    True, shadow)
    if strategy == "both_mis":
        # the reference's quirk, kept as kytpu keeps it: for a delta light
        # Lb is identically 0 (ky.cpp:3889-3892) yet the 0.5/0.5 weights
        # still apply, so both_mis halves point and directional lights
        # against "light" (ky.cpp:4076-4088); both halves take the same
        # draws (ky.cpp:4081-4082). integrator/fast.py does not halve them.
        lb = _estimate_by_bsdf(scene, i, hit, params, u_bsdf, active, True)
        ll = _estimate_by_emitter(scene, i, hit, params, u_light, active,
                                  True, shadow)
        return 0.5 * lb + 0.5 * ll
    raise ValueError(f"unknown strategy {strategy!r}")


def sample_all_lights(scene, hit, params, keys, active, strategy: str,
                      light_selection: str = "all", sampler: str = "random",
                      index=None, shadow: str = "parity"):
    """Direct lighting at the hits -> (N, 3). `active` leaves out misses and
    delta-BSDF lanes; `keys` (N, 2) are this bounce's NEE keys. Light i's
    draws come from bounce_key(keys, 1000 + i) under "all"; "single"
    evaluates every light on the lanes that picked it, as kytpu's jnp
    engines do (the cost stays O(L))."""
    n_lights = scene.n_lights
    if n_lights == 0 or strategy == "idle":
        return torch.zeros_like(hit.position)

    if light_selection == "single":
        k_sel, k_draw = krng.split_channels(keys, 2)
        u_sel = krng.uniform(k_sel, sampler=sampler, index=index)
        idx = torch.clamp_max((u_sel * n_lights).to(torch.int32),
                              n_lights - 1)
        k_l, k_b = krng.split_channels(k_draw, 2)
        u_light = krng.uniform2(k_l, sampler, index)
        u_bsdf = krng.uniform2(k_b, sampler, index)
        ld = torch.zeros_like(hit.position)
        for i in range(n_lights):
            ld = ld + _estimate_one_light(scene, i, hit, params, u_light,
                                          u_bsdf, active & (idx == i),
                                          strategy, shadow)
        return ld * float(n_lights)

    ld = torch.zeros_like(hit.position)
    for i in range(n_lights):
        k_l, k_b = krng.split_channels(krng.bounce_key(keys, 1000 + i), 2)
        u_light = krng.uniform2(k_l, sampler, index)
        u_bsdf = krng.uniform2(k_b, sampler, index)
        ld = ld + _estimate_one_light(scene, i, hit, params, u_light, u_bsdf,
                                      active, strategy, shadow)
    return ld
