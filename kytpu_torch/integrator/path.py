"""Wavefront path integrators (kytpu/integrator/path.py).

The reference's integrators (ky.cpp:4094-4618) are one transport loop with
different gating, so one masked wavefront engine, a Python loop over
bounces on (N, ...) ray tensors, runs every variant:

  "simple"    ~ simple_path_tracing_recursion_t (ky.cpp:4191-4238): BSDF
      sampling only, emission at every vertex, f-max Russian roulette
      after 3 bounces;
  "recursion" ~ path_tracing_recursion_t (ky.cpp:4305-4402): NEE at
      diffuse vertices, at specular vertices a one-bounce emission peek
      with its own BSDF draw, emission otherwise at bounce 0 only;
  "defered"   ~ path_tracing_recursion_defered_t (ky.cpp:4409-4514): NEE
      at diffuse vertices, specular direct light through the
      prev-specular emission gate, f-max roulette;
  "iteration" ~ path_tracing_iteration_t (ky.cpp:4523-4618), the
      production integrator: the prev-specular gate, NEE at every non-delta
      vertex, q = max(.05, 1 - beta_max) roulette after bounce 3.

Break, specular skip and roulette are per-lane masks. Sampled directions,
pdfs and lobe and roulette decisions are detached, so the gradients with
respect to the material colours, emission and light radiance are unbiased.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from kytpu_torch import bsdf as kbsdf
from kytpu_torch.core import math as km
from kytpu_torch.core import rng as krng
from kytpu_torch.light import nee as knee
from kytpu_torch.scene import scene as kscene
from kytpu_torch.scene import shapes as kshapes

VARIANTS = ("simple", "recursion", "defered", "iteration")


@dataclass(frozen=True)
class PathConfig:
    """The integrator's configuration, kytpu's fields and defaults: the
    reference's integrator_enum_t -> variant, direct_sample_enum_t ->
    strategy and light_selection, max_path_depth -> max_depth. `unroll`
    was kytpu's scan unroll factor; the port's bounce loop is a Python
    loop, and it has no effect."""

    max_depth: int = 5
    variant: str = "iteration"
    strategy: str = "both_mis"          # one of knee.STRATEGIES
    light_selection: str = "all"        # "all" | "single"
    rr_start: int = 3                   # roulette starts after this bounce
    unroll: int = 1
    sampler: str = "random"   # "random" | "stratified" | "debug" | "sobol"
    strata: tuple = (1, 1)              # camera strata for "stratified"
    filter: str = "box"                 # "box" | "tent" (smallpt's 2x2 tent)
    # "parity" keeps the reference's shadow-ray self-occlusion quirk
    # (scene.occluded); "robust" measures the shadow tmax from the offset
    # origin
    shadow: str = "parity"              # "parity" | "robust"


def _black(f):
    return (f <= 0.0).all(dim=-1)


def _resolve(scene, hit, k_lobe, sampler="random", index=None):
    sid = hit.sid
    u_lobe = krng.uniform(k_lobe, sampler=sampler, index=index)
    return kbsdf.resolve_bsdf(
        scene.mat_kind[sid.long()], scene.diffuse_at(sid, hit.uv),
        km.gather(scene.mat_specular, sid), km.gather(scene.mat_exponent, sid),
        scene.mat_eta[sid.long()], scene.mat_d_prob[sid.long()],
        scene.mat_s_prob[sid.long()], u_lobe)


def li_path(scene, o, d, keys, cfg: PathConfig, index=None):
    """Radiance of a batch of primary rays -> (N, 3), one sample a lane.
    o, d (N, 3); keys (N, 2). Under cfg.sampler="sobol" the keys fold the
    pixel alone and `index` holds the lanes' sample ids: each (bounce,
    purpose) draw site walks its own Owen-scrambled Sobol sequence over a
    pixel's samples."""
    n = o.shape[0]
    emit_always = cfg.variant == "simple"
    emit_prev_spec = cfg.variant in ("defered", "iteration")
    use_nee = cfg.variant != "simple"
    spec_peek = cfg.variant == "recursion"
    rr_beta_q = cfg.variant == "iteration"

    beta = torch.ones((n, 3), dtype=o.dtype, device=o.device)
    big_l = torch.zeros((n, 3), dtype=o.dtype, device=o.device)
    alive = torch.ones(n, dtype=torch.bool, device=o.device)
    prev_spec = torch.zeros(n, dtype=torch.bool, device=o.device)
    env = scene.env_radiance(n)
    for bounce in range(cfg.max_depth + 1):
        hit = kscene.intersect(scene, o, d)
        le = torch.where(hit.valid[:, None], hit.emission, env)
        if emit_always:
            emit_gate = alive
        elif emit_prev_spec:
            emit_gate = alive if bounce == 0 else alive & prev_spec
        else:   # "recursion": emission for camera rays alone
            emit_gate = alive if bounce == 0 else torch.zeros_like(alive)
        big_l = big_l + torch.where(emit_gate[:, None], beta * le,
                                    torch.zeros_like(le))
        if bounce == cfg.max_depth:
            # no lane continues: kytpu's last scan step adds NEE, the peek
            # and the extension ray on no lane
            break
        cont = alive & hit.valid

        bkeys = krng.bounce_key(keys, bounce)
        k_lobe, k_nee, k_bsdf, k_rr, k_peek = krng.split_channels(bkeys, 5)
        params = _resolve(scene, hit, k_lobe, cfg.sampler, index)
        delta = kbsdf.is_delta(params)

        if use_nee:
            ld = knee.sample_all_lights(
                scene, hit, params, k_nee, cont & ~delta, cfg.strategy,
                cfg.light_selection, cfg.sampler, index, cfg.shadow)
            big_l = big_l + beta * ld

        if spec_peek:
            # path_tracing_recursion_t's specular branch (ky.cpp:4339-4350):
            # a second BSDF draw whose next hit's emission is collected,
            # spawned without the origin offset (ky.cpp:4343)
            pk = kbsdf.sample_world(params, hit.normal, hit.wo,
                                    krng.uniform2(k_peek, cfg.sampler, index))
            wi_pk = pk.wi.detach()
            h_pk = kscene.intersect(scene, hit.position, wi_pk)
            le_pk = torch.where(h_pk.valid[:, None], h_pk.emission, env)
            contrib = pk.f * le_pk * km.safe_div(
                km.absdot(wi_pk, hit.normal), pk.pdf.detach())[:, None]
            big_l = big_l + torch.where((cont & delta)[:, None],
                                        beta * contrib,
                                        torch.zeros_like(contrib))

        # the extension ray
        bs = kbsdf.sample_world(params, hit.normal, hit.wo,
                                krng.uniform2(k_bsdf, cfg.sampler, index))
        wi = bs.wi.detach()
        pdf = bs.pdf.detach()
        ok = cont & ~_black(bs.f) & (pdf != 0.0)
        throughput = bs.f * km.safe_div(km.absdot(wi, hit.normal),
                                        pdf)[:, None]
        u_rr = krng.uniform(k_rr, sampler=cfg.sampler, index=index)

        if rr_beta_q:
            # q = max(.05, 1 - beta_max) after the throughput update
            # (ky.cpp:4601-4613)
            beta_new = beta * throughput
            if bounce > cfg.rr_start:
                q = torch.clamp_min(1.0 - km.max_component(beta_new.detach()),
                                    0.05)
                kill = u_rr < q
                beta_new = beta_new * km.safe_div(1.0, 1.0 - q)[:, None]
            else:
                kill = torch.zeros_like(ok)
        else:
            # f-max roulette before the throughput update (ky.cpp:4219-4226,
            # 4389-4397, 4500-4509): continue where u < f_max
            f_max = km.max_component(bs.f.detach())
            if bounce >= cfg.rr_start:
                kill = ~(u_rr < f_max)
                scale = km.safe_div(1.0, f_max)
                beta_new = beta * throughput * scale[:, None]
            else:
                kill = torch.zeros_like(ok)
                beta_new = beta * throughput

        alive_next = ok & ~kill
        sel = alive_next[:, None]
        beta = torch.where(sel, beta_new, beta)
        o = torch.where(sel, kshapes.offset_ray_origin(hit.position,
                                                       hit.normal, wi), o)
        d = torch.where(sel, wi, d)
        prev_spec = torch.where(alive_next, bs.delta, prev_spec)
        alive = alive_next
    return big_l


def li_direct_lighting(scene, o, d, keys, cfg: PathConfig, index=None):
    """Emission plus NEE alone (direct_lighting_t, ky.cpp:4125-4155)."""
    n = o.shape[0]
    hit = kscene.intersect(scene, o, d)
    lo = torch.where(hit.valid[:, None], hit.emission, scene.env_radiance(n))
    k_lobe, k_nee = krng.split_channels(keys, 2)
    params = _resolve(scene, hit, k_lobe, cfg.sampler, index)
    active = hit.valid & ~kbsdf.is_delta(params)
    return lo + knee.sample_all_lights(scene, hit, params, k_nee, active,
                                       cfg.strategy, cfg.light_selection,
                                       cfg.sampler, index, cfg.shadow)


def li_aov(scene, o, d, keys, which: str):
    """Debug AOVs (debug_integrator_t, ky.cpp:4094-4123): "position" (the
    normalised hit position), "normal", or "basecolor", bsdf.eval(wo, n)
    (ky.cpp:4117)."""
    hit = kscene.intersect(scene, o, d)
    if which == "position":
        out = km.normalize(hit.position)
    elif which == "normal":
        out = km.normalize(hit.normal)
    elif which == "basecolor":
        params = _resolve(scene, hit, keys)
        out = kbsdf.eval_world(params, hit.normal, hit.wo, hit.normal)
    else:
        raise ValueError(f"unknown AOV {which!r}")
    return torch.where(hit.valid[:, None], out, torch.zeros_like(out))


def make_li(cfg: PathConfig | None = None, aov: str | None = None,
            direct_only: bool = False):
    """The integrator factory (create_integrator, ky.cpp:4621-4639)."""
    cfg = cfg or PathConfig()
    if aov is not None:
        return lambda scene, o, d, keys: li_aov(scene, o, d, keys, aov)
    if direct_only:
        return lambda scene, o, d, keys: li_direct_lighting(scene, o, d,
                                                            keys, cfg)
    return lambda scene, o, d, keys: li_path(scene, o, d, keys, cfg)
