"""The production wavefront integrator: one-sample MIS path tracing
(kytpu/integrator/fast.py).

The reference's both_mis draws an independent BSDF sample per light per
vertex (ky.cpp:3981-4029, 3864-3869), 2L+1 scene sweeps a bounce with L
lights. This formulation has the same expectation with fewer sweeps:
  - the extension ray is the BSDF-side MIS sample of every light: where it
    hits an emitter (or the environment), the emission is weighted by the
    balance heuristic against that light's solid-angle pdf;
  - the L shadow rays of the light-side NEE are stacked into one (L x N)
    occlusion sweep;
  - a bounce's uniforms come from one draw of 2L + 4 floats a lane.
Delta (point, directional) lights get their full light-sampled
contribution here; the reference's both_mis halves them (light/nee.py).

Sampling is detached as in integrator/path.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from kytpu_torch import bsdf as kbsdf
from kytpu_torch.core import math as km
from kytpu_torch.core import rng as krng
from kytpu_torch.light import lights as klights
from kytpu_torch.scene import accel as kaccel
from kytpu_torch.scene import scene as kscene
from kytpu_torch.scene import shapes as kshapes

SAMPLERS = ("random", "debug", "sobol")


@dataclass(frozen=True)
class FastConfig:
    """The fused integrator's configuration (kytpu's fields and defaults;
    `unroll` has no effect in the port's Python bounce loop)."""

    max_depth: int = 5
    rr_start: int = 3
    unroll: int = 1
    # "random": one threefry draw of 2L + 4 uniforms a bounce; "debug":
    # every draw 0.5 (ky.cpp:922-947); "sobol": per-purpose Owen-scrambled
    # draws, the lane's key folding the pixel alone and the sample id the
    # point index (render.trace_lanes does both)
    sampler: str = "random"   # "random" | "debug" | "sobol"
    filter: str = "box"       # "box" | "tent"
    shadow: str = "parity"    # "parity" | "robust"


def _draws(keys, bounce: int, n_draws: int, sampler: str):
    """All of a bounce's uniforms in one draw: uniform(fold_in(k, bounce),
    (n_draws,)) a lane -> (N, n_draws)."""
    if sampler == "debug":
        return torch.full((keys.shape[0], n_draws), 0.5, dtype=torch.float32,
                          device=keys.device)
    return krng.uniform(krng.fold_in(keys, bounce), (n_draws,))


def _draws_sobol(keys, bounce: int, n_lights: int, index):
    """Per-purpose Owen-Sobol draws in _draws' column order: lobe | L x (2
    light) | 2 bsdf | 1 rr."""
    parts = krng.split_channels(krng.bounce_key(keys, bounce), n_lights + 3)
    cols = [krng.uniform(parts[0], (), "sobol", index)[:, None]]
    cols += [krng.uniform2(parts[1 + i], "sobol", index)
             for i in range(n_lights)]
    cols.append(krng.uniform2(parts[n_lights + 1], "sobol", index))
    cols.append(krng.uniform(parts[n_lights + 2], (), "sobol",
                             index)[:, None])
    return torch.cat(cols, dim=-1)


def _hit_light_pdf(scene, prev_o, prev_n, d, light_index):
    """Solid-angle pdf of the light the extension ray hit (0 if none): each
    area light's pdf on the lanes that hit it; delta and environment lights
    give 0."""
    pdf = torch.zeros(d.shape[0], dtype=d.dtype, device=d.device)
    for i, kind in enumerate(scene.lights.kinds):
        if klights.is_delta_light(kind) or kind == klights.ENV:
            continue
        pi = klights.pdf_li(scene.lights, i, prev_o, prev_n, d)
        pdf = torch.where(light_index == i, pi, pdf)
    return pdf


def _env_index(scene):
    for i, kind in enumerate(scene.lights.kinds):
        if kind == klights.ENV:
            return i
    return None


def _mis(full, pdf_prev, pdf_l):
    return torch.where(full, torch.ones_like(pdf_prev),
                       km.safe_div(pdf_prev, pdf_prev + pdf_l))


def li_path_fast(scene, o, d, keys, cfg: FastConfig, index=None):
    """Radiance of a batch of primary rays -> (N, 3). Under sampler
    "sobol" the keys fold the pixel alone and `index` holds the lanes'
    sample ids."""
    if cfg.sampler not in SAMPLERS:
        raise ValueError(f"fast engine: unsupported sampler {cfg.sampler!r}")
    if cfg.sampler == "sobol" and index is None:
        raise ValueError("fast engine: sampler='sobol' needs the per-lane "
                         "sample index (render.trace_lanes passes it)")
    n = o.shape[0]
    L = scene.n_lights
    n_draws = 2 * L + 4   # lobe | L x 2 light | 2 bsdf | 1 rr
    env_i = _env_index(scene)
    dev = o.device

    beta = torch.ones((n, 3), dtype=o.dtype, device=dev)
    big_l = torch.zeros((n, 3), dtype=o.dtype, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    prev_n = -d   # the "previous normal" of camera rays: a placeholder
    spec_prev = torch.zeros(n, dtype=torch.bool, device=dev)
    pdf_prev = torch.ones(n, dtype=o.dtype, device=dev)
    for bounce in range(cfg.max_depth + 1):
        hit = kscene.intersect(scene, o, d)
        if cfg.sampler == "sobol":
            u = _draws_sobol(keys, bounce, L, index)
        else:
            u = _draws(keys, bounce, n_draws, cfg.sampler)

        # emission, weighted by the BSDF side's MIS weight
        le = torch.where(hit.valid[:, None], hit.emission,
                         torch.zeros_like(hit.emission))
        pdf_l_hit = _hit_light_pdf(scene, o, prev_n, d,
                                   hit.light_index).detach()
        full = (torch.ones_like(alive) if bounce == 0 else spec_prev)
        w_emit = _mis(full, pdf_prev, pdf_l_hit)
        big_l = big_l + torch.where(alive[:, None],
                                    beta * le * w_emit[:, None],
                                    torch.zeros_like(le))
        if env_i is not None:
            le_env = scene.env_radiance(n)
            pdf_env = klights.pdf_li(scene.lights, env_i, o, prev_n,
                                     d).detach()
            w_env = _mis(full, pdf_prev, pdf_env)
            big_l = big_l + torch.where(
                (alive & ~hit.valid)[:, None], beta * le_env * w_env[:, None],
                torch.zeros_like(le_env))
        if bounce == cfg.max_depth:
            break   # no lane continues (kytpu's last scan step adds 0)
        cont = alive & hit.valid

        # the material (plastic's lobe pick takes u[:, 0])
        sid = hit.sid
        params = kbsdf.resolve_bsdf(
            scene.mat_kind[sid.long()], scene.diffuse_at(sid, hit.uv),
            km.gather(scene.mat_specular, sid),
            km.gather(scene.mat_exponent, sid), scene.mat_eta[sid.long()],
            scene.mat_d_prob[sid.long()], scene.mat_s_prob[sid.long()],
            u[:, 0])
        nee_act = cont & ~kbsdf.is_delta(params)

        # light-side NEE: sample every light, one stacked shadow sweep
        if L:
            contribs, sh_o, sh_d, sh_t = [], [], [], []
            for i, kind in enumerate(scene.lights.kinds):
                ls = klights.sample_li(scene.lights, i, scene.world_radius,
                                       hit.position, hit.normal,
                                       u[:, 1 + 2 * i:3 + 2 * i])
                wi = ls.wi.detach()
                pdf_l = ls.pdf.detach()
                f_cos = (kbsdf.eval_world(params, hit.normal, hit.wo, wi)
                         * km.absdot(wi, hit.normal)[:, None])
                if klights.is_delta_light(kind):
                    w = km.safe_div(1.0, pdf_l)
                else:
                    pdf_b = kbsdf.pdf_world(params, hit.normal, hit.wo,
                                            wi).detach()
                    w = km.safe_div(1.0, pdf_l + pdf_b)
                ok = (nee_act & (pdf_l > 0.0) & ~(ls.li <= 0.0).all(-1)
                      & ~(f_cos <= 0.0).all(-1))
                contribs.append((ok, f_cos * ls.li * w[:, None]))
                o_i = kshapes.offset_ray_origin(hit.position, hit.normal, wi)
                sh_o.append(o_i)
                sh_d.append(wi)
                d_from = o_i if cfg.shadow == "robust" else hit.position
                sh_t.append(km.distance(d_from, ls.position)
                            - km.SHADOW_EPSILON)
            oc_o, oc_d = torch.cat(sh_o), torch.cat(sh_d)
            oc_t = torch.cat(sh_t)
            if cfg.shadow == "robust":
                # each light's lanes leave its own emitting surface out
                skip = torch.cat([torch.full((n,), scene.lights.surface_ids[i],
                                             dtype=torch.int32, device=dev)
                                  for i in range(L)])
                occ = kshapes.any_hit(scene.geometry, oc_o, oc_d, oc_t,
                                      skip_row=skip)
            elif scene.accel is not None:
                occ = kaccel.grid_any_hit(scene.accel, scene.geometry, oc_o,
                                          oc_d, oc_t)
            else:
                occ = kshapes.any_hit(scene.geometry, oc_o, oc_d, oc_t)
            occ = occ.reshape(L, n)
            ld = torch.zeros((n, 3), dtype=o.dtype, device=dev)
            for i, (ok, c) in enumerate(contribs):
                ld = ld + torch.where((ok & ~occ[i])[:, None], c,
                                      torch.zeros_like(c))
            big_l = big_l + beta * ld

        # the extension ray, the next bounce's BSDF-side MIS sample
        bs = kbsdf.sample_world(params, hit.normal, hit.wo,
                                u[:, 2 * L + 1:2 * L + 3])
        wi = bs.wi.detach()
        pdf = bs.pdf.detach()
        ok = cont & ~(bs.f <= 0.0).all(-1) & (pdf != 0.0)
        throughput = bs.f * km.safe_div(km.absdot(wi, hit.normal),
                                        pdf)[:, None]

        # Russian roulette, the iteration variant's rule (ky.cpp:4601-4613)
        beta_new = beta * throughput
        if bounce > cfg.rr_start:
            q = torch.clamp_min(1.0 - km.max_component(beta_new.detach()),
                                0.05)
            kill = u[:, 2 * L + 3] < q
            beta_new = beta_new * km.safe_div(1.0, 1.0 - q)[:, None]
        else:
            kill = torch.zeros_like(ok)

        alive_n = ok & ~kill
        sel = alive_n[:, None]
        o = torch.where(sel, kshapes.offset_ray_origin(hit.position,
                                                       hit.normal, wi), o)
        d = torch.where(sel, wi, d)
        beta = torch.where(sel, beta_new, beta)
        prev_n = torch.where(sel, hit.normal, prev_n)
        spec_prev = torch.where(alive_n, bs.delta, spec_prev)
        pdf_prev = torch.where(alive_n, pdf, pdf_prev)
        alive = alive_n
    return big_l
