"""The plain reference of the benchmark's cells past 64 surfaces, where the
port's step runs the table kernels (K6 forward, K7 backward): frames and
train steps rebuilt from the configuration, the seed and the sampler draws
on the frozen big-scene plain versions (frozen/kernels/bigscene.py) and
the scene's own builder (frozen/scene/spd.py). As oracle.py, it imports
nothing of the port and takes nothing the port made: the scene, the class
tables, the camera jitter, the kernel seeds and the optimizer are worked
out here again; the keys, seeds and the loss are oracle.py's.

Lanes are traced in blocks of oracle.BLOCK, a multiple of every tile, so a
block traces with the seed its first tile would give (oracle.trace).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from perfbench.counts.tables import TableTally
from perfbench.reference import oracle
from perfbench.reference.frozen.core import math as km
from perfbench.reference.frozen.core import rng as krng
from perfbench.reference.frozen.kernels import bigscene as bs
from perfbench.reference.frozen.kernels import wavefront as wf
from perfbench.reference.frozen.scene import scene as kscene
from perfbench.reference.frozen.scene import spd

SCENES = {"spd_balls": spd.spd_balls}


@contextlib.contextmanager
def float32():
    """The reference's float32 whole: TF32 off for CUDA matmuls and cuDNN
    while it runs (none of its sweeps is a matmul; none may round so)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def build_scene(config: dict, device):
    """The configuration's scene at its stated size."""
    return SCENES[config["scene"]](**config["args"]).to(device)


def trace(tables, cfg, o, d, seed: int, tally: TableTally | None = None,
          keep_cache: bool = False):
    """The plain K6 over all lanes in blocks -> (radiance (N, 3), [the
    blocks' (resf, resi)] if keep_cache), with oracle.trace's tile
    seeds."""
    tile = cfg.rows * wf.LANE
    if cfg.sampler != "random" or oracle.BLOCK % tile:
        raise NotImplementedError("the reference rebuilds the 'random' "
                                  "sampler's lanes in whole tiles alone")
    out, caches = [], []
    for b0 in range(0, o.shape[0], oracle.BLOCK):
        s = (seed + (b0 // tile) * oracle._TILE_MUL) & oracle._M32
        big_l, resf, resi = bs.trace_lanes_plain(
            tables, cfg, o[b0:b0 + oracle.BLOCK], d[b0:b0 + oracle.BLOCK], s,
            residual=True)
        if tally is not None:
            tally.add(tables.static, cfg, resf, resi)
        out.append(big_l)
        if keep_cache:
            caches.append((resf, resi))
    return torch.cat(out), caches


def render_frame(scene, cfg, spp: int, seed: int, rays_per_pass: int,
                 clamp: bool = True, extracted=None):
    """A frame as the port's render(engine="cuda") lays it out past 64
    surfaces (oracle.render_frame's passes, each through the plain K5)."""
    with float32():
        return _render_frame(scene, cfg, spp, seed, rays_per_pass, clamp,
                             extracted)


def _render_frame(scene, cfg, spp, seed, rays_per_pass, clamp, extracted):
    cam = scene.camera
    w, h = cam.width, cam.height
    npix = w * h
    dev = scene.device
    tables = bs.pack_big_tables(scene, cfg, extracted)
    k = max(1, min(spp, rays_per_pass // max(npix, 1)))
    pid = torch.arange(npix, dtype=torch.int64, device=dev)
    px0 = (pid % w).to(torch.float32).repeat(k)
    py0 = (pid // w).to(torch.float32).repeat(k)
    key = krng.key(seed, dev)
    accum = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
    s0 = p = 0
    while s0 < spp:
        u = krng.uniform(krng.fold_in(key, p), (k * npix, 2))
        o, d = kscene.generate_rays(
            cam, torch.stack([px0 + u[:, 0], py0 + u[:, 1]], dim=-1))
        s = (seed + 7919 * p) & oracle._M32
        s = s - (1 << 32) if s >= 1 << 31 else s
        out, _ = trace(tables, cfg, o, d, s)
        accum = accum + out.reshape(k, npix, 3).sum(dim=0)
        s0 += k
        p += 1
    img = km.div(accum, float(p * k)).reshape(h, w, 3)
    return torch.clamp(img, 0.0, 1.0) if clamp else img


def diff_tables(scene, cfg, params: dict, extracted=None):
    """The class tables a train step traces: the scene's geometry with the
    colour tables and environment of `params` (the scene's where a name is
    not trained), every light's NEE emission derived from them."""
    dev = scene.device
    geo = bs.pack_big_tables(scene, cfg, extracted)
    env = params.get("env_radiance_", scene.env_radiance_ if scene.has_env
                     else torch.zeros(3))
    env = env.to(dev, torch.float32).reshape(3).contiguous()
    em = params.get("emission", scene.emission).to(dev, torch.float32)
    return dataclasses.replace(
        geo, diffuse=params.get("mat_diffuse", scene.mat_diffuse).to(
            dev, torch.float32).contiguous(),
        specular=params.get("mat_specular", scene.mat_specular).to(
            dev, torch.float32).contiguous(),
        emission=em.contiguous(), env=env,
        light_emit=wf.light_emit_of(scene, em, env).contiguous())


# each trained name's gradient among the plain K7's (dd, ds, de, denv)
GRAD_OF = {"mat_diffuse": 0, "mat_specular": 1, "emission": 2,
           "env_radiance_": 3}


def train_steps(scene, cfg, target, params0: dict, keys, spp: int,
                lr: float, tally: TableTally | None = None, extracted=None):
    """oracle.train_steps past 64 surfaces: each step draws its kernel seed
    randint(key, 0, 2**31 - 1) and its jitter uniform(key, (spp * npix,
    2)), traces the lanes through the plain K6, takes relmse of the mean
    image, its gradient through the plain K7 block by block, one Adam step
    over the names of params0 and the clamp to >= 0 -> (losses, the first
    step's gradients, the parameters after the last step)."""
    with float32():
        return _train_steps(scene, cfg, target, params0, keys, spp, lr,
                            tally, extracted)


def _train_steps(scene, cfg, target, params0, keys, spp, lr, tally,
                 extracted):
    cam = scene.camera
    w, h = cam.width, cam.height
    npix = w * h
    dev = scene.device
    names = tuple(params0)
    lane_pid = torch.arange(npix, device=dev).repeat(spp)
    px0 = (lane_pid % w).to(torch.float32)
    py0 = (lane_pid // w).to(torch.float32)
    params = {n: params0[n].detach().to(dev).clone() for n in names}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    b1, b2 = oracle.ADAM_BETAS
    losses, first = [], None
    for t, key in enumerate(keys, 1):
        key = key.to(dev)
        seed = krng.randint(key, 0, 2**31 - 1)
        u = krng.uniform(key, (spp * npix, 2))
        o, d = kscene.generate_rays(
            cam, torch.stack([px0 + u[:, 0], py0 + u[:, 1]], -1))
        tables = diff_tables(scene, cfg, params, extracted)
        big_l, caches = trace(tables, cfg, o, d, seed, tally,
                              keep_cache=True)
        lanes = big_l.clone().requires_grad_()
        loss = oracle.relmse(lanes.reshape(spp, npix, 3).mean(dim=0).reshape(
            h, w, 3), target)
        loss.backward()
        g = lanes.grad
        grads = None
        for j, (resf, resi) in enumerate(caches):
            sl = slice(j * oracle.BLOCK, (j + 1) * oracle.BLOCK)
            part = bs.bwd_res_plain(tables, cfg, g[sl].contiguous(),
                                    big_l[sl], resf, resi)[:4]
            grads = part if grads is None else tuple(
                a + b for a, b in zip(grads, part))
        del caches
        grads = {n: grads[GRAD_OF[n]] for n in names}
        losses.append(float(loss.detach()))
        if first is None:
            first = {n: gr.clone() for n, gr in grads.items()}
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        for n in names:
            m[n] = b1 * m[n] + (1 - b1) * grads[n]
            v[n] = b2 * v[n] + (1 - b2) * grads[n] * grads[n]
            denom = v[n].sqrt() / math.sqrt(bc2) + oracle.ADAM_EPS
            params[n] = torch.clamp_min(params[n] - (lr / bc1) * m[n] / denom,
                                        0.0)
    return losses, first, params


def perturbed(scene, seed: int, spread: dict) -> dict:
    """The tables named in `spread` (a name: [lo, hi]) of `scene`, scaled
    entry by entry by factors uniform in [lo, hi] drawn from the seed in
    the order of `spread` (a CPU generator, so every device draws the same
    factors)."""
    gen = torch.Generator().manual_seed(seed & (2**63 - 1))
    out = {}
    for n, (lo, hi) in spread.items():
        base = getattr(scene, n).detach().cpu()
        f = lo + (hi - lo) * torch.rand(base.shape, generator=gen)
        out[n] = (base * f).to(torch.float32)
    return out
