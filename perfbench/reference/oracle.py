"""The plain reference of the benchmark's cells: frames and train steps
rebuilt from the configuration, the seed and the sampler draws, on the
frozen copies of the port's plain versions (reference/frozen). It imports
nothing of the port and takes nothing the port made: the scene, the
tables, the camera jitter, the kernel seeds and the optimizer are worked
out here again.

Lanes are traced in blocks of BLOCK, a multiple of every tile (rows * 128
lanes), so a block traces with the seed its first tile would give and each
lane keeps the draws it has in one launch.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from perfbench.counts.transport import Tally
from perfbench.reference.frozen.core import math as km
from perfbench.reference.frozen.core import rng as krng
from perfbench.reference.frozen.kernels import wavefront as wf
from perfbench.reference.frozen.scene import builders
from perfbench.reference.frozen.scene import scene as kscene

BLOCK = 1 << 20
_M32 = 0xFFFFFFFF
_TILE_MUL = 2654435761 & 0x7FFFFFFF   # the tile seed's multiplier
TRAINABLE = ("mat_diffuse", "mat_specular", "emission")
ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


def build_scene(config: dict, device) -> kscene.Scene:
    """The configuration's scene at its stated size."""
    return getattr(builders, config["scene"])(**config["args"]).to(device)


def kernel_config(config: dict, traffic: dict) -> wf.KernelConfig:
    """The transport the configuration guarantees, to the mix's depth."""
    return wf.KernelConfig(max_depth=traffic["max_depth"],
                           **config["transport"])


def root_key(seed: int, device=None) -> torch.Tensor:
    """A threefry key of the whole seed: its low 32 bits, then the rest
    folded in."""
    return krng.fold_in(krng.key(seed & _M32, device), seed >> 32)


def trace(tables, cfg, o, d, seed: int, tally: Tally | None = None,
          keep_cache: bool = False):
    """The plain K2 over all lanes in blocks -> (radiance (N, 3), [the
    blocks' (resf, resi)] if keep_cache). Under the "random" sampler lane n
    sits in tile n // tile with seed + tile * _TILE_MUL, so block b0 traces
    with seed + (b0 // tile) * _TILE_MUL."""
    if cfg.sampler != "random":
        raise NotImplementedError("the reference rebuilds the 'random' "
                                  "sampler's lanes alone")
    tile = cfg.rows * wf.LANE
    if BLOCK % tile:
        raise ValueError(f"a block of {BLOCK} lanes splits a tile of {tile}")
    out, caches = [], []
    for b0 in range(0, o.shape[0], BLOCK):
        s = (seed + (b0 // tile) * _TILE_MUL) & _M32
        big_l, resf, resi = wf.trace_lanes_plain(
            tables, cfg, o[b0:b0 + BLOCK], d[b0:b0 + BLOCK], s, residual=True)
        if tally is not None:
            tally.add(tables.static, cfg, resf)
        out.append(big_l)
        if keep_cache:
            caches.append((resf, resi))
    return torch.cat(out), caches


def render_frame(scene, cfg, spp: int, seed: int, rays_per_pass: int,
                 clamp: bool = True, tally: Tally | None = None):
    """A frame as the port's render(engine="cuda") lays it out under the
    "random" sampler: passes of k = min(spp, rays_per_pass // npix) samples
    of every pixel until spp are taken; pass p jitters the camera with
    uniform(fold_in(key(seed), p), (k * npix, 2)) and traces with seed +
    7919 p (as an int32); the film sums each pass's samples, divides by
    the samples traced and clamps to [0, 1]."""
    cam = scene.camera
    w, h = cam.width, cam.height
    npix = w * h
    dev = scene.device
    tables = wf.pack_tables(scene, cfg)
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
        s = (seed + 7919 * p) & _M32
        s = s - (1 << 32) if s >= 1 << 31 else s
        out, _ = trace(tables, cfg, o, d, s, tally)
        accum = accum + out.reshape(k, npix, 3).sum(dim=0)
        s0 += k
        p += 1
    img = km.div(accum, float(p * k)).reshape(h, w, 3)
    return torch.clamp(img, 0.0, 1.0) if clamp else img


def relmse(img, target, eps: float = 1e-2):
    """Relative MSE of an image against its target."""
    return torch.mean((img - target) ** 2 / (target ** 2 + eps))


def diff_tables(scene, cfg, params: dict):
    """The tables a train step traces: the scene's geometry with these
    colour tables, each light bound to a surface taking that row's emission
    (the environment light the scene's radiance)."""
    dev = scene.device
    env = (scene.env_radiance_ if scene.has_env
           else torch.zeros(3, device=dev))
    geo = wf.pack_tables(scene, cfg)
    em = params["emission"].to(dev, torch.float32).contiguous()
    return dataclasses.replace(
        geo, diffuse=params["mat_diffuse"].to(dev, torch.float32).contiguous(),
        specular=params["mat_specular"].to(dev, torch.float32).contiguous(),
        emission=em, env=env.to(torch.float32).reshape(3),
        light_emit=wf.light_emit_of(scene, em, env).contiguous())


def train_steps(scene, cfg, target, params0: dict, keys, spp: int,
                lr: float, tally: Tally | None = None):
    """Steps of the relmse train step from params0 with Adam(lr), one per
    key -> (losses, the first step's gradients, the parameters after the
    last step). A step draws the kernel seed randint(key, 0, 2**31 - 1)
    and the jitter uniform(key, (spp * npix, 2)) of lanes (sample s, pixel
    q) = lane s * npix + q, traces them (the plain K2), takes relmse of the
    mean image, its gradient through the plain K3 block by block, one Adam
    step and the clamp to >= 0."""
    cam = scene.camera
    w, h = cam.width, cam.height
    npix = w * h
    dev = scene.device
    lane_pid = torch.arange(npix, device=dev).repeat(spp)
    px0 = (lane_pid % w).to(torch.float32)
    py0 = (lane_pid // w).to(torch.float32)
    params = {n: params0[n].detach().to(dev).clone() for n in TRAINABLE}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    b1, b2 = ADAM_BETAS
    losses, first = [], None
    for t, key in enumerate(keys, 1):
        key = key.to(dev)
        seed = krng.randint(key, 0, 2**31 - 1)
        u = krng.uniform(key, (spp * npix, 2))
        o, d = kscene.generate_rays(
            cam, torch.stack([px0 + u[:, 0], py0 + u[:, 1]], -1))
        tables = diff_tables(scene, cfg, params)
        big_l, caches = trace(tables, cfg, o, d, seed, tally,
                              keep_cache=True)
        lanes = big_l.clone().requires_grad_()
        loss = relmse(lanes.reshape(spp, npix, 3).mean(dim=0).reshape(
            h, w, 3), target)
        loss.backward()
        g = lanes.grad
        grads = None
        for j, (resf, resi) in enumerate(caches):
            sl = slice(j * BLOCK, (j + 1) * BLOCK)
            part = wf.bwd_res_plain(tables, cfg, g[sl].contiguous(),
                                    big_l[sl], resf, resi)[:3]
            grads = part if grads is None else tuple(
                a + b for a, b in zip(grads, part))
        del caches
        grads = dict(zip(TRAINABLE, grads))
        losses.append(float(loss.detach()))
        if first is None:
            first = {n: gr.clone() for n, gr in grads.items()}
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        for n in TRAINABLE:
            m[n] = b1 * m[n] + (1 - b1) * grads[n]
            v[n] = b2 * v[n] + (1 - b2) * grads[n] * grads[n]
            denom = v[n].sqrt() / math.sqrt(bc2) + ADAM_EPS
            params[n] = torch.clamp_min(params[n] - (lr / bc1) * m[n] / denom,
                                        0.0)
    return losses, first, params


def perturbed(scene, seed: int, spread: dict) -> dict:
    """The trainable tables of `scene` scaled entry by entry by factors
    drawn from the seed, uniform in spread[name] = [lo, hi]; a CPU
    generator, so every device draws the same factors."""
    gen = torch.Generator().manual_seed(seed & (2**63 - 1))
    out = {}
    for n in TRAINABLE:
        base = getattr(scene, n).detach().cpu()
        lo, hi = spread[n]
        f = lo + (hi - lo) * torch.rand(base.shape, generator=gen)
        out[n] = (base * f).to(torch.float32)
    return out


def frame_seed(seed: int, i: int) -> int:
    """The render seed of frame i of a run: 30 bits of threefry of (seed,
    i), so seed + 7919 p stays an int32."""
    return int(krng.bits(krng.fold_in(root_key(seed), i), 1)[0]) >> 2


def step_key(seed: int, i: int) -> torch.Tensor:
    """The key of train step i of a run."""
    return krng.fold_in(root_key(seed), i)
