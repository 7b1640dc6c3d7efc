"""Frame rendering (kytpu/integrator/render.py): camera samples, passes of
lanes, film assembly.

Two families of engines:
  - engine="cuda" (the port's default) runs the forward megakernel K1, or
    past 64 surfaces the table-driven big-scene kernel K5
    (kernels/bigscene.py) where its tables take the scene, as kytpu routes
    its engine="pallas"; engine="bigscene" runs K5 at any size and raises,
    with kytpu's reason, for what its tables do not take. Both run under
    any of the three kernel samplers (`KernelConfig.sampler`), and always
    the production transport.
  - engine="jnp" (kytpu's default; "fast" and "path" are its aliases)
    runs the torch engines of integrator/path.py and integrator/fast.py:
    mode "path" (the wavefront path tracer, every variant and NEE
    strategy), "fast" (the production one-sample MIS engine, which a
    FastConfig also selects), "direct" (emission and NEE) or "aov"
    (position, normal or basecolor). They render every scene, sphere-UV
    textures and image textures past the kernels' cap included.

A PathConfig or FastConfig given to a kernel engine maps to the
KernelConfig kytpu maps it to. Every lane is a (pixel, sample) pair; a
frame is cut into passes of `rays_per_pass` lanes and the film sums each
pixel's samples in sample order, so a lane's radiance and a pixel's sum do
not depend on the pass split (a region reproduces its crop of the frame to
the bit).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kytpu_torch.core import math as km
from kytpu_torch.core import rng as krng
from kytpu_torch.core.device import check_device
from kytpu_torch.integrator import fast as kfast
from kytpu_torch.integrator import path as kpath
from kytpu_torch.kernels import route as kroute
from kytpu_torch.kernels import wavefront as kwf
from kytpu_torch.scene import scene as kscene
from kytpu_torch.utils import profiling as kprof

JNP_ENGINES = ("jnp", "fast", "path")
KERNEL_ENGINES = kroute.ENGINES
MODES = ("path", "fast", "direct", "aov")


def trace_lanes(scene, key, px, py, pixel_ids, sample_ids, cfg, mode, aov):
    """One pass of the jnp engines: (n,) lanes of (pixel, sample) pairs ->
    (n, 3). A lane's draws depend on (key, pixel id, sample id) alone:
    its key is fold_in(fold_in(key, sample), pixel), or under sobol
    fold_in(key, pixel) with the sample id as the Sobol point index."""
    if cfg.sampler == "sobol":
        keys = krng.fold_in(key, pixel_ids)
        index = sample_ids
    else:
        keys = krng.fold_in(krng.fold_in(key, sample_ids), pixel_ids)
        index = None
    k_cam, k_path = krng.split_channels(keys, 2)
    u = krng.uniform2(k_cam, cfg.sampler, index)
    if cfg.filter == "tent":
        # smallpt's 2x2-subpixel tent filter (smallpt.cpp:107-118): samples
        # cycle the 4 subpixels, dx = sqrt(2u) - 1 | 1 - sqrt(2 - 2u) spreads
        # each over (-1, 1) about its centre
        r1 = 2.0 * u[:, 0]
        r2 = 2.0 * u[:, 1]

        def tent(r):
            return torch.where(r < 1.0, km.sqrt(r) - 1.0,
                               1.0 - km.sqrt(torch.clamp_min(2.0 - r, 0.0)))

        sub = sample_ids % 4
        u = torch.stack([((sub % 2).float() + 0.5 + tent(r1)) * 0.5,
                         ((sub // 2).float() + 0.5 + tent(r2)) * 0.5], -1)
    elif getattr(cfg, "strata", None) and cfg.sampler == "stratified":
        # jittered camera strata over the sample index (ky.cpp:978-985);
        # kytpu's jitted x / a is x * float32(1 / a)
        a, b = cfg.strata
        s = sample_ids % (a * b)
        inv_a, inv_b = (float(np.float32(1 / n)) for n in (a, b))
        u = torch.stack([((s % a).float() + u[:, 0]) * inv_a,
                         ((s // a).float() + u[:, 1]) * inv_b], -1)
    o, d = kscene.generate_rays(scene.camera,
                                torch.stack([px + u[:, 0], py + u[:, 1]], -1))
    if mode == "aov":
        return kpath.li_aov(scene, o, d, k_path, aov)
    if mode == "direct":
        return kpath.li_direct_lighting(scene, o, d, k_path, cfg, index)
    if mode == "fast" or isinstance(cfg, kfast.FastConfig):
        return kfast.li_path_fast(scene, o, d, k_path, cfg, index)
    return kpath.li_path(scene, o, d, k_path, cfg, index)


def _render_mean(scene, spp, seed, cfg, mode, aov, rays_per_pass):
    """The (H, W, 3) mean of spp samples a pixel through trace_lanes: lanes
    are pixel ids tiled and sample ids repeated, in passes of at most
    rays_per_pass lanes; each pixel's samples are summed in sample order."""
    cam = scene.camera
    w, h = cam.width, cam.height
    npix = w * h
    dev = scene.device
    key = krng.root_key(seed, dev)
    k = max(1, min(spp, rays_per_pass // max(npix, 1)))
    pix_chunk = min(npix, rays_per_pass)
    accum = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
    for p0 in range(0, npix, pix_chunk):
        p1 = min(p0 + pix_chunk, npix)
        pc = p1 - p0
        pix = torch.arange(p0, p1, dtype=torch.int64, device=dev)
        for s0 in range(0, spp, k):
            kk = min(k, spp - s0)
            pid = pix.repeat(kk)
            sid = torch.arange(s0, s0 + kk, dtype=torch.int64,
                               device=dev).repeat_interleave(pc)
            out = trace_lanes(scene, key, (pid % w).float(),
                              (pid // w).float(), pid, sid, cfg, mode,
                              aov).reshape(kk, pc, 3)
            for s in range(kk):
                accum[p0:p1] += out[s]
    return km.div(accum, float(spp)).reshape(h, w, 3)


def _kernel_config(cfg):
    """The KernelConfig kytpu runs its kernels under for cfg."""
    if isinstance(cfg, kwf.KernelConfig):
        return cfg
    if cfg is None:
        return kwf.KernelConfig()
    return kwf.KernelConfig(
        max_depth=cfg.max_depth,
        sampler="sobol" if cfg.sampler == "sobol" else "random",
        shadow=cfg.shadow)


@kprof.spanned("kytpu::render.frame")
def render(scene, spp: int = 16, seed: int = 1234, cfg=None,
           clamp: bool = True, rays_per_pass: int = 1 << 20,
           engine: str = "cuda", device="cuda", mode: str = "path",
           aov: str | None = None) -> torch.Tensor:
    """Render a full frame -> (H, W, 3) float32 on `device`: the card by
    default, the CPU only with device="cpu" (the kernels' plain versions,
    or the jnp engines on CPU tensors). Asking for "cuda" where torch sees
    no card raises; nothing falls back to the CPU.

    engine="cuda" (the default) runs K1, or K5 past 64 surfaces where the
    big-scene tables take the scene, under `cfg` (KernelConfig() by
    default, what kytpu's render(engine="pallas") runs); engine="bigscene"
    runs K5. The kernels run the production transport: mode "path" and
    "fast" both take it, "direct" and "aov" need a jnp engine.
    engine="jnp" ("fast" and "path" are aliases) runs `mode` ("path",
    "fast", "direct" or "aov" with aov "position", "normal" or "basecolor")
    under cfg (PathConfig() by default; a FastConfig selects the fast
    engine). `clamp` reproduces the reference's per-pixel clamp01 of the
    mean (ky.cpp:3726); disable it for HDR output or differentiation.
    Frames are cut into passes of `rays_per_pass` lanes; under the kernels'
    "random" sampler the passes' seeds depend on it."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}: expected one of {MODES}")
    if engine in KERNEL_ENGINES:
        if mode not in ("path", "fast"):
            raise ValueError(f"mode={mode!r} needs engine='jnp': the kernels "
                             "run the production path transport alone")
        kcfg = _kernel_config(cfg)
        kwf.check_config(kcfg)
        return kroute.frame(scene, check_device(device), engine, spp=spp,
                            seed=seed, cfg=kcfg, clamp=clamp,
                            rays_per_pass=rays_per_pass)
    if engine not in JNP_ENGINES:
        raise ValueError(f"unknown engine {engine!r}: expected one of "
                         f"{KERNEL_ENGINES + JNP_ENGINES}")
    cfg = cfg or kpath.PathConfig()
    if isinstance(cfg, kwf.KernelConfig):
        raise ValueError("a KernelConfig runs engine='cuda' or 'bigscene'; "
                         "the jnp engines take a PathConfig or FastConfig")
    if cfg.sampler == "stratified" and cfg.strata == (1, 1):
        cfg = dataclasses.replace(cfg, strata=krng.stratum_grid(spp))
    scene = scene.to(check_device(device))
    img = _render_mean(scene, spp, seed, cfg, mode, aov, rays_per_pass)
    return torch.clamp(img, 0.0, 1.0) if clamp else img


def render_aov(scene, which: str, spp: int = 10, seed: int = 1234, **kw):
    """An AOV frame (li_aov) through the jnp engine."""
    kw.setdefault("engine", "jnp")
    return render(scene, spp=spp, seed=seed, mode="aov", aov=which, **kw)


def render_region(scene, x0: int, y0: int, x1: int, y1: int, spp: int = 16,
                  seed: int = 1234, cfg=None, mode: str = "path",
                  aov: str | None = None, clamp: bool = True,
                  device="cuda") -> torch.Tensor:
    """Re-render the film rectangle [x0, x1) x [y0, y1) through the jnp
    engines -> (y1 - y0, x1 - x0, 3), the pixel-bisection harness
    (integrator_t::debug_area, ky.cpp:3733-3771). Pixel ids and sample
    order are the full frame's, so the region equals the frame's crop at
    the same seed, to the bit."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}: expected one of {MODES}")
    cfg = cfg or kpath.PathConfig()
    scene = scene.to(check_device(device))
    dev = scene.device
    w = scene.camera.width
    ys, xs = torch.meshgrid(torch.arange(y0, y1, device=dev),
                            torch.arange(x0, x1, device=dev), indexing="ij")
    pid = (ys * w + xs).reshape(-1)
    px, py = xs.reshape(-1).float(), ys.reshape(-1).float()
    key = krng.root_key(seed, dev)
    accum = torch.zeros((pid.shape[0], 3), dtype=torch.float32, device=dev)
    for s in range(spp):
        accum += trace_lanes(scene, key, px, py, pid, torch.full_like(pid, s),
                             cfg, mode, aov)
    img = km.div(accum, float(spp)).reshape(y1 - y0, x1 - x0, 3)
    return torch.clamp(img, 0.0, 1.0) if clamp else img


def debug_area(scene, full_img, x0: int, y0: int, x1: int, y1: int, **kw):
    """A re-rendered region composited into full_img with a red border
    (ky.cpp:3747-3762) -> a numpy (H, W, 3) copy."""
    out = np.array(torch.as_tensor(full_img).cpu(), np.float32, copy=True)
    out[y0:y1, x0:x1] = render_region(scene, x0, y0, x1, y1,
                                      **kw).cpu().numpy()
    red = np.array([1.0, 0.0, 0.0], np.float32)
    out[y0, x0:x1] = red
    out[y1 - 1, x0:x1] = red
    out[y0:y1, x0] = red
    out[y0:y1, x1 - 1] = red
    return out


def debug_pixel(scene, x: int, y: int, **kw) -> torch.Tensor:
    """One pixel re-rendered (integrator_t::debug_pixel,
    ky.cpp:3773-3787) -> (3,)."""
    return render_region(scene, x, y, x + 1, y + 1, **kw)[0, 0]
