"""Frame rendering entry point (kytpu/integrator/render.py).

`render(scene, engine="cuda")` is the counterpart of kytpu's
`render(scene, engine="pallas")`: the forward megakernel K1 on the card, its
plain PyTorch version with device="cpu", under any of the three samplers
(`KernelConfig.sampler`). Past 64 surfaces it runs the table-driven
big-scene kernel K5 (kernels/bigscene.py) where its tables take the scene,
and K1 where they do not (a rect that is not a parallelogram, an atlas
past their select chain), as kytpu routes between its two kernels;
`engine="bigscene"` runs K5 at any size and raises, with kytpu's reason,
for what its tables do not take. The jnp engines are not ported yet;
asking for them raises and names the ROADMAP item.
"""

from __future__ import annotations

import torch

from kytpu_torch.kernels import bigscene as kbs
from kytpu_torch.kernels import wavefront as kwf


def render(scene, spp: int = 16, seed: int = 1234,
           cfg: kwf.KernelConfig | None = None,
           clamp: bool = True, rays_per_pass: int = 1 << 20,
           engine: str = "cuda", device="cuda") -> torch.Tensor:
    """Render a full frame -> (H, W, 3) float32 on `device`: the card by
    default, the CPU (the kernels' plain versions) only with device="cpu".
    Asking for "cuda" where torch sees no card raises. `cfg` defaults to
    KernelConfig(), what kytpu's render(engine="pallas") runs by default.
    `clamp` reproduces the reference's per-pixel clamp01-of-the-mean
    (ky.cpp:3726); disable it for HDR output. engine="cuda" runs K1, or K5
    past 64 surfaces where the big-scene tables take the scene;
    engine="bigscene" runs K5. Both split the frame into passes of
    `rays_per_pass` lanes, whose seeds the "random" sampler depends on."""
    if engine in ("jnp", "fast", "path"):
        raise NotImplementedError(
            f"engine={engine!r}: the jnp engines are ROADMAP item M7 of "
            "the port")
    if engine not in ("cuda", "bigscene"):
        raise ValueError(f"unknown engine {engine!r}: expected 'cuda' or "
                         "'bigscene'")
    cfg = cfg or kwf.KernelConfig()
    kwf.check_config(cfg)
    # kytpu's rule: past 64 surfaces the table kernel where its tables take
    # the scene, else the baked one (K1)
    extracted = kbs.table_route(scene) if engine == "cuda" else None
    if extracted is not None:
        engine = "bigscene"
    scene = scene.to(check_device(device))
    if engine == "bigscene":
        return kbs.render_bigscene(scene, spp=spp, seed=seed, cfg=cfg,
                                   clamp=clamp, rays_per_pass=rays_per_pass,
                                   extracted=extracted)
    return kwf.render_cuda(scene, spp=spp, seed=seed, cfg=cfg, clamp=clamp,
                           rays_per_pass=rays_per_pass)


def check_device(device) -> torch.device:
    """torch.device(device); raises for "cuda" when torch sees no card (the
    port's entry points never fall back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} asked for, but torch sees "
                           "no CUDA device (pass device='cpu' for the plain "
                           "version on the CPU)")
    return device
