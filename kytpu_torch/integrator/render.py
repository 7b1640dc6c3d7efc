"""Frame rendering entry point (kytpu/integrator/render.py).

`render(scene, engine="cuda")` is the counterpart of kytpu's
`render(scene, engine="pallas")`: the forward megakernel on the card, its
plain PyTorch version with device="cpu". The jnp engines, the big-scene
kernels and the other samplers are not ported yet; asking for them raises
and names the ROADMAP item, it never re-routes.
"""

from __future__ import annotations

import torch

from kytpu_torch.kernels import wavefront as kwf


def render(scene, spp: int = 16, seed: int = 1234,
           cfg: kwf.KernelConfig | None = None,
           clamp: bool = True, rays_per_pass: int = 1 << 20,
           engine: str = "cuda", device="cuda") -> torch.Tensor:
    """Render a full frame -> (H, W, 3) float32 on `device`: the card by
    default, the CPU (the kernel's plain version) only with device="cpu".
    Asking for "cuda" where torch sees no card raises. `cfg` defaults to
    KernelConfig(), what kytpu's render(engine="pallas") runs by default.
    `clamp` reproduces the reference's per-pixel clamp01-of-the-mean
    (ky.cpp:3726); disable it for HDR output."""
    if engine in ("jnp", "fast", "path"):
        raise NotImplementedError(
            f"engine={engine!r}: the jnp engines are ROADMAP item M7 of "
            "the port")
    if engine == "bigscene":
        raise NotImplementedError(
            "engine='bigscene': the table-driven kernels are ROADMAP item M8")
    if engine != "cuda":
        raise ValueError(f"unknown engine {engine!r}: expected 'cuda'")
    if int(scene.mat_kind.shape[0]) > kwf.MAX_SURFACES:
        raise NotImplementedError(
            f"{int(scene.mat_kind.shape[0])} surfaces: scenes past "
            f"{kwf.MAX_SURFACES} surfaces need the big-scene kernels, "
            "ROADMAP item M8")
    kwf.check_config(cfg or kwf.KernelConfig())
    scene = scene.to(check_device(device))
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
