"""Frame rendering entry point (kytpu/integrator/render.py).

`render(scene, engine="cuda")` is the counterpart of kytpu's
`render(scene, engine="pallas")`: the forward megakernel on CUDA tensors,
its plain PyTorch version on CPU tensors. The jnp engines, the big-scene
kernels and the other samplers are not ported yet; asking for them raises
and names the ROADMAP item, it never re-routes.
"""

from __future__ import annotations

import torch

from kytpu_torch.kernels import wavefront as kwf


def render(scene, spp: int = 16, seed: int = 1234,
           cfg: kwf.KernelConfig | None = None,
           clamp: bool = True, rays_per_pass: int = 1 << 20,
           engine: str = "cuda", device=None) -> torch.Tensor:
    """Render a full frame -> (H, W, 3) float32 on `device` (default: the
    scene's device). `cfg` defaults to KernelConfig(), what kytpu's
    render(engine="pallas") runs by default. `clamp` reproduces the
    reference's per-pixel clamp01-of-the-mean (ky.cpp:3726); disable it for
    HDR output."""
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
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' asked for, but torch sees no "
                               "CUDA device")
        scene = scene.to(device)
    return kwf.render_cuda(scene, spp=spp, seed=seed, cfg=cfg, clamp=clamp,
                           rays_per_pass=rays_per_pass)
