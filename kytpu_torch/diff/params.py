"""Trainable-parameter views of a Scene (kytpu/diff/params.py).

The differentiable leaves are the material colour tables, the surface
emission, the environment radiance and the Phong exponents. `get_params` reads them as a dict of
tensors and `set_params` writes them back, keeping the two places area-light
radiance lives (the per-surface `emission` table read at hit time and the
light table `lights.emit` read by NEE) consistent from the single
"emission" parameter.
"""

from __future__ import annotations

import dataclasses

import torch

from kytpu_torch.scene.scene import Scene

TRAINABLE = ("mat_diffuse", "mat_specular", "emission")
# opt-in: "env_radiance_" (environment scenes) and "mat_exponent", whose
# adjoint the kernels give under KernelConfig(trainable_exponent=True): K2
# caches it in the "Bk"/"tuk" planes for K3, and K4 accumulates it while it
# replays a path. The texture leaves come with textures (ROADMAP M9).
_TEXTURE_LEAVES = ("tex_color_a", "tex_color_b", "tex_image")

_SOFTPLUS_FLOOR = 1e-6   # zero-emission rows map to a finite theta (~-13.8)


def _check_names(names) -> None:
    for n in names:
        if n in _TEXTURE_LEAVES:
            raise NotImplementedError(
                f"{n}: texture parameters are ROADMAP item M9 (textures) of "
                "the port")


def make_codec(param_spaces: dict | None):
    """(encode, decode) maps between natural parameter space and the
    optimisation space. `param_spaces` maps a parameter name to "linear"
    (identity, the default) or "log" (softplus: p = log(1 + e^theta)), which
    makes a shared Adam step multiplicative for emission (O(25)) and albedo
    (O(1)) alike; rows at exactly 0 map to theta = softplus^-1(1e-6)."""
    spaces = param_spaces or {}
    for name, space in spaces.items():
        if space not in ("linear", "log"):
            raise ValueError(f"{name}: unknown parameter space {space!r}")

    def encode_one(name: str, p: torch.Tensor) -> torch.Tensor:
        if spaces.get(name) == "log":
            q = torch.clamp_min(p, _SOFTPLUS_FLOOR)
            # softplus^-1(q) = log(expm1(q)), stable form
            return torch.where(q > 20.0, q, torch.log(torch.expm1(q)))
        return p

    def decode_one(name: str, th: torch.Tensor) -> torch.Tensor:
        if spaces.get(name) == "log":
            return torch.logaddexp(th, torch.zeros_like(th))
        return th

    def encode(params: dict) -> dict:
        return {n: encode_one(n, p) for n, p in params.items()}

    def decode(theta: dict) -> dict:
        return {n: decode_one(n, t) for n, t in theta.items()}

    return encode, decode


def get_params(scene: Scene, names=TRAINABLE) -> dict:
    _check_names(names)
    return {n: getattr(scene, n) for n in names}


def set_params(scene: Scene, params: dict) -> Scene:
    _check_names(params)
    updates = dict(params)
    if "emission" in updates:
        em = updates["emission"]
        lights = scene.lights
        if lights.kinds:
            sids = torch.tensor([max(s, 0) for s in lights.surface_ids],
                                device=em.device)
            has = torch.tensor([s >= 0 for s in lights.surface_ids],
                               device=em.device)[:, None]
            updates["lights"] = dataclasses.replace(
                lights, emit=torch.where(has, em[sids],
                                         lights.emit.to(em.device)))
    return dataclasses.replace(scene, **updates)
