"""The scene records that csrc/megakernel.cuh reads for both kernel
families, K1-K4 (kernels/wavefront.py) and K5-K8 (kernels/bigscene.py):
the colour, texture and NEE light-emission tables of a call, and the host
values they are cut from.
"""

from __future__ import annotations

import numpy as np
import torch

from kytpu_torch.light import lights as klights
from kytpu_torch.scene import scene as kscene


def f32(x) -> float:
    """x rounded to float32, as a python float."""
    return float(np.float32(x))


def n_tex(static) -> int:
    """The textures whose checker adjoints K3 and K4 keep: all of a
    textured scene's, none of another's."""
    return static["n_textures"] if static["textures"] else 0


def has_img(static) -> bool:
    """Whether a row of the scene reads an image texture."""
    return static["n_images"] > 0


def light_rows(static) -> dict:
    """light index -> its first emitting surface row."""
    light_row = {}
    for m, li in enumerate(static["mats"]["light_index"]):
        if li >= 0 and li not in light_row:
            light_row[li] = m
    return light_row


def color_tables(scene: kscene.Scene) -> dict:
    """The colour, exponent and light tables a launch reads, from the
    scene's own values."""
    dev = scene.device
    f32 = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()  # noqa
    emit = (scene.lights.emit if scene.n_lights
            else torch.zeros((1, 3), device=dev))
    env = (scene.env_radiance_ if scene.has_env
           else torch.zeros(3, device=dev))
    return dict(diffuse=f32(scene.mat_diffuse),
                specular=f32(scene.mat_specular),
                emission=f32(scene.emission),
                exponent=f32(scene.mat_exponent), light_emit=f32(emit),
                env=f32(env).reshape(3))


def texture_tables(scene: kscene.Scene, texa=None, texb=None,
                   timg=None) -> dict:
    """The texture tables a launch reads (`SceneTables` texa, texb, timg),
    from the scene's textures or the given leaves; one zero row each where
    the scene has none, so every pointer is valid."""
    tx = scene.textures if scene.has_textures else None
    dev = scene.device

    def tab(v, name):
        if v is None and tx is not None:
            v = getattr(tx, name)
        if v is None or not v.numel():
            return torch.zeros((1, 3), dtype=torch.float32, device=dev)
        return v.detach().to(device=dev, dtype=torch.float32).reshape(
            -1, 3).contiguous()

    return dict(texa=tab(texa, "color_a"), texb=tab(texb, "color_b"),
                timg=tab(timg, "image"))


def light_emit_of(scene: kscene.Scene, emission: torch.Tensor,
                  env: torch.Tensor) -> torch.Tensor:
    """(max(L, 1), 3) NEE light emissions derived from the traced
    `emission` rows and `env` (kytpu's `_light_emit_of`): a light bound to
    a surface takes that row's emission, the environment light `env`, the
    others `scene.lights.emit`. The diff tracer reads these, not
    `lights.emit`, so a train step never runs NEE with stale emission."""
    if not scene.n_lights:
        return emission.new_zeros((1, 3))
    rows = scene.lights.surface_ids
    idx = torch.tensor([max(r, 0) for r in rows], device=emission.device)
    has = torch.tensor([r >= 0 for r in rows], device=emission.device)
    emit = torch.where(has[:, None], emission[idx],
                       scene.lights.emit.to(emission.device))
    for i, kind in enumerate(scene.lights.kinds):
        if kind == klights.ENV:
            emit = emit.clone()
            emit[i] = env
    return emit
