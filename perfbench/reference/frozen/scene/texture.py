# Frozen copy of kytpu_torch/scene/texture.py at commit 35fb5ad, imports
# rewritten to this package: the benchmark's plain reference.
"""UV-mapped textures: a procedural checkerboard and bilinear image lookup
(kytpu/scene/texture.py, its numpy and torch parts).

All texture state is two dense tables: a (T,) parameter table and one
stacked (Ti, H, W, 3) image atlas, every image at one resolution. Bilinear
filtering is linear in the texels and the checker colours are the cells'
values, so both are trainable leaves of inverse rendering (diff/params.py).

UV conventions (kytpu's shapes.surface_uv): a rectangle's u runs along
p0 - p1 and v along p2 - p1, a triangle's (u, v) are its barycentrics
(b1, b2) over (p0, p1, p2), a disk's are its frame coordinates mapped to
[0, 1]^2, a sphere's are u = phi / 2 pi and v = theta / pi (z up).
Addressing wraps: uv is scaled by the texture's tiling, then its fraction
is taken. The kernels evaluate textures on planar surfaces only, and image
textures of at most 65,536 texels (kernels/wavefront.py
`kernel_texture_support`); the jnp engines evaluate any.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from perfbench.reference.frozen.core import math as km

CHECKER = 0
IMAGE = 1


@dataclass(frozen=True)
class Textures:
    """All scene textures as dense tables. Rows of kind CHECKER use
    (color_a, color_b); rows of kind IMAGE use image[image_index]."""

    kind: torch.Tensor         # (T,) int32 in {CHECKER, IMAGE}
    color_a: torch.Tensor      # (T, 3) the checker's "even" colour
    color_b: torch.Tensor      # (T, 3) the checker's "odd" colour
    scale: torch.Tensor        # (T, 2) uv tiling factors
    image_index: torch.Tensor  # (T,) int32 row of `image`; -1 procedural
    image: torch.Tensor        # (Ti, H, W, 3) float32 texel atlas

    @property
    def n_textures(self) -> int:
        return self.kind.shape[0]

    def to(self, device) -> "Textures":
        return replace(self, **{k: getattr(self, k).to(device) for k in (
            "kind", "color_a", "color_b", "scale", "image_index", "image")})


def empty() -> Textures:
    return Textures(kind=torch.zeros((0,), dtype=torch.int32),
                    color_a=torch.zeros((0, 3)), color_b=torch.zeros((0, 3)),
                    scale=torch.ones((0, 2)),
                    image_index=torch.full((0,), -1, dtype=torch.int32),
                    image=torch.zeros((0, 1, 1, 3)))


def _f32(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(v, np.float32))


def build(entries: list[dict]) -> Textures:
    """Freeze texture dicts (from the builders) into tables. Each entry:
    {"kind": CHECKER | IMAGE, "color_a", "color_b", "scale", "image": an
    (H, W, 3) array or None}; every image shares one resolution."""
    if not entries:
        return empty()
    imgs = [_f32(e["image"]) for e in entries if e.get("image") is not None]
    for im in imgs:
        if im.shape != imgs[0].shape:
            raise ValueError(f"all image textures must share one resolution; "
                             f"got {tuple(im.shape)} vs "
                             f"{tuple(imgs[0].shape)}")
    atlas = torch.stack(imgs) if imgs else torch.zeros((0, 1, 1, 3))
    img_idx, k = [], 0
    for e in entries:
        img_idx.append(k if e.get("image") is not None else -1)
        k += e.get("image") is not None
    z3 = np.zeros(3, np.float32)
    return Textures(
        kind=torch.tensor([e["kind"] for e in entries], dtype=torch.int32),
        color_a=torch.stack([_f32(e.get("color_a", z3)) for e in entries]),
        color_b=torch.stack([_f32(e.get("color_b", z3)) for e in entries]),
        scale=torch.from_numpy(np.array([e.get("scale", (1.0, 1.0))
                                         for e in entries], np.float32)),
        image_index=torch.tensor(img_idx, dtype=torch.int32),
        image=atlas)


def _bilinear(atlas, img_idx, st):
    """Wrap-addressed bilinear fetch: atlas (Ti, H, W, 3), img_idx (N,)
    valid rows, st (N, 2) in tile space (already scaled) -> (N, 3). The
    texel-centre convention: uv 0.5 / W hits texel 0's centre."""
    h, w = atlas.shape[1], atlas.shape[2]
    frac = st - torch.floor(st)
    x = frac[:, 0] * w - 0.5
    y = frac[:, 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    xi0 = torch.remainder(x0.long(), w)
    yi0 = torch.remainder(y0.long(), h)
    xi1, yi1 = torch.remainder(xi0 + 1, w), torch.remainder(yi0 + 1, h)
    flat = atlas.reshape(-1, 3)
    base = img_idx.long() * h

    def texel(yi, xi):
        return km.gather(flat, (base + yi) * w + xi)

    top = texel(yi0, xi0) * (1.0 - fx) + texel(yi0, xi1) * fx
    bot = texel(yi1, xi0) * (1.0 - fx) + texel(yi1, xi1) * fx
    return top * (1.0 - fy) + bot * fy


def eval_texture(tex: Textures, tid, uv):
    """The textures `tid` (N,) (valid rows) at uv (N, 2) -> (N, 3): the jnp
    engines' lookup, and the plain reference of the kernels' (any shape,
    spheres included, and any atlas size)."""
    tid = tid.long()
    st = uv * tex.scale[tid]
    ij = torch.floor(st).to(torch.int32)
    even = ((ij[:, 0] + ij[:, 1]) & 1) == 0
    out = torch.where(even[:, None], km.gather(tex.color_a, tid),
                      km.gather(tex.color_b, tid))
    if tex.image.shape[0]:
        img_idx = tex.image_index[tid].clamp(0, tex.image.shape[0] - 1)
        img = _bilinear(tex.image, img_idx, st)
        out = torch.where((tex.kind[tid] == IMAGE)[:, None], img, out)
    return out
