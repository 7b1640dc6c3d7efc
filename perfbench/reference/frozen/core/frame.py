# Frozen copy of kytpu_torch/core/frame.py at commit 35fb5ad, imports
# rewritten to this package: the benchmark's plain reference.
"""Orthonormal shading frames, batched (kytpu/core/frame.py).

A frame is three (N, 3) tensors (s, t, n); the world <-> local transforms
are dot products, with no per-hit objects.
"""

from __future__ import annotations

import torch

from perfbench.reference.frozen.core import math as km


def make_frame(n: torch.Tensor):
    """(s, t, n) from normals n (..., 3), the SmallVCM recipe: the helper
    axis is (0,1,0) where |n.x| > 0.99, else (1,0,0); t = normalize(n x
    helper), s = normalize(t x n)."""
    n = km.normalize(n)
    use_y = (torch.abs(n[..., 0]) > 0.99)[..., None]
    helper = torch.where(use_y, n.new_tensor([0.0, 1.0, 0.0]),
                         n.new_tensor([1.0, 0.0, 0.0]))
    t = km.normalize(km.cross(n, helper))
    s = km.normalize(km.cross(t, n))
    return s, t, n


def to_local(s, t, n, w_world: torch.Tensor) -> torch.Tensor:
    return torch.stack([km.dot(s, w_world), km.dot(t, w_world),
                        km.dot(n, w_world)], dim=-1)


def to_world(s, t, n, w_local: torch.Tensor) -> torch.Tensor:
    return (w_local[..., 0:1] * s + w_local[..., 1:2] * t
            + w_local[..., 2:3] * n)
