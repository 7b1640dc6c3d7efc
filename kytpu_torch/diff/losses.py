"""Image losses for inverse rendering (kytpu/diff/losses.py)."""

from __future__ import annotations

import torch


def mse(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((img - target) ** 2)


def relmse(img: torch.Tensor, target: torch.Tensor,
           eps: float = 1e-2) -> torch.Tensor:
    """Relative MSE, the standard inverse-rendering loss: normalised by the
    target intensity so bright emitters don't dominate albedo gradients."""
    return torch.mean((img - target) ** 2 / (target ** 2 + eps))


def l1(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(img - target))
