"""The device an entry point runs on."""

from __future__ import annotations

import torch


def check_device(device) -> torch.device:
    """torch.device(device); raises for "cuda" when torch sees no card (the
    port's entry points never fall back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} asked for, but torch sees "
                           "no CUDA device (pass device='cpu' for the plain "
                           "version on the CPU)")
    return device
