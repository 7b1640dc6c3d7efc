"""Runtime validity checks (kytpu/utils/checks.py): the reference's
CHECK/LOG_VAST (ky.cpp:61-126, 3719, 4593), radiance finiteness and sample
validity, as opt-in assertions, so production renders pay nothing.

Enable with KYTPU_DEBUG=1 (environment) or checks.enable(True). In a
render, `checked(x, "name")` counts x's non-finite elements when enabled
(one host sync); on a finished image `validate_radiance` checks it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from kytpu_torch.film.film import to_numpy

_ENABLED = bool(int(os.environ.get("KYTPU_DEBUG", "0")))


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


def enabled() -> bool:
    return _ENABLED


def checked(x: torch.Tensor, name: str = "value") -> torch.Tensor:
    """x, after a finiteness check when debug is enabled (the reference's
    CHECK_DEBUG(Li.is_valid()), ky.cpp:3719): raises FloatingPointError
    with the count of non-finite elements."""
    if not _ENABLED:
        return x
    bad = int(x.numel() - torch.isfinite(x).sum())
    if bad:
        raise FloatingPointError(f"kytpu check failed: {name} has {bad} "
                                 f"non-finite elements")
    return x


def validate_radiance(img, name: str = "radiance") -> None:
    """Host-side postcondition of an image (array or tensor): finite and
    non-negative."""
    a = to_numpy(img)
    n_nan = int(np.isnan(a).sum())
    n_inf = int(np.isinf(a).sum())
    n_neg = int((a < 0).sum())
    if n_nan or n_inf:
        raise FloatingPointError(
            f"{name}: {n_nan} NaN, {n_inf} inf values")
    if n_neg:
        raise ValueError(f"{name}: {n_neg} negative values")
