"""The numbers that decide `correct`: what the timed path produced against
the plain reference, each read as a gap that its limit bounds from above.

Train steps (the first three, which set-up drives through the window's own
call): `loss_gap`, the worst relative gap of a step's loss; `grad_gap`,
of the first step's gradient as the optimizer got it; `change_gap`, of the
parameters' change over the three steps. The last two compare each leaf's
norm with the reference's (the gap of the norms, not the norm of the
gap), over the larger of that leaf's reference norm and the median
leaf's; a leaf whose reference gradient is under a thousandth of the
median leaf's moves by round-off alone and is left out of `change_gap`.

Frames: `pixel_gap_share`, the largest share, over the checked frames, of
pixels whose value differs from the reference's in any channel.
"""

from __future__ import annotations

import numpy as np
import torch

QUIET_LEAF = 1e-3


def _norms(d: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(t.double().cpu()))
            for n, t in d.items()}


def leaf_gap(got: dict, ref: dict, keep=None) -> float:
    """max over leaves of |‖got‖ − ‖ref‖| / max(‖ref‖, median ‖ref‖)."""
    g, r = _norms(got), _norms(ref)
    med = float(np.median(list(r.values())))
    names = [n for n in r if keep is None or n in keep]
    return max((abs(g[n] - r[n]) / max(r[n], med, 1e-30) for n in names),
               default=0.0)


def train_numbers(prog: dict, ref: dict) -> dict:
    """prog, ref: {"losses": [...], "grads": {leaf: first gradient},
    "change": {leaf: parameters after the steps minus before}}."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(prog["losses"], ref["losses"]))
    rg = _norms(ref["grads"])
    med = float(np.median(list(rg.values())))
    keep = {n for n, v in rg.items() if v >= QUIET_LEAF * med}
    return {"loss_gap": loss_gap,
            "grad_gap": leaf_gap(prog["grads"], ref["grads"]),
            "change_gap": leaf_gap(prog["change"], ref["change"], keep)}


def pixel_gap_share(got: np.ndarray, ref: np.ndarray) -> float:
    """Share of the (H, W, 3) frame's pixels that differ in any channel."""
    if got.shape != ref.shape:
        return 1.0
    bad = ~(got == ref).all(axis=-1)
    bad |= ~np.isfinite(got).all(axis=-1)
    return float(bad.mean())
