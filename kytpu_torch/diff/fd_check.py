"""Finite-difference validation of rendering gradients
(kytpu/diff/fd_check.py).

Pixel gradients of the Monte Carlo render must match central finite
differences of the same estimator at the same seed: common random numbers
make the FD noise cancel exactly, so the comparison is tight even at low
spp.
"""

from __future__ import annotations

import torch

from kytpu_torch.diff.params import get_params, set_params


def fd_gradient(f, params: dict, name: str, index, eps: float = 1e-3):
    """Central finite difference of the scalar f(params) with respect to
    params[name][index], each side on a shifted copy of that leaf."""
    def shifted(sign: float):
        p = dict(params)
        x = p[name].detach().clone()
        x[index] += sign * eps
        p[name] = x
        with torch.no_grad():
            return f(p)
    return (shifted(+1.0) - shifted(-1.0)) / (2.0 * eps)


def check_gradients(scene, loss_of_scene, probes, eps: float = 1e-3):
    """Compare autodiff against FD at the given probes.

    loss_of_scene: scene -> 0-dim tensor (deterministic given its closure,
    i.e. a fixed key). probes: list of (param_name, index_tuple). Returns
    a list of (name, index, autodiff, fd), the two as python floats."""
    params = get_params(scene)

    def f(p):
        return loss_of_scene(set_params(scene, p))

    leaves = {n: v.detach().clone().requires_grad_()
              for n, v in params.items()}
    grads = dict(zip(leaves, torch.autograd.grad(
        f(leaves), list(leaves.values()), allow_unused=True)))
    out = []
    for name, idx in probes:
        g = grads[name]
        ad = 0.0 if g is None else float(g[idx])
        fd = float(fd_gradient(f, params, name, idx, eps))
        out.append((name, idx, ad, fd))
    return out
