"""The port's differentiable renders and train step on the jnp engines
(kytpu_torch/diff/inverse.py: render_once, render_loss,
make_train_step(engine="jnp" | "fast" | "path")) against kytpu's, on the
CPU: torch autograd against jax.grad through the same estimator.

Gradients of render_loss (relmse against a numpy-seeded target, 2 samples
a pixel): every table finite first, then within rtol=1e-4 plus 1e-6 of
the table's largest entry, for the material, emission and exponent tables
on the Cornell box, the environment radiance on a Cornell box lit by the
sky, a point and a directional light, the fast engine, and the texture
leaves of a scene with an image and a checker on spheres.

Train steps: three steps of each engine on Cornell 8x8, 2 samples a pixel,
depth 2, Adam lr 2e-2, from the true scene with its diffuse table scaled
by 0.4, against a target rendered by the port at 16 samples a pixel; one
key for all three, so each lowers the same estimator and the loss falls.
Losses within rtol=1e-5, parameters within atol=1e-5 (each Adam step
moves a parameter by at most 2e-2), as tests/test_torch_train.py holds
the kernels' step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kytpu.diff import inverse as jinv
from kytpu.diff import params as jparams
from kytpu.integrator.fast import FastConfig
from kytpu.integrator.path import PathConfig
from kytpu.scene import builders as jb
from kytpu_torch.core import rng as trng
from kytpu_torch.diff import inverse as tinv
from kytpu_torch.diff import params as tparams
from kytpu_torch.scene import builders as tb
from tests.test_torch_render_jnp import _textured_sphere
from tests.torch_jnp import port_cfg, trender

TEX = ("tex_color_a", "tex_color_b", "tex_image")
CASES = {
    "cornell": (lambda b: b.cornell_box(width=12, height=12),
                PathConfig(max_depth=3),
                jparams.TRAINABLE + ("mat_exponent",)),
    "cornell_env": (lambda b: b.cornell_box(
        {jb.LIGHT_ENVIRONMENT, jb.LIGHT_POINT, jb.LIGHT_DIRECTION,
         jb.SMALL_GLASS_SPHERE}, 12, 12),
        PathConfig(max_depth=3, strategy="light_mis"),
        jparams.TRAINABLE + ("env_radiance_",)),
    "cornell_fast": (lambda b: b.cornell_box(width=12, height=12),
                     FastConfig(max_depth=3),
                     jparams.TRAINABLE + ("mat_exponent",)),
    "textures": (lambda b: _textured_sphere(b, 12, 12),
                 PathConfig(max_depth=2), jparams.TRAINABLE + TEX),
}


@pytest.mark.parametrize("case", list(CASES))
def test_render_loss_gradients_match_jax(case):
    make, cfg, names = CASES[case]
    jsc, tsc = make(jb), make(tb)
    h, w = tsc.camera.height, tsc.camera.width
    target = np.random.default_rng(1).uniform(0.05, 1.0, (h, w, 3)).astype(
        np.float32)
    ref = jax.grad(lambda p: jinv.render_loss(
        p, jsc, jnp.asarray(target), jax.random.key(3), 2, cfg))(
            jparams.get_params(jsc, names))
    leaves = {n: p.detach().clone().requires_grad_()
              for n, p in tparams.get_params(tsc, names).items()}
    tinv.render_loss(leaves, tsc, torch.from_numpy(target), trng.key(3), 2,
                     port_cfg(cfg)).backward()
    for n in names:
        got = leaves[n].grad.numpy()
        assert np.isfinite(got).all(), n
        a = np.asarray(ref[n])
        assert np.abs(a).max() > 0, n
        np.testing.assert_allclose(got, a, rtol=1e-4,
                                   atol=1e-6 * np.abs(a).max(), err_msg=n)


def test_render_once_matches_kytpu():
    jsc, tsc = jb.cornell_box(width=8, height=8), tb.cornell_box(width=8,
                                                                 height=8)
    cfg = PathConfig(max_depth=2)
    ref = np.asarray(jinv.render_once(jsc, jax.random.key(7), 3, cfg))
    got = tinv.render_once(tsc, trng.key(7), 3, port_cfg(cfg),
                           device="cpu").numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("engine, cfg", [
    ("jnp", PathConfig(max_depth=2)),
    ("fast", FastConfig(max_depth=2)),
    ("path", PathConfig(max_depth=2, variant="defered")),
])
def test_train_steps_match_kytpu(engine, cfg):
    w = h = 8
    tsc = tb.cornell_box(width=w, height=h)
    target = trender.render(tsc, spp=16, seed=3, clamp=False, engine="jnp",
                            cfg=port_cfg(cfg), device="cpu").numpy()
    jsc = jb.cornell_box(width=w, height=h)
    jsc = dataclasses.replace(jsc, mat_diffuse=jsc.mat_diffuse * 0.4)
    tsc = dataclasses.replace(tsc, mat_diffuse=tsc.mat_diffuse * 0.4)

    step, params, opt = jinv.make_train_step(jsc, jnp.asarray(target), spp=2,
                                             cfg=cfg, engine=engine)
    key = jax.random.key(0)
    ref_losses, ref_params = [], []
    for _ in range(3):
        params, opt, loss = step(params, opt, key)
        ref_losses.append(float(loss))
        ref_params.append({k: np.asarray(v) for k, v in params.items()})

    tstep, tp, _ = tinv.make_train_step(tsc, target, spp=2,
                                        cfg=port_cfg(cfg), engine=engine,
                                        device="cpu")
    losses = []
    for i in range(3):
        losses.append(float(tstep(trng.key(0))))
        for name, p in tp.items():
            assert torch.isfinite(p).all() and (p >= 0).all()
            np.testing.assert_allclose(p.detach().numpy(), ref_params[i][name],
                                       rtol=0, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert losses[0] > losses[1] > losses[2]
