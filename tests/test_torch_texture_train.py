"""Texture recovery through the port's train step against kytpu's:
three make_train_step(names=("tex_image",)) steps on a Cornell box (8x8,
spp 2, depth 2, kernel_sampler="hash", Adam lr 2e-2) with a 4x4 image on
its back wall, from a flat 0.5 grey atlas against a target the port
renders of the true scene at 64 spp; kytpu runs its engine="pallas" step
(K2 and K3 in interpret mode). One key for all three steps, so each step
lowers the same estimator. Tolerance: losses within rtol=1e-5 and texels
within atol=1e-5 (the gradients differ by float32 rounding; each Adam step
moves a texel by at most lr = 2e-2). Then three steps of the checker
colours (names=("tex_color_a", "tex_color_b"), from 0.4 of the true
colours), on the port alone: the loss falls at each step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kytpu.diff import inverse as jinv
from kytpu.diff import params as jparams
from kytpu.integrator.path import PathConfig
from kytpu.scene import builders as jb
from kytpu_torch.core import rng as trng
from kytpu_torch.diff import inverse as tinv
from kytpu_torch.diff import params as tparams
from kytpu_torch.integrator.render import render
from kytpu_torch.scene import builders as tb
from tests.test_torch_texture import IMG4


def test_texture_train_steps_match_kytpu():
    w = h = 8
    names = ("tex_image",)
    tsc = tb.cornell_box(width=w, height=h, back_image=IMG4)
    target = render(tsc, spp=64, seed=3, clamp=False, device="cpu").numpy()
    jsc = jb.cornell_box(width=w, height=h, back_image=IMG4)
    jsc = jparams.set_params(jsc, {"tex_image": jnp.full_like(
        jsc.textures.image, 0.5)})
    tsc = tparams.set_params(tsc, {"tex_image": torch.full_like(
        tsc.textures.image, 0.5)})

    step, params, opt = jinv.make_train_step(
        jsc, jnp.asarray(target), spp=2, cfg=PathConfig(max_depth=2),
        engine="pallas", kernel_sampler="hash", names=names)
    key = jax.random.key(0)
    ref_losses, ref_texels = [], []
    for _ in range(3):
        params, opt, loss = step(params, opt, key)
        ref_losses.append(float(loss))
        ref_texels.append(np.asarray(params["tex_image"]))

    tstep, tp, _ = tinv.make_train_step(tsc, target, spp=2, max_depth=2,
                                        kernel_sampler="hash", device="cpu",
                                        names=names)
    assert set(tp) == set(names)
    losses = []
    for i in range(3):
        losses.append(float(tstep(trng.key(0))))
        np.testing.assert_allclose(tp["tex_image"].detach().numpy(),
                                   ref_texels[i], rtol=0, atol=1e-5)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert losses[0] > losses[1] > losses[2]
    err = float(np.abs(tp["tex_image"].detach().numpy() - IMG4).mean())
    assert err < float(np.abs(0.5 - IMG4).mean())


def test_checker_train_steps_lower_the_loss():
    names = ("tex_color_a", "tex_color_b")
    tsc = tb.cornell_box(width=8, height=8, floor_checker=True)
    target = render(tsc, spp=64, seed=3, clamp=False, device="cpu").numpy()
    true = tparams.get_params(tsc, names)
    start = tparams.set_params(tsc, {n: v * 0.4 for n, v in true.items()})
    step, params, _ = tinv.make_train_step(start, target, spp=2, max_depth=2,
                                           kernel_sampler="hash",
                                           device="cpu", names=names)
    losses = [float(step(trng.key(0))) for _ in range(3)]
    assert losses[0] > losses[1] > losses[2], losses
    err = sum(float((params[n].detach() - true[n]).abs().mean())
              for n in names)
    assert err < sum(float((0.6 * true[n]).abs().mean()) for n in names)
    assert dataclasses.is_dataclass(tparams.set_params(start, params).textures)
