"""make_train_step on a scene past 64 surfaces: the port's big-scene step
(K6 and K7's plain versions) against kytpu's (its engine="pallas" step,
which routes to its table kernels past 64 surfaces, interpreted).

Three steps on random_spheres(n=80) at 8x8, spp 2, depth 2,
kernel_sampler="hash", Adam lr 2e-2, from the true scene with its diffuse
table scaled by 0.4, against a target the port renders at 16 spp; both are
given one key for all three steps, so each step lowers the same estimator.
Tolerance: losses within rtol=1e-5; parameters within atol=5e-5 (Adam
normalises each step, so a row whose gradient is a few rounding errors
moves by a rounding-sized share of lr in either package: up to 2.5e-5 was
seen, 1e-5 holds for the 64-surface step of test_torch_train.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from kytpu.diff import inverse as jinv
from kytpu.integrator.path import PathConfig
from kytpu.scene import builders as jb
from kytpu_torch.core import rng as trng
from kytpu_torch.diff import inverse as tinv
from kytpu_torch.diff import params as tparams
from kytpu_torch.integrator.render import render
from kytpu_torch.kernels import bigscene as kbs
from kytpu_torch.scene import builders as tb


def test_big_scene_train_steps_match_kytpu(monkeypatch):
    w = h = 8
    tsc = tb.random_spheres(n=80, width=w, height=h)
    target = render(tsc, spp=16, seed=3, clamp=False, device="cpu").numpy()
    jsc = jb.random_spheres(n=80, width=w, height=h)
    jsc = dataclasses.replace(jsc, mat_diffuse=jsc.mat_diffuse * 0.4)
    tsc = dataclasses.replace(tsc, mat_diffuse=tsc.mat_diffuse * 0.4)

    step, params, opt = jinv.make_train_step(
        jsc, jnp.asarray(target), spp=2, cfg=PathConfig(max_depth=2),
        engine="pallas", kernel_sampler="hash")
    key = jax.random.key(0)
    ref_losses, ref_params = [], []
    for _ in range(3):
        params, opt, loss = step(params, opt, key)
        ref_losses.append(float(loss))
        ref_params.append({k: np.asarray(v) for k, v in params.items()})

    calls = []
    real = kbs.bwd_res
    monkeypatch.setattr(kbs, "bwd_res",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    tstep, tp, _ = tinv.make_train_step(tsc, target, spp=2, max_depth=2,
                                        kernel_sampler="hash", device="cpu")
    assert set(tp) == set(tparams.TRAINABLE)
    losses = []
    for i in range(3):
        losses.append(float(tstep(trng.key(0))))
        for name, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), ref_params[i][name],
                                       rtol=0, atol=5e-5, err_msg=name)
            assert (p >= 0).all()
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert losses[0] > losses[1] > losses[2]
    assert len(calls) == 3   # the big-scene backward ran each step
