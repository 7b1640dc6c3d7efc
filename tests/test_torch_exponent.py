"""The trainable Phong exponent (KernelConfig(trainable_exponent=True)) in the
port's plain K1, K2, K3 and K4, against the baked exponent, kytpu's
interpreted kernels, central differences and kytpu's train step.

- Forward: the per-call exponent table gives the baked kernel's radiance
  within rtol=2e-4, atol=1e-6 (pow of the table value instead of the
  square-and-multiply power of the baked integer; kytpu's own bound).
- K2's "Bk"/"tuk" planes against kytpu's residuals (K2 in interpret mode),
  plane by plane: each within rtol=1e-3/atol=1e-4 on all but 0.5% of lanes
  (the forward tests' bound). K3's gradients, dexp included, against
  kytpu's residual backward at test_torch_wavefront_res.py's bound (rtol
  1e-4 plus 1e-6 of the table's largest entry; K4's against kytpu's
  replay backward in test_torch_exponent_replay.py); dexp is exactly 0 on
  every row but the plastic ones.
- Central differences under the construction of tests/test_kernel.py:
  505-580: point light, depth 2, the loss over lanes whose primary hit is
  not the glossy floor, so the detached estimator is exactly
  differentiable in the exponent at common random numbers; both backwards
  within 2e-3 relative.
- Three make_train_step(names=TRAINABLE + ("mat_exponent",)) steps on the
  CPU against kytpu's engine="pallas" step: losses within rtol=1e-5,
  parameters within atol=1e-5, as test_torch_train.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kytpu.diff import inverse as jinv
from kytpu.integrator.path import PathConfig
from kytpu.scene import builders as jb
from kytpu_torch.core import rng as trng
from kytpu_torch.diff import inverse as tinv
from kytpu_torch.diff import params as tparams
from kytpu_torch.integrator.render import render
from kytpu_torch.kernels import wavefront as twf
from kytpu_torch.scene import builders as tb
from kytpu_torch.scene.scene import generate_rays
from tests.test_torch_wavefront import SCENES, camera_rays
from tests.test_torch_wavefront_res import grads_agree, trace_grads


def _lanes(name, n=2048):
    o, d, si, pix = camera_rays(SCENES[name](jb), n)
    return [torch.from_numpy(np.array(a)) for a in (o, d, si, pix)]


@pytest.mark.parametrize("name, sampler, nee", [("cornell", "hash", "all"),
                                                ("veach", "sobol", "single")])
def test_trainable_forward_equals_baked(name, sampler, nee):
    sc = SCENES[name](tb)
    o, d, si, pix = _lanes(name)
    outs = []
    for texp in (False, True):
        cfg = twf.KernelConfig(max_depth=3, rr_start=1, rows=8,
                               sampler=sampler, nee=nee,
                               trainable_exponent=texp)
        outs.append(twf.trace_lanes_plain(twf.pack_tables(sc, cfg), cfg, o, d,
                                          3, si, pix).numpy())
    np.testing.assert_allclose(outs[1], outs[0], rtol=2e-4, atol=1e-6)


@pytest.fixture(scope="module")
def residual():
    # the all-lights box under one picked light: its phong lanes see the
    # point and environment lights (the default box's area light never
    # enters the floor's exponent-90 lobe at these lanes: "Bk" is 0 there)
    return trace_grads("cornell_lights", "random", "single", texp=True)


def test_exponent_planes_match_kytpu(residual):
    got, ref, static = residual
    cfg = twf.KernelConfig(max_depth=2, nee="single",
                           trainable_exponent=True)
    ix, _ = twf.residual_layout(static, cfg)
    tags = [t for t in ix if t[0] in ("Bk", "tuk")]
    assert len(tags) == 4   # one picked light, two bounces below the horizon
    for t in tags:
        a, b = got[2][ix[t]], ref[2][ix[t]]
        share = (~np.isclose(a, b, rtol=1e-3, atol=1e-4)).mean()
        assert share <= 0.005, (t, share)
        # the partner planes are 0 wherever their base plane is
        base = ("B",) + t[1:] if t[0] == "Bk" else ("tu", t[1])
        assert (a[got[2][ix[base]] == 0] == 0).all(), t
    # phong lanes reach every plane
    assert all(np.abs(got[2][ix[t]]).max() > 0 for t in tags)


def test_residual_gradients_match_kytpu(residual):
    got, ref, static = residual
    assert len(got[1]) == 5 and np.abs(got[1][4]).max() > 0
    grads_agree(got[1], ref[1], static)


@pytest.mark.parametrize("backward", ["residual", "replay"])
def test_exponent_gradient_matches_finite_differences(backward):
    sc = tb.cornell_box(tb.BOTH_SMALL_SPHERES | {tb.LIGHT_POINT}, 8, 8)
    n = 512
    rng = np.random.default_rng(0)
    pid = np.arange(n) % 64
    pf = np.stack([pid % 8 + rng.random(n), pid // 8 + rng.random(n)], -1)
    o, d = generate_rays(sc.camera, torch.tensor(pf, dtype=torch.float32))
    cfg = twf.KernelConfig(max_depth=2, rows=8, trainable_exponent=True)
    exp0 = sc.mat_exponent
    row = int(exp0.argmax())
    assert float(exp0[row]) > 0
    # lanes whose primary hit is not the glossy floor
    _, sid, _, _ = twf._closest_hit(twf.extract_static(sc),
                                    *(twf.V3(*t.unbind(1)) for t in (o, d)))
    keep = (sid != row)[:, None]
    tracer = twf.make_cuda_diff_tracer(sc, cfg, backward)
    tabs = [sc.mat_diffuse, sc.mat_specular, sc.emission]

    def loss(ex):
        out = tracer(*tabs, ex, torch.zeros(3), o, d, 5)
        return torch.where(keep, out, 0.0).mean()

    ex = exp0.clone().requires_grad_()
    loss(ex).backward()
    eps = 1.0
    with torch.no_grad():
        up, dn = exp0.clone(), exp0.clone()
        up[row] += eps
        dn[row] -= eps
        fd = (float(loss(up)) - float(loss(dn))) / (2 * eps)
    ad = float(ex.grad[row])
    assert np.isfinite(ad) and abs(fd) > 1e-9, (ad, fd)
    assert abs(ad - fd) <= 2e-3 * max(abs(fd), 1e-7), (ad, fd)
    # every other row: exactly 0
    others = torch.arange(len(exp0)) != row
    assert (ex.grad[others] == 0).all()
    assert (ex.grad[sc.mat_kind != 3] == 0).all()


def test_train_steps_with_exponent_match_kytpu():
    w = h = 8
    spaces = {"mat_exponent": "log"}
    names = tparams.TRAINABLE + ("mat_exponent",)
    tsc = tb.cornell_box(width=w, height=h)
    target = render(tsc, spp=64, seed=3, clamp=False, device="cpu").numpy()
    jsc = jb.cornell_box(width=w, height=h)
    jsc = dataclasses.replace(jsc, mat_exponent=jsc.mat_exponent * 0.5)
    tsc = dataclasses.replace(tsc, mat_exponent=tsc.mat_exponent * 0.5)

    step, params, opt = jinv.make_train_step(
        jsc, jnp.asarray(target), spp=2, cfg=PathConfig(max_depth=2),
        engine="pallas", kernel_sampler="hash", param_spaces=spaces,
        names=names)
    key = jax.random.key(0)
    ref_losses, ref_params = [], []
    for _ in range(3):
        params, opt, loss = step(params, opt, key)
        ref_losses.append(float(loss))
        ref_params.append({k: np.asarray(v) for k, v in params.items()})

    tstep, tp, _ = tinv.make_train_step(tsc, target, spp=2, max_depth=2,
                                        kernel_sampler="hash", device="cpu",
                                        param_spaces=spaces, names=names)
    assert set(tp) == set(names)
    losses = []
    for i in range(3):
        losses.append(float(tstep(trng.key(0))))
        for name, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), ref_params[i][name],
                                       rtol=0, atol=1e-5, err_msg=name)
            assert (p >= 0).all()
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert losses[0] > losses[2]
    # the glossy floor's exponent moved
    row = int(tsc.mat_exponent.argmax())
    assert float(tp["mat_exponent"][row]) != float(tsc.mat_exponent[row])
