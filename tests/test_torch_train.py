"""The port's training path on the CPU: make_train_step against kytpu's, the
hash/single gradient against finite differences, and the entry points that
refuse what is not ported.

Train step: three steps of make_train_step (Cornell 8x8, spp 2, depth 2,
kernel_sampler="hash", Adam lr 2e-2; all parameters linear, and emission
in softplus-log space) from the true scene with its diffuse
table scaled by 0.4, against a target rendered by the port at 64 spp; kytpu
runs its engine="pallas" step (K2 and K3 in interpret mode). Both are given
one key for all three steps, so each step minimises the same estimator and
the loss falls. Tolerance: losses within rtol=1e-5 and parameters within
atol=1e-5 (the two gradients differ by float32 rounding, each Adam step
moves a parameter by at most lr = 2e-2).

hash/single: the port's gradient against central finite differences of its
own plain forward (step 1e-2, |ad - fd| <= 3e-3 max(|fd|, 1e-2), as
tests/test_kernel.py's replay-backward check). kytpu's K3 is no reference
here: it recomputes the single-light pick without the sample-index term the
forward adds under this sampler (ROADMAP section 4).
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
from tests.test_torch_cuda import ALL_LIGHTS, many_lights


@pytest.mark.parametrize("spaces", [None, {"emission": "log"}],
                         ids=["linear", "log-emission"])
def test_train_steps_match_kytpu(spaces):
    w = h = 8
    tsc = tb.cornell_box(width=w, height=h)
    target = render(tsc, spp=64, seed=3, clamp=False, device="cpu").numpy()
    jsc = jb.cornell_box(width=w, height=h)
    jsc = dataclasses.replace(jsc, mat_diffuse=jsc.mat_diffuse * 0.4)
    tsc = dataclasses.replace(tsc, mat_diffuse=tsc.mat_diffuse * 0.4)

    step, params, opt = jinv.make_train_step(
        jsc, jnp.asarray(target), spp=2, cfg=PathConfig(max_depth=2),
        engine="pallas", kernel_sampler="hash", param_spaces=spaces)
    key = jax.random.key(0)
    ref_losses, ref_params = [], []
    for _ in range(3):
        params, opt, loss = step(params, opt, key)
        ref_losses.append(float(loss))
        ref_params.append({k: np.asarray(v) for k, v in params.items()})

    tstep, tp, _ = tinv.make_train_step(tsc, target, spp=2, max_depth=2,
                                        kernel_sampler="hash", device="cpu",
                                        param_spaces=spaces)
    assert set(tp) == set(tparams.TRAINABLE)
    losses = []
    for i in range(3):
        losses.append(float(tstep(trng.key(0))))
        for name, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), ref_params[i][name],
                                       rtol=0, atol=1e-5, err_msg=name)
            assert (p >= 0).all()
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert losses[0] > losses[1] > losses[2]


def test_hash_single_gradient_matches_finite_differences():
    sc = tb.cornell_box(ALL_LIGHTS, 24, 16)
    cfg = twf.KernelConfig(max_depth=2, rows=8, sampler="hash", nee="single")
    n = 2048
    rng = np.random.default_rng(5)
    pix = np.arange(n) % (24 * 16)
    pf = np.stack([pix % 24 + rng.random(n), pix // 24 + rng.random(n)], -1)
    o, d = generate_rays(sc.camera, torch.tensor(pf, dtype=torch.float32))
    si = torch.tensor(np.arange(n) // (24 * 16) + 2, dtype=torch.int32)
    pix = torch.tensor(pix, dtype=torch.int32)
    wts = torch.tensor(rng.random((n, 3)), dtype=torch.float32)
    tracer = twf.make_cuda_diff_tracer(sc, cfg)
    p0 = [sc.mat_diffuse, sc.mat_specular, sc.emission, sc.env_radiance_]

    def loss(*p):
        return (tracer(*p, o, d, 9, si, pix) * wts).sum() / n

    leaves = [t.clone().requires_grad_() for t in p0]
    loss(*leaves).backward()
    kinds = sc.mat_kind.tolist()
    plastic, glass = kinds.index(3), kinds.index(2)
    probes = [(0, (0, 0)), (0, (1, 1)), (0, (2, 2)), (0, (plastic, 1)),
              (0, (glass, 0)), (1, (plastic, 0)), (3, (0,)), (3, (2,))]
    eps = 1e-2
    for argi, idx in probes:
        fd = []
        for sgn in (1.0, -1.0):
            p = [t.clone() for t in p0]
            p[argi][idx] += sgn * eps
            with torch.no_grad():
                fd.append(float(loss(*p)))
        fd = (fd[0] - fd[1]) / (2 * eps)
        ad = float(leaves[argi].grad[idx])
        assert abs(ad - fd) <= 3e-3 * max(abs(fd), 1e-2), (argi, idx, ad, fd)
    # the environment's NEE adjoint depends on the single-light pick
    assert abs(float(leaves[3].grad[0])) > 1e-2


@pytest.mark.parametrize("kwargs, item", [
    (dict(mesh=object()), "M10"),
    (dict(engine="jnp"), "M7"),
    (dict(names=("tex_color_a",)), "M9"),
])
def test_train_step_refuses_unported(kwargs, item):
    sc = tb.cornell_box(width=4, height=4)
    with pytest.raises(NotImplementedError, match=item):
        tinv.make_train_step(sc, np.zeros((4, 4, 3), np.float32),
                             device="cpu", **kwargs)


def test_train_step_refuses_big_scenes():
    """Past 64 surfaces the step takes the big-scene kernels, which share
    K1's cap of 32 lights: 65 surfaces and 64 lights raise, naming M12."""
    sc = many_lights(tb, 64)   # 65 surfaces
    with pytest.raises(NotImplementedError, match="M12"):
        tinv.make_train_step(sc, np.zeros((16, 24, 3), np.float32),
                             device="cpu")


def test_train_step_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tinv.make_train_step(tb.cornell_box(width=4, height=4),
                             np.zeros((4, 4, 3), np.float32))


def test_set_params_ties_light_emission():
    sc = tb.cornell_box(width=4, height=4)
    em = sc.emission * 2.0 + 1.0
    sc2 = tparams.set_params(sc, {"emission": em})
    row = sc.lights.surface_ids[0]
    np.testing.assert_array_equal(sc2.lights.emit[0].numpy(), em[row].numpy())
    np.testing.assert_array_equal(sc2.emission.numpy(), em.numpy())


def test_diff_tracer_gradients_only_where_asked():
    """No colour table needs a gradient: the forward runs K1's plain
    version and keeps no cache. One table does: only it gets a gradient,
    equal to its share of the full backward."""
    sc = tb.cornell_box(ALL_LIGHTS, 8, 8)
    cfg = twf.KernelConfig(max_depth=2, rows=1)
    tracer = twf.make_cuda_diff_tracer(sc, cfg)
    n = 256
    o = sc.camera.position.expand(n, 3)
    rng = np.random.default_rng(2)
    d = torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32)
    d = d / d.norm(dim=1, keepdim=True)
    p0 = [sc.mat_diffuse, sc.mat_specular, sc.emission, sc.env_radiance_]
    out = tracer(*p0, o, d, 4)
    assert out.grad_fn is None
    k1 = twf.trace_lanes_plain(twf.pack_tables(sc, cfg), cfg, o, d, 4)
    np.testing.assert_array_equal(out.numpy(), k1.numpy())
    full = [t.clone().requires_grad_() for t in p0]
    tracer(*full, o, d, 4).sum().backward()
    env = p0[3].clone().requires_grad_()
    out = tracer(*p0[:3], env, o, d, 4)
    np.testing.assert_array_equal(out.detach().numpy(), k1.numpy())
    out.sum().backward()
    np.testing.assert_array_equal(env.grad.numpy(), full[3].grad.numpy())
    assert all(t.grad is None for t in p0[:3])


def test_log_codec_round_trips():
    enc, dec = tparams.make_codec({"emission": "log"})
    p = {"emission": torch.tensor([0.0, 0.5, 17.0, 40.0]),
         "mat_diffuse": torch.tensor([0.25])}
    back = dec(enc(p))
    np.testing.assert_allclose(back["emission"].numpy(),
                               [1e-6, 0.5, 17.0, 40.0], rtol=1e-5)
    assert back["mat_diffuse"] is p["mat_diffuse"]
