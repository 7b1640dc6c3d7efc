"""The port's training path on the CPU: make_train_step against kytpu's, the
hash/single gradient against finite differences, the sharded step on a 1x1
mesh and past 32 lights, the entry points' refusals, and the jnp engines'
step on the CPU.

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
from kytpu_torch.integrator import path as tpath
from kytpu_torch.integrator.render import render
from kytpu_torch.kernels import bigscene as tbs
from kytpu_torch.kernels import wavefront as twf
from kytpu_torch.scene import builders as tb
from kytpu_torch.scene.scene import generate_rays
from tests.test_torch_cuda import ALL_LIGHTS, many_lights
import tests.torch_threads  # noqa: F401  (one torch thread a process)


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
    (dict(mesh=(1, 1)), "M10"),
])
def test_train_step_refuses_unported(kwargs, item, tmp_path):
    """What was refused is ported: item M10's sharded step (`mesh=`) on a
    1x1 mesh of a world-size-1 gloo group is the unsharded step to the bit,
    on both engines, over two steps."""
    from kytpu_torch.dist import make_mesh, multihost

    assert item == "M10"
    sc = tb.cornell_box(width=4, height=4)
    target = np.full((4, 4, 3), 0.5, np.float32)
    multihost.initialize(f"file://{tmp_path / 'init'}", 1, 0, device="cpu")
    try:
        mesh = make_mesh(shape=kwargs["mesh"], device="cpu")
        for engine in ("cuda", "jnp"):
            kw = dict(spp=2, max_depth=2, engine=engine,
                      kernel_sampler="hash" if engine == "cuda" else None)
            s_m, p_m, _ = tinv.make_train_step(sc, target, mesh=mesh, **kw)
            s_u, p_u, _ = tinv.make_train_step(sc, target, device="cpu", **kw)
            for i in range(2):
                assert torch.equal(s_m(trng.key(i)), s_u(trng.key(i)))
                for k in p_u:
                    assert torch.equal(p_m[k], p_u[k]), (engine, k)
        with pytest.raises(ValueError, match="invariant sampler"):
            tinv.make_train_step(sc, target, mesh=mesh,
                                 kernel_sampler="random")
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("engine", ["jnp", "fast", "path"])
def test_train_step_jnp_engines_run_on_the_cpu(engine):
    sc = tb.cornell_box(width=4, height=4)
    step, params, _ = tinv.make_train_step(
        sc, np.full((4, 4, 3), 0.5, np.float32), spp=1, engine=engine,
        device="cpu")
    loss = step(trng.key(1))
    assert loss.device.type == "cpu" and torch.isfinite(loss)
    assert all(torch.isfinite(p).all() for p in params.values())


def test_train_step_unknown_engine_raises():
    with pytest.raises(ValueError, match="unknown engine"):
        tinv.make_train_step(tb.cornell_box(width=4, height=4),
                             np.zeros((4, 4, 3), np.float32), engine="pallas",
                             device="cpu")


def test_train_step_refuses_big_scenes(monkeypatch):
    """Past 64 surfaces and 32 lights the step trains as kytpu routes it:
    64 lights on 65 surfaces take the big-scene kernels K6 and K7 (their
    plain versions here), and the loss falls."""
    sc = many_lights(tb, 64, 8, 6)   # 65 surfaces
    calls = []
    real = tbs.make_bigscene_diff_tracer
    monkeypatch.setattr(tbs, "make_bigscene_diff_tracer",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(twf, "make_cuda_diff_tracer",
                        lambda *a, **k: pytest.fail("routed to K2/K3"))
    target = tinv.render_once(sc, trng.key(3), 2, tpath.PathConfig(
        max_depth=2), device="cpu").detach()
    start = dataclasses.replace(sc, mat_diffuse=sc.mat_diffuse * 0.4)
    step, params, _ = tinv.make_train_step(start, target, spp=1,
                                           max_depth=2,
                                           kernel_sampler="hash",
                                           device="cpu")
    losses = [float(step(trng.key(5))) for _ in range(2)]
    assert calls == [1]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


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
