"""The benchmark's plain reference (reference/frozen, reference/oracle.py)
against the port's plain versions, on a few thousand lanes at depth 1-3:
the same lanes, caches, gradients, frames and train steps to the bit."""

import pytest
import torch

from kytpu_torch.diff.inverse import make_train_step
from kytpu_torch.diff.params import set_params
from kytpu_torch.integrator.render import render
from kytpu_torch.kernels import wavefront as kwf
from kytpu_torch.scene import builders as pb
from perfbench.reference import oracle
from perfbench.reference.frozen.kernels import wavefront as rwf

SCENES = {"veach_mis": {"scene": "veach_mis",
                        "args": {"width": 48, "height": 30}},
          "cornell_box": {"scene": "cornell_box",
                          "args": {"width": 40, "height": 40}}}
TRANSPORT = {"nee": "all", "sampler": "random", "shadow": "parity",
             "rr_start": 3}


def _config(name):
    return dict(SCENES[name], transport=TRANSPORT)


@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("depth", [1, 3])
def test_lanes_and_cache_bit_for_bit(name, depth):
    config = _config(name)
    cfg = oracle.kernel_config(config, {"max_depth": depth})
    ref_scene = oracle.build_scene(config, "cpu")
    scene = getattr(pb, config["scene"])(**config["args"])
    n = 4096
    u = oracle.krng.uniform(oracle.krng.key(5), (n, 2))
    w = config["args"]["width"]
    pid = torch.arange(n) % (w * config["args"]["height"])
    pf = torch.stack([(pid % w).float() + u[:, 0],
                      (pid // w).float() + u[:, 1]], -1)
    o, d = oracle.kscene.generate_rays(ref_scene.camera, pf)
    got = kwf.trace_lanes_plain(kwf.pack_tables(scene, kwf.KernelConfig(
        max_depth=depth)), kwf.KernelConfig(max_depth=depth), o, d, 77,
        residual=True)
    tables = rwf.pack_tables(ref_scene, cfg)
    ref = rwf.trace_lanes_plain(tables, cfg, o, d, 77, residual=True)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    g = torch.randn(n, 3, generator=torch.Generator().manual_seed(1))
    gb = kwf.bwd_res_plain(kwf.pack_tables(scene, kwf.KernelConfig(
        max_depth=depth)), kwf.KernelConfig(max_depth=depth), g, *got)
    rb = rwf.bwd_res_plain(tables, cfg, g, *ref)
    for a, b in zip(gb, rb):
        assert torch.equal(a, b)


def test_blocks_keep_each_lanes_draws(monkeypatch):
    """Tracing in blocks (with each block's tile seed) gives the lanes of
    one launch."""
    config = _config("cornell_box")
    cfg = oracle.kernel_config(config, {"max_depth": 2})
    scene = oracle.build_scene(config, "cpu")
    n = 3 * 2048 + 100
    o, d = oracle.kscene.generate_rays(
        scene.camera, torch.rand(n, 2, generator=torch.Generator(
        ).manual_seed(3)) * 40)
    tables = rwf.pack_tables(scene, cfg)
    whole = rwf.trace_lanes_plain(tables, cfg, o, d, 2**31 + 12345)
    monkeypatch.setattr(oracle, "BLOCK", 2048)
    blocks, _ = oracle.trace(tables, cfg, o, d, 2**31 + 12345)
    assert torch.equal(whole, blocks)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_frame_is_render_bit_for_bit(name):
    config = _config(name)
    cfg = oracle.kernel_config(config, {"max_depth": 3})
    got = render(getattr(pb, config["scene"])(**config["args"]), spp=5,
                 seed=99, cfg=kwf.KernelConfig(max_depth=3),
                 rays_per_pass=3000, device="cpu")
    ref = oracle.render_frame(oracle.build_scene(config, "cpu"), cfg, 5, 99,
                              3000)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_train_steps_match_make_train_step(name):
    """Three steps of the port's step against the reference's: losses to
    the bit, the first gradient and the parameters within float32
    rounding of the sums' order."""
    config = _config(name)
    cfg = oracle.kernel_config(config, {"max_depth": 2})
    ref_scene = oracle.build_scene(config, "cpu")
    params0 = oracle.perturbed(ref_scene, 11, {
        "mat_diffuse": [0.7, 1.0], "mat_specular": [0.7, 1.0],
        "emission": [0.7, 1.3]})
    target = oracle.render_frame(ref_scene, cfg, 1, 3, 1 << 20, clamp=False)
    scene = set_params(getattr(pb, config["scene"])(**config["args"]),
                       {k: v.clone() for k, v in params0.items()})
    step, params, opt = make_train_step(scene, target.clone(), spp=2,
                                        max_depth=2, device="cpu")
    keys = [oracle.step_key(11, i) for i in range(3)]
    losses = [float(step(k)) for k in keys]
    ref_losses, _, ref_params = oracle.train_steps(
        ref_scene, cfg, target, params0, keys, 2, 0.02)
    assert losses == ref_losses
    for k in params:
        torch.testing.assert_close(params[k], ref_params[k], rtol=1e-5,
                                   atol=1e-6)
