"""The CUDA forward megakernel against its plain PyTorch version, on the
card. Needs a CUDA device and nvcc; skipped elsewhere. Run on the card with

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py -q

(the suite's conftest imports jax, which the card's machine does not need)."""

import numpy as np
import pytest
import torch

from kytpu_torch.kernels import wavefront as kwf
from kytpu_torch.scene import builders
from kytpu_torch.scene.scene import generate_rays

ALL_LIGHTS = {builders.LARGE_GLASS_SPHERE, builders.LIGHT_POINT,
              builders.LIGHT_DIRECTION, builders.LIGHT_ENVIRONMENT}


def many_lights(b, n_lights: int, width: int = 24, height: int = 16):
    """A matte floor and a glossy back wall lit by a point light and
    n_lights - 1 small sphere lights in a row, built with the builders
    module `b` (kytpu's or the port's, which share the assembler's API).
    The last sphere is light n_lights - 1, so at 32 lights its skip bit is
    the table's sign bit."""
    A = b._SceneAssembler
    a = A()
    g = a.geo
    a.surface(g.add_rectangle((-10, -2, 10), (-10, -2, -10), (10, -2, -10),
                              (10, -2, 10), flip_normal=True),
              A.matte(np.full(3, 0.5, np.float32)))
    a.surface(g.add_rectangle((-10, -10, 3), (-10, 10, 3), (10, 10, 3),
                              (10, -10, 3), flip_normal=True),
              A.plastic(np.float32([0.1, 0.1, 0.15]), np.ones(3, np.float32),
                        100.0))
    a.add_light(kind=b.klights.POINT, emit=np.full(3, 5.0, np.float32),
                position=np.float32([0.0, 3.0, -2.0]))
    n_sph = n_lights - 1
    for k in range(n_sph):
        c = (-4.5 + 9.0 * k / max(n_sph - 1, 1), 1.0 + 0.25 * (k % 3), 0.0)
        r = 0.05 + 0.03 * (k % 5)
        emit = np.full(3, 40.0 / (1 + k % 4), np.float32)
        slot = a.add_light(kind=b.klights.AREA_SPHERE, emit=emit,
                           center=np.asarray(c), radius=r)
        a._lights[slot]["surface_handle"] = a.surface(
            g.add_sphere(c, r), A.matte(np.zeros(3, np.float32)),
            emission=emit, light_slot=slot)
    cam = b.kscene.make_camera(position=(0.0, 1.0, -8.0),
                               front=(0.0, -0.2, 1.0), up=(0.0, 1.0, 0.0),
                               fov_degrees=50.0, width=width, height=height)
    return a.build(cam)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("scene, sampler, nee, shadow", [
    ("veach", "random", "all", "parity"),
    ("veach", "hash", "single", "robust"),
    ("cornell", "hash", "all", "robust"),
    ("cornell_lights", "random", "single", "parity"),
    ("cornell_lights", "hash", "all", "parity"),
    ("many_lights_11", "random", "all", "parity"),
    ("many_lights_32", "hash", "all", "robust"),
    ("many_lights_32", "random", "single", "parity"),
])
def test_kernel_matches_plain_on_card(cuda, scene, sampler, nee, shadow):
    sc = {"veach": lambda: builders.veach_mis(64, 40),
          "cornell": lambda: builders.cornell_box(width=64, height=64),
          "cornell_lights": lambda: builders.cornell_box(ALL_LIGHTS, 64, 64),
          "many_lights_11": lambda: many_lights(builders, 11, 64, 40),
          "many_lights_32": lambda: many_lights(builders, 32, 64, 40),
          }[scene]().to(cuda)
    n = 16384
    npix = sc.camera.width * sc.camera.height
    rng = np.random.default_rng(0)
    pix = np.arange(n) % npix
    pf = np.stack([pix % sc.camera.width + rng.random(n),
                   pix // sc.camera.width + rng.random(n)], -1)
    o, d = generate_rays(sc.camera, torch.tensor(pf, dtype=torch.float32,
                                                 device=cuda))
    si = torch.tensor(np.arange(n) // npix, dtype=torch.int32, device=cuda)
    pix = torch.tensor(pix, dtype=torch.int32, device=cuda)
    cfg = kwf.KernelConfig(max_depth=5, sampler=sampler, nee=nee,
                           shadow=shadow)
    before = kwf.launches
    got = kwf.render_lanes_cuda(sc, o, d, 3, cfg, si, pix)
    torch.cuda.synchronize()
    assert kwf.launches == before + 1
    ref = kwf.trace_lanes_plain(kwf.pack_tables(sc, cfg), cfg, o, d, 3, si,
                                pix)
    g, r = got.cpu().numpy(), ref.cpu().numpy()
    assert np.isfinite(g).all()
    bad = (~np.isclose(g, r, rtol=1e-3, atol=1e-4)).any(-1).mean()
    assert bad <= 0.005, bad


def _card_scene(name, cuda):
    return {"veach": lambda: builders.veach_mis(64, 40),
            "cornell_lights": lambda: builders.cornell_box(ALL_LIGHTS, 64, 64),
            "many_lights_32": lambda: many_lights(builders, 32, 64, 40),
            }[name]().to(cuda)


def _card_lanes(sc, cuda, n=16384, seed=0):
    npix = sc.camera.width * sc.camera.height
    rng = np.random.default_rng(seed)
    pix = np.arange(n) % npix
    pf = np.stack([pix % sc.camera.width + rng.random(n),
                   pix // sc.camera.width + rng.random(n)], -1)
    o, d = generate_rays(sc.camera, torch.tensor(pf, dtype=torch.float32,
                                                 device=cuda))
    si = torch.tensor(np.arange(n) // npix, dtype=torch.int32, device=cuda)
    return o, d, si, torch.tensor(pix, dtype=torch.int32, device=cuda)


RES_CASES = [("veach", "random", "all", "parity"),
             ("cornell_lights", "hash", "single", "robust"),
             ("many_lights_32", "random", "single", "parity"),
             ("many_lights_32", "hash", "all", "robust")]


@pytest.mark.cuda
@pytest.mark.parametrize("scene, sampler, nee, shadow", RES_CASES)
def test_residual_kernels_on_card(cuda, scene, sampler, nee, shadow):
    """K2's radiance equals K1's bit for bit; K2's cache and K3's gradient
    agree with their plain versions (radiance and cache: at most 0.5% of
    lanes outside rtol=1e-3/atol=1e-4; gradient: rtol=1e-4, atol=1e-6 of the
    table's largest entry), and K3 repeats bit for bit."""
    sc = _card_scene(scene, cuda)
    o, d, si, pix = _card_lanes(sc, cuda)
    cfg = kwf.KernelConfig(max_depth=5, sampler=sampler, nee=nee,
                           shadow=shadow)
    tables = kwf.pack_tables(sc, cfg)
    counts = (kwf.launches, kwf.launches_res_fwd, kwf.launches_res_bwd)
    k1 = kwf.trace_lanes(tables, cfg, o, d, 3, si, pix)
    k2, resf, resi = kwf.trace_lanes(tables, cfg, o, d, 3, si, pix,
                                     residual=True)
    g = torch.randn(o.shape, generator=torch.Generator(cuda).manual_seed(1),
                    device=cuda)
    grads = kwf.bwd_res(tables, cfg, g, k2, resf, resi)
    again = kwf.bwd_res(tables, cfg, g, k2, resf, resi)
    torch.cuda.synchronize()
    assert (kwf.launches, kwf.launches_res_fwd, kwf.launches_res_bwd) == (
        counts[0] + 1, counts[1] + 1, counts[2] + 2)
    assert torch.equal(k1, k2)
    for a, b in zip(grads, again):
        assert torch.equal(a, b)
    ref_l, ref_f, ref_i = kwf.trace_lanes_plain(tables, cfg, o, d, 3, si, pix,
                                                residual=True)
    for got, ref in ((k2, ref_l), (resf.T, ref_f.T)):
        g_, r_ = got.cpu().numpy(), ref.cpu().numpy()
        assert np.isfinite(g_).all()
        bad = (~np.isclose(g_, r_, rtol=1e-3, atol=1e-4)).any(-1).mean()
        assert bad <= 0.005, bad
    assert ((resi != ref_i).any(0).float().mean()) <= 0.005
    ref_g = kwf.bwd_res_plain(tables, cfg, g, ref_l, ref_f, ref_i)
    for a, b in zip(grads, ref_g):
        b = b.cpu().numpy()
        np.testing.assert_allclose(a.cpu().numpy(), b, rtol=1e-4,
                                   atol=1e-6 * max(1.0, np.abs(b).max()))


@pytest.mark.cuda
def test_train_step_on_card(cuda):
    """Three steps of make_train_step on the card: finite losses, parameters
    stay >= 0, and K2 and K3 launch once a step."""
    from kytpu_torch.core import rng as krng
    from kytpu_torch.diff.inverse import make_train_step
    from kytpu_torch.integrator.render import render

    sc = builders.cornell_box(width=32, height=32)
    target = render(sc, spp=16, seed=2, clamp=False, device=cuda)
    step, params, _ = make_train_step(sc, target, spp=2, kernel_sampler="hash")
    before = (kwf.launches_res_fwd, kwf.launches_res_bwd)
    losses = [float(step(krng.fold_in(krng.key(0), i))) for i in range(3)]
    assert (kwf.launches_res_fwd, kwf.launches_res_bwd) == (before[0] + 3,
                                                           before[1] + 3)
    assert np.isfinite(losses).all()
    assert all((p >= 0).all() and p.is_cuda for p in params.values())
