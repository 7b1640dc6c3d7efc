"""The CUDA megakernels (K1-K4, with the row-tagged backwards past 64
surfaces, and the big-scene K5-K8, with textures; every sampler, both
exponent modes) against their plain PyTorch versions, on the card. Needs a
CUDA device and nvcc; skipped elsewhere. Run on the card with

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


REPLAY_CASES = [("veach", "sobol", "all", "parity", True),
                ("veach", "random", "single", "robust", False),
                ("cornell_lights", "hash", "single", "robust", False),
                ("cornell_lights", "sobol", "all", "parity", True),
                ("many_lights_32", "sobol", "single", "parity", True)]


@pytest.mark.cuda
@pytest.mark.parametrize("scene, sampler, nee, shadow, texp", REPLAY_CASES)
def test_replay_and_exponent_kernels_on_card(cuda, scene, sampler, nee, shadow,
                                              texp):
    """The path-replay backward K4, the sobol sampler and the trainable
    exponent through K1-K4: K1 against the plain K1 (as above), K2's cache
    (its "Bk"/"tuk" planes included) and K3's and K4's gradients (dexp
    included) against their plain versions (rtol=1e-4, atol=1e-6 of the
    table's largest entry), K4 against itself (bit for bit) and against K3
    (rtol=2e-3, atol=2e-5 of the largest entry, the reference's bound)."""
    sc = _card_scene(scene, cuda)
    o, d, si, pix = _card_lanes(sc, cuda)
    cfg = kwf.KernelConfig(max_depth=5, sampler=sampler, nee=nee,
                           shadow=shadow, trainable_exponent=texp)
    tables = kwf.pack_tables(sc, cfg)
    counts = (kwf.launches, kwf.launches_res_fwd, kwf.launches_res_bwd,
              kwf.launches_replay)
    k1 = kwf.trace_lanes(tables, cfg, o, d, 3, si, pix)
    k2, resf, resi = kwf.trace_lanes(tables, cfg, o, d, 3, si, pix,
                                     residual=True)
    g = torch.randn(o.shape, generator=torch.Generator(cuda).manual_seed(1),
                    device=cuda)
    k3 = kwf.bwd_res(tables, cfg, g, k2, resf, resi)
    k4 = kwf.bwd_replay(tables, cfg, o, d, 3, si, pix, g, k1)
    again = kwf.bwd_replay(tables, cfg, o, d, 3, si, pix, g, k1)
    torch.cuda.synchronize()
    assert (kwf.launches, kwf.launches_res_fwd, kwf.launches_res_bwd,
            kwf.launches_replay) == (counts[0] + 1, counts[1] + 1,
                                     counts[2] + 1, counts[3] + 2)
    assert torch.equal(k1, k2)
    assert len(k4) == (5 if texp else 4)
    for a, b in zip(k4, again):
        assert torch.equal(a, b)
    ref_l, ref_f, ref_i = kwf.trace_lanes_plain(tables, cfg, o, d, 3, si, pix,
                                                residual=True)
    for got, ref in ((k1, ref_l), (resf.T, ref_f.T)):
        g_, r_ = got.cpu().numpy(), ref.cpu().numpy()
        assert np.isfinite(g_).all()
        bad = (~np.isclose(g_, r_, rtol=1e-3, atol=1e-4)).any(-1).mean()
        assert bad <= 0.005, bad
    assert ((resi != ref_i).any(0).float().mean()) <= 0.005
    refs = (kwf.bwd_res_plain(tables, cfg, g, ref_l, ref_f, ref_i),
            kwf.bwd_replay_plain(tables, cfg, o, d, 3, si, pix, g, ref_l))
    for grads, ref_g in zip((k3, k4), refs):
        for a, b in zip(grads, ref_g):
            b = b.cpu().numpy()
            np.testing.assert_allclose(a.cpu().numpy(), b, rtol=1e-4,
                                       atol=1e-6 * max(1.0, np.abs(b).max()))
    for a, b in zip(k4, k3):
        b = b.cpu().numpy()
        np.testing.assert_allclose(a.cpu().numpy(), b, rtol=2e-3,
                                   atol=2e-5 * max(1.0, np.abs(b).max()))


@pytest.mark.cuda
def test_replay_tracer_launches_k4(cuda):
    """make_cuda_diff_tracer(backward="replay") on the card: K1 forward, K4
    backward (launches counted), the gradient K4's."""
    sc = _card_scene("veach", cuda)
    o, d, si, pix = _card_lanes(sc, cuda)
    cfg = kwf.KernelConfig(max_depth=5, sampler="sobol",
                           trainable_exponent=True)
    tracer = kwf.make_cuda_diff_tracer(sc, cfg, backward="replay")
    leaves = [t.clone().requires_grad_() for t in (
        sc.mat_diffuse, sc.mat_specular, sc.emission, sc.mat_exponent)]
    env = torch.zeros(3, device=cuda)
    before = (kwf.launches, kwf.launches_replay)
    out = tracer(*leaves, env, o, d, 3, si, pix)
    out.sum().backward()
    torch.cuda.synchronize()
    assert (kwf.launches, kwf.launches_replay) == (before[0] + 1,
                                                   before[1] + 1)
    tables = kwf._DiffTables(sc, cfg)(*leaves[:3], env, leaves[3])
    ref = kwf.bwd_replay(tables, cfg, o, d, 3, si, pix, torch.ones_like(out),
                         out.detach())
    for leaf, r in zip(leaves, ref[:3] + ref[4:]):
        assert torch.equal(leaf.grad, r)


BIG_CASES = [("spheres", "random", "parity", False),
             ("spheres", "hash", "robust", True),
             ("mesh", "sobol", "parity", True),
             ("mesh", "hash", "robust", False)]


@pytest.mark.cuda
@pytest.mark.parametrize("scene, sampler, shadow, texp", BIG_CASES)
def test_bigscene_kernels_on_card(cuda, scene, sampler, shadow, texp):
    """The big-scene kernels K5, K6 and K7 against their plain versions
    (radiance and cache: at most 0.5% of lanes outside rtol=1e-3/atol=1e-4;
    gradient: rtol=1e-4, atol=1e-6 of the table's largest entry), K6's
    radiance K5's bit for bit, and K7 repeating bit for bit."""
    from kytpu_torch.kernels import bigscene as kbs
    from kytpu_torch.scene import mesh

    sc = (builders.random_spheres(n=80, width=64, height=64)
          if scene == "spheres"
          else builders.mesh_scene(*mesh.icosphere(2), width=64, height=64)
          ).to(cuda)
    o, d, si, pix = _card_lanes(sc, cuda)
    cfg = kwf.KernelConfig(max_depth=3, sampler=sampler, shadow=shadow,
                           trainable_exponent=texp)
    tables = kbs.pack_big_tables(sc, cfg)
    counts = (kbs.launches, kbs.launches_res_fwd, kbs.launches_res_bwd)
    k5 = kbs.trace_lanes(tables, cfg, o, d, 3, si, pix)
    k6, resf, resi = kbs.trace_lanes(tables, cfg, o, d, 3, si, pix,
                                     residual=True)
    g = torch.randn(o.shape, generator=torch.Generator(cuda).manual_seed(1),
                    device=cuda)
    grads = kbs.bwd_res(tables, cfg, g, k6, resf, resi)
    again = kbs.bwd_res(tables, cfg, g, k6, resf, resi)
    torch.cuda.synchronize()
    assert (kbs.launches, kbs.launches_res_fwd, kbs.launches_res_bwd) == (
        counts[0] + 1, counts[1] + 1, counts[2] + 2)
    assert torch.equal(k5, k6)
    assert len(grads) == (5 if texp else 4)
    for a, b in zip(grads, again):
        assert torch.equal(a, b)
    ref_l, ref_f, ref_i = kbs.trace_lanes_plain(tables, cfg, o, d, 3, si,
                                                pix, residual=True)
    for got, ref in ((k6, ref_l), (resf.T, ref_f.T)):
        g_, r_ = got.cpu().numpy(), ref.cpu().numpy()
        assert np.isfinite(g_).all()
        bad = (~np.isclose(g_, r_, rtol=1e-3, atol=1e-4)).any(-1).mean()
        assert bad <= 0.005, bad
    assert ((resi != ref_i).any(0).float().mean()) <= 0.005
    for a, b in zip(grads, kbs.bwd_res_plain(tables, cfg, g, ref_l, ref_f,
                                             ref_i)):
        b = b.cpu().numpy()
        np.testing.assert_allclose(a.cpu().numpy(), b, rtol=1e-4,
                                   atol=1e-6 * max(1.0, np.abs(b).max()))


@pytest.mark.cuda
def test_bigscene_entry_points_on_card(cuda):
    """render() and make_train_step() past 64 surfaces launch K5, and K6
    and K7, on the card, and not K1-K4."""
    from kytpu_torch.core import rng as krng
    from kytpu_torch.diff.inverse import make_train_step
    from kytpu_torch.integrator.render import render
    from kytpu_torch.kernels import bigscene as kbs

    sc = builders.random_spheres(n=80, width=32, height=32)
    small = (kwf.launches, kwf.launches_res_fwd, kwf.launches_res_bwd,
             kwf.launches_replay)
    before = kbs.launches
    target = render(sc, spp=4, seed=2, clamp=False, device=cuda)
    assert kbs.launches == before + 1 and bool(torch.isfinite(target).all())
    step, params, _ = make_train_step(sc, target, spp=2, max_depth=2,
                                      kernel_sampler="hash")
    before = (kbs.launches_res_fwd, kbs.launches_res_bwd)
    losses = [float(step(krng.fold_in(krng.key(0), i))) for i in range(2)]
    assert (kbs.launches_res_fwd, kbs.launches_res_bwd) == (before[0] + 2,
                                                           before[1] + 2)
    assert small == (kwf.launches, kwf.launches_res_fwd, kwf.launches_res_bwd,
                     kwf.launches_replay)
    assert np.isfinite(losses).all()


@pytest.mark.cuda
@pytest.mark.parametrize("sampler, shadow, texp", [("random", "parity", False),
                                                   ("hash", "robust", True),
                                                   ("sobol", "parity", False)])
def test_bigscene_replay_on_card(cuda, sampler, shadow, texp):
    """K8, the big-scene path-replay backward: equal to the plain K8 and
    its sums (max |err| 0), repeating bit for bit, within the reference's
    2e-3 bound of K7 (rtol=2e-3, atol=2e-5 of the table's largest entry);
    the replay diff tracer launches K5 and K8 and gives K8's gradient."""
    from kytpu_torch.kernels import bigscene as kbs

    sc = builders.random_spheres(n=80, width=64, height=64).to(cuda)
    o, d, si, pix = _card_lanes(sc, cuda)
    cfg = kwf.KernelConfig(max_depth=3, sampler=sampler, shadow=shadow,
                           trainable_exponent=texp)
    tables = kbs.pack_big_tables(sc, cfg)
    k5 = kbs.trace_lanes(tables, cfg, o, d, 3, si, pix)
    g = torch.randn(o.shape, generator=torch.Generator(cuda).manual_seed(1),
                    device=cuda)
    before = kbs.launches_replay
    k8 = kbs.bwd_replay(tables, cfg, o, d, 3, si, pix, g, k5)
    again = kbs.bwd_replay(tables, cfg, o, d, 3, si, pix, g, k5)
    torch.cuda.synchronize()
    assert kbs.launches_replay == before + 2
    ref = kbs.sums_plain(tables, cfg, *kbs.bwd_replay_plain(
        tables, cfg, o, d, 3, si, pix, g, k5))
    k6, resf, resi = kbs.trace_lanes(tables, cfg, o, d, 3, si, pix,
                                     residual=True)
    k7 = kbs.bwd_res(tables, cfg, g, k6, resf, resi)
    assert len(k8) == (5 if texp else 4)
    for a, b, r, c in zip(k8, again, ref, k7):
        assert torch.equal(a, b) and torch.equal(a, r)
        c = c.cpu().numpy()
        np.testing.assert_allclose(a.cpu().numpy(), c, rtol=2e-3,
                                   atol=2e-5 * max(1.0, np.abs(c).max()))
    leaves = [t.clone().requires_grad_() for t in (
        tables.diffuse, tables.specular, tables.emission)]
    tracer = kbs.make_bigscene_diff_tracer(sc, cfg, backward="replay")
    counts = (kbs.launches, kbs.launches_res_fwd, kbs.launches_replay)
    exp = (tables.exponent,) if texp else ()
    out = tracer(*leaves, *exp, tables.env, o, d, 3, si, pix)
    out.backward(g)
    assert (kbs.launches, kbs.launches_res_fwd, kbs.launches_replay) == (
        counts[0] + 1, counts[1], counts[2] + 1)
    for leaf, a in zip(leaves, k8):
        assert torch.equal(leaf.grad, a)


TEX_IMAGES = {"checker": None, "select": (8, 8), "separable": (16, 16)}


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(TEX_IMAGES))
@pytest.mark.parametrize("sampler, texp", [("hash", False), ("sobol", True)])
def test_textured_kernels_on_card(cuda, route, sampler, texp):
    """K1-K4 with their texture branches against their plain versions on
    textured Cornell boxes (the checker floor; an 8x8 atlas, kytpu's select
    chain; a 16x16 one, its separable route): equal to the last bit, K2's
    radiance K1's, K3 and K4 repeating bit for bit, and K4 within the
    reference's 2e-3 bound of K3."""
    shape = TEX_IMAGES[route]
    img = (None if shape is None else np.random.default_rng(2).uniform(
        0.1, 0.9, shape + (3,)).astype(np.float32))
    sc = builders.cornell_box(width=64, height=64, floor_checker=img is None,
                              back_image=img).to(cuda)
    o, d, si, pix = _card_lanes(sc, cuda)
    cfg = kwf.KernelConfig(max_depth=5, sampler=sampler,
                           trainable_exponent=texp)
    tables = kwf.pack_tables(sc, cfg)
    k1 = kwf.trace_lanes(tables, cfg, o, d, 3, si, pix)
    k2, resf, resi = kwf.trace_lanes(tables, cfg, o, d, 3, si, pix,
                                     residual=True)
    g = torch.randn(o.shape, generator=torch.Generator(cuda).manual_seed(1),
                    device=cuda)
    k3 = kwf.bwd_res(tables, cfg, g, k2, resf, resi)
    k4 = kwf.bwd_replay(tables, cfg, o, d, 3, si, pix, g, k1)
    torch.cuda.synchronize()
    assert torch.equal(k1, k2)
    ref1 = kwf.trace_lanes_plain(tables, cfg, o, d, 3, si, pix)
    ref_l, ref_f, ref_i = kwf.trace_lanes_plain(tables, cfg, o, d, 3, si, pix,
                                                residual=True)
    assert torch.equal(k1, ref1) and torch.equal(resf, ref_f) and \
        torch.equal(resi, ref_i)
    refs = (kwf.bwd_res_plain(tables, cfg, g, ref_l, ref_f, ref_i),
            kwf.bwd_replay_plain(tables, cfg, o, d, 3, si, pix, g, ref1))
    again = (kwf.bwd_res(tables, cfg, g, k2, resf, resi),
             kwf.bwd_replay(tables, cfg, o, d, 3, si, pix, g, k1))
    assert len(k3) == 4 + texp + 2 + (img is not None)
    for got, ref, rep in zip((k3, k4), refs, again):
        for a, b, c in zip(got, ref, rep):
            assert torch.equal(a, b) and torch.equal(a, c)
    for a, b in zip(k4, k3):
        b = b.cpu().numpy()
        np.testing.assert_allclose(a.cpu().numpy(), b, rtol=2e-3,
                                   atol=2e-5 * max(1.0, np.abs(b).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("sampler, texp", [("random", False), ("hash", True)])
def test_textured_bigscene_kernels_on_card(cuda, sampler, texp):
    """K5-K8 with their texture branches (a checker floor and an 8x8 atlas,
    through the big-scene tables) against their plain versions: equal to
    the last bit, K6's radiance K5's, K7 and K8 repeating bit for bit, K8
    within the reference's 2e-3 bound of K7, the texture adjoints live."""
    from kytpu_torch.kernels import bigscene as kbs

    img = np.random.default_rng(2).uniform(0.1, 0.9, (8, 8, 3)).astype(
        np.float32)
    sc = builders.cornell_box(width=64, height=64, floor_checker=True,
                              back_image=img).to(cuda)
    o, d, si, pix = _card_lanes(sc, cuda, n=4096)
    cfg = kwf.KernelConfig(max_depth=3, sampler=sampler,
                           trainable_exponent=texp)
    tables = kbs.pack_big_tables(sc, cfg)
    k5 = kbs.trace_lanes(tables, cfg, o, d, 3, si, pix)
    k6, resf, resi = kbs.trace_lanes(tables, cfg, o, d, 3, si, pix,
                                     residual=True)
    g = torch.randn(o.shape, generator=torch.Generator(cuda).manual_seed(1),
                    device=cuda)
    k7 = kbs.bwd_res(tables, cfg, g, k6, resf, resi)
    k8 = kbs.bwd_replay(tables, cfg, o, d, 3, si, pix, g, k5)
    torch.cuda.synchronize()
    assert torch.equal(k5, k6)
    ref_l, ref_f, ref_i = kbs.trace_lanes_plain(tables, cfg, o, d, 3, si,
                                                pix, residual=True)
    assert torch.equal(k5, ref_l) and torch.equal(resf, ref_f) and \
        torch.equal(resi, ref_i)
    refs = (kbs.bwd_res_plain(tables, cfg, g, ref_l, ref_f, ref_i),
            kbs.sums_plain(tables, cfg, *kbs.bwd_replay_plain(
                tables, cfg, o, d, 3, si, pix, g, k5)))
    again = (kbs.bwd_res(tables, cfg, g, k6, resf, resi),
             kbs.bwd_replay(tables, cfg, o, d, 3, si, pix, g, k5))
    assert len(k7) == 4 + texp + 3
    for got, ref, rep in zip((k7, k8), refs, again):
        for a, b, c in zip(got, ref, rep):
            assert torch.equal(a, b) and torch.equal(a, c)
    for a, b in zip(k8, k7):
        b = b.cpu().numpy()
        np.testing.assert_allclose(a.cpu().numpy(), b, rtol=2e-3,
                                   atol=2e-5 * max(1.0, np.abs(b).max()))
    assert all(float(t.abs().max()) > 0 for t in k7[-3:])


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["cornell_forced", "spheres300"])
def test_row_tagged_backwards_on_card(cuda, scene, monkeypatch):
    """K3 and K4 on their row-tagged route (past 64 surfaces, or forced on
    the Cornell box) against their plain versions: equal to the last bit,
    repeating bit for bit, K4 within the reference's 2e-3 bound of K3; past
    255 surfaces the rows above 255 are live."""
    if scene == "cornell_forced":
        monkeypatch.setattr(kwf, "DENSE_MAX_ROWS", 0)
        sc = builders.cornell_box(width=64, height=64).to(cuda)
    else:
        sc = builders.random_spheres(n=300, width=64, height=64).to(cuda)
    o, d, si, pix = _card_lanes(sc, cuda, n=4096)
    cfg = kwf.KernelConfig(max_depth=3, sampler="hash",
                           trainable_exponent=True)
    tables = kwf.pack_tables(sc, cfg)
    assert kwf.row_tagged(tables.static)
    k1 = kwf.trace_lanes(tables, cfg, o, d, 3, si, pix)
    k2, resf, resi = kwf.trace_lanes(tables, cfg, o, d, 3, si, pix,
                                     residual=True)
    g = torch.randn(o.shape, generator=torch.Generator(cuda).manual_seed(1),
                    device=cuda)
    k3 = kwf.bwd_res(tables, cfg, g, k2, resf, resi)
    k4 = kwf.bwd_replay(tables, cfg, o, d, 3, si, pix, g, k1)
    refs = (kwf.bwd_res_plain(tables, cfg, g, k2, resf, resi),
            kwf.bwd_replay_plain(tables, cfg, o, d, 3, si, pix, g, k1))
    again = (kwf.bwd_res(tables, cfg, g, k2, resf, resi),
             kwf.bwd_replay(tables, cfg, o, d, 3, si, pix, g, k1))
    for got, ref, rep in zip((k3, k4), refs, again):
        for a, b, c in zip(got, ref, rep):
            assert torch.equal(a, b) and torch.equal(a, c)
    for a, b in zip(k4, k3):
        b = b.cpu().numpy()
        np.testing.assert_allclose(a.cpu().numpy(), b, rtol=2e-3,
                                   atol=2e-5 * max(1.0, np.abs(b).max()))
    if scene == "spheres300":
        assert int((kwf.unpack_row(resi) - 1).max()) > 255
        assert bool((k3[0][256:].abs().sum(-1) > 0).any())
