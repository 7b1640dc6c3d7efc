"""The CUDA megakernels (K1-K4, with the row-tagged backwards past 64
surfaces, and the big-scene K5-K8, with textures; every sampler, both
exponent modes) against their plain PyTorch versions, on the card. Needs a
CUDA device and nvcc; skipped elsewhere. Run on the card with

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py -q

(the suite's conftest imports jax, which the card's machine does not need)."""

import numpy as np
import pytest
import torch

from kytpu_torch.kernels import tag_sums as kts
from kytpu_torch.kernels import wavefront as kwf
from kytpu_torch.scene import builders
from kytpu_torch.scene.scene import generate_rays
from kytpu_torch.utils import profiling as kprof

ALL_LIGHTS = {builders.LARGE_GLASS_SPHERE, builders.LIGHT_POINT,
              builders.LIGHT_DIRECTION, builders.LIGHT_ENVIRONMENT}


def many_lights(b, n_lights: int, width: int = 24, height: int = 16,
                n_checkers: int = 0, extra_spheres: int = 0):
    """A matte floor and a glossy back wall lit by a point light and
    n_lights - 1 small sphere lights in a row, built with the builders
    module `b` (kytpu's or the port's, which share the assembler's API).
    The last sphere is light n_lights - 1, so at 32 lights its skip bit is
    the table's sign bit. n_checkers > 0 tiles the floor with that many
    quads, each with a checker texture of its own; extra_spheres adds a
    row of matte spheres in front of the lights (to pass 64 surfaces)."""
    A = b._SceneAssembler
    a = A()
    g = a.geo
    if n_checkers:
        k = int(np.ceil(np.sqrt(n_checkers)))
        step = 20.0 / k
        for t in range(n_checkers):
            x0, z0 = -10 + step * (t % k), -10 + step * (t // k)
            x1, z1 = x0 + step, z0 + step
            c = 0.2 + 0.6 * ((np.arange(3) + t) % 3) / 2
            tex = a.add_checker(np.float32(c), np.float32(1.0 - c),
                                scale=(2.0, 2.0))
            a.surface(g.add_rectangle((x0, -2, z1), (x0, -2, z0),
                                      (x1, -2, z0), (x1, -2, z1),
                                      flip_normal=True),
                      A.matte(np.full(3, 0.5, np.float32), texture=tex))
    else:
        a.surface(g.add_rectangle((-10, -2, 10), (-10, -2, -10),
                                  (10, -2, -10), (10, -2, 10),
                                  flip_normal=True),
                  A.matte(np.full(3, 0.5, np.float32)))
    for k in range(extra_spheres):
        c = (-4.5 + 9.0 * k / max(extra_spheres - 1, 1), -1.5, -1.0)
        a.surface(g.add_sphere(c, 0.2),
                  A.matte(np.float32([0.3 + 0.4 * (k % 2), 0.5, 0.4])))
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


def launched(*kernels):
    """The launch counters of `kernels` (k1 ... k8)."""
    return tuple(kprof.launches(k) for k in kernels)


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
    before = kprof.launches("k1")
    got = kwf.render_lanes_cuda(sc, o, d, 3, cfg, si, pix)
    torch.cuda.synchronize()
    assert kprof.launches("k1") == before + 1
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
    counts = launched("k1", "k2", "k3")
    k1 = kwf.trace_lanes(tables, cfg, o, d, 3, si, pix)
    k2, resf, resi = kwf.trace_lanes(tables, cfg, o, d, 3, si, pix,
                                     residual=True)
    g = torch.randn(o.shape, generator=torch.Generator(cuda).manual_seed(1),
                    device=cuda)
    grads = kwf.bwd_res(tables, cfg, g, k2, resf, resi)
    again = kwf.bwd_res(tables, cfg, g, k2, resf, resi)
    torch.cuda.synchronize()
    assert launched("k1", "k2", "k3") == (
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
    before = launched("k2", "k3")
    losses = [float(step(krng.fold_in(krng.key(0), i))) for i in range(3)]
    assert launched("k2", "k3") == (before[0] + 3, before[1] + 3)
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
    counts = launched("k1", "k2", "k3", "k4")
    k1 = kwf.trace_lanes(tables, cfg, o, d, 3, si, pix)
    k2, resf, resi = kwf.trace_lanes(tables, cfg, o, d, 3, si, pix,
                                     residual=True)
    g = torch.randn(o.shape, generator=torch.Generator(cuda).manual_seed(1),
                    device=cuda)
    k3 = kwf.bwd_res(tables, cfg, g, k2, resf, resi)
    k4 = kwf.bwd_replay(tables, cfg, o, d, 3, si, pix, g, k1)
    again = kwf.bwd_replay(tables, cfg, o, d, 3, si, pix, g, k1)
    torch.cuda.synchronize()
    assert launched("k1", "k2", "k3", "k4") == (
        counts[0] + 1, counts[1] + 1, counts[2] + 1, counts[3] + 2)
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
    before = launched("k1", "k4")
    out = tracer(*leaves, env, o, d, 3, si, pix)
    out.sum().backward()
    torch.cuda.synchronize()
    assert launched("k1", "k4") == (before[0] + 1, before[1] + 1)
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
    counts = launched("k5", "k6", "k7")
    k5 = kbs.trace_lanes(tables, cfg, o, d, 3, si, pix)
    k6, resf, resi = kbs.trace_lanes(tables, cfg, o, d, 3, si, pix,
                                     residual=True)
    g = torch.randn(o.shape, generator=torch.Generator(cuda).manual_seed(1),
                    device=cuda)
    grads = kbs.bwd_res(tables, cfg, g, k6, resf, resi)
    again = kbs.bwd_res(tables, cfg, g, k6, resf, resi)
    torch.cuda.synchronize()
    assert launched("k5", "k6", "k7") == (
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
    small = launched("k1", "k2", "k3", "k4")
    before = kprof.launches("k5")
    target = render(sc, spp=4, seed=2, clamp=False, device=cuda)
    assert kprof.launches("k5") == before + 1
    assert bool(torch.isfinite(target).all())
    step, params, _ = make_train_step(sc, target, spp=2, max_depth=2,
                                      kernel_sampler="hash")
    before = launched("k6", "k7")
    losses = [float(step(krng.fold_in(krng.key(0), i))) for i in range(2)]
    assert launched("k6", "k7") == (before[0] + 2, before[1] + 2)
    assert small == launched("k1", "k2", "k3", "k4")
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
    before = kprof.launches("k8")
    k8 = kbs.bwd_replay(tables, cfg, o, d, 3, si, pix, g, k5)
    again = kbs.bwd_replay(tables, cfg, o, d, 3, si, pix, g, k5)
    torch.cuda.synchronize()
    assert kprof.launches("k8") == before + 2
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
    counts = launched("k5", "k6", "k8")
    exp = (tables.exponent,) if texp else ()
    out = tracer(*leaves, *exp, tables.env, o, d, 3, si, pix)
    out.backward(g)
    assert launched("k5", "k6", "k8") == (
        counts[0] + 1, counts[1], counts[2] + 1)
    for leaf, a in zip(leaves, k8):
        assert torch.equal(leaf.grad, a)


@pytest.mark.cuda
@pytest.mark.parametrize("scene, sampler, shadow", [
    ("spheres", "hash", "robust"), ("mesh", "sobol", "parity")])
def test_bigscene_cull_matches_off_on_card(cuda, scene, sampler, shadow):
    """K5, K6 and K8 with the block cull (cfg.cull "cone", the default)
    equal to the same kernels with cull="off", to the last bit: the cull
    skips only blocks that no lane's ray can meet."""
    import dataclasses

    from kytpu_torch.kernels import bigscene as kbs
    from kytpu_torch.scene import mesh

    sc = (builders.random_spheres(n=300, width=64, height=64)
          if scene == "spheres"
          else builders.mesh_scene(*mesh.icosphere(2), width=64, height=64)
          ).to(cuda)
    o, d, si, pix = _card_lanes(sc, cuda)
    cfg = kwf.KernelConfig(max_depth=3, sampler=sampler, shadow=shadow)
    off = dataclasses.replace(cfg, cull="off")
    tables = kbs.pack_big_tables(sc, cfg)
    g = torch.randn(o.shape, generator=torch.Generator(cuda).manual_seed(2),
                    device=cuda)
    k5 = kbs.trace_lanes(tables, cfg, o, d, 3, si, pix)
    assert torch.equal(k5, kbs.trace_lanes(tables, off, o, d, 3, si, pix))
    for a, b in zip(kbs.trace_lanes(tables, cfg, o, d, 3, si, pix,
                                    residual=True),
                    kbs.trace_lanes(tables, off, o, d, 3, si, pix,
                                    residual=True)):
        assert torch.equal(a, b)
    for a, b in zip(kbs.bwd_replay(tables, cfg, o, d, 3, si, pix, g, k5),
                    kbs.bwd_replay(tables, off, o, d, 3, si, pix, g, k5)):
        assert torch.equal(a, b)


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
    # K3's lane row in a shared block and in local memory: the same bits
    assert kwf.acc_route(tables, cfg) == "shared"
    monkeypatch.setattr(kwf, "ACC_BUDGET", 0)
    for a, b in zip(kwf.bwd_res(tables, cfg, g, k2, resf, resi), k3):
        assert torch.equal(a, b)
    for a, b in zip(k4, k3):
        b = b.cpu().numpy()
        np.testing.assert_allclose(a.cpu().numpy(), b, rtol=2e-3,
                                   atol=2e-5 * max(1.0, np.abs(b).max()))
    if scene == "spheres300":
        assert int((kwf.unpack_row(resi) - 1).max()) > 255
        assert bool((k3[0][256:].abs().sum(-1) > 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["zeros", "ground", "rows", "texels",
                                  "ragged"])
def test_tag_sort_and_sums_on_card(cuda, kind):
    """csrc/tag_sums.cu: the int32 radix sort gives torch.sort(stable=
    True)'s perm and starts to the last index, and the split segment sums
    equal segment_sums_plain bit for bit and repeat."""
    from tests.test_torch_tag_sums import tag_set
    tags, m_tags, mask, _ = tag_set(kind)
    tags = torch.from_numpy(tags).to(cuda)
    perm, starts = kts.tag_sort(tags, m_tags, mask)
    want_perm, want_starts = kts.sort_tags(tags, m_tags, mask)
    assert perm.dtype == starts.dtype == torch.int32
    assert torch.equal(perm.long(), want_perm)
    assert torch.equal(starts.long(), want_starts)
    J, n = tags.shape
    B, PB = (J, 3) if kind == "texels" else (J - 1, 9)
    planes = PB * J if PB == 3 else PB * B + 3
    dout = torch.randn((planes, n), device=cuda,
                       generator=torch.Generator(cuda).manual_seed(2))
    got = kts.seg_sums(dout, perm, starts, n, B, PB)
    assert torch.equal(got, kts.segment_sums_plain(dout, want_perm,
                                                   want_starts, n, B, PB))
    assert torch.equal(got, kts.seg_sums(dout, perm, starts, n, B, PB))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["random", "hash"])
@pytest.mark.parametrize("n", [10_092_544, 946_176, 946_176 + 77])
def test_camera_rays_kernel_on_card(cuda, mode, n):
    """csrc/camera_rays.cu: the kernel's rays equal the plain chain's run on
    the card, bit for bit, at the train step's lanes (Veach 512x308, 64
    spp), a frame pass's (6 spp) and a count that is not a multiple of the
    block; "hash" at sample base 6 (a frame's second pass). One launch,
    counted."""
    from kytpu_torch.core import rng as krng
    from kytpu_torch.kernels import camera as kcam

    cam = builders.veach_mis(512, 308).to(cuda).camera
    npix = 512 * 308
    words = krng.words(krng.fold_in(krng.key(2**31 + 11), 5))
    base = 6 if mode == "hash" else 0
    before = kprof.launches("rays")
    o, d = kcam.lane_rays(cam, words, n, npix, mode, base)
    torch.cuda.synchronize()
    assert kprof.launches("rays") == before + 1
    want_o, want_d = kcam.lane_rays_plain(cam, words, n, npix, mode, base)
    assert d.shape == (n, 3) and d.dtype == torch.float32
    assert torch.equal(o, want_o)
    assert torch.equal(d.view(torch.int32), want_d.view(torch.int32))


@pytest.mark.cuda
def test_camera_rays_launches_on_card(cuda):
    """kernel.rays.launches: one a frame pass (11 a frame of Veach 512x308
    at 64 spp, 1M lanes a pass) and one a train step under "random" and
    "hash"; the sobol sampler launches none."""
    from kytpu_torch.core import rng as krng
    from kytpu_torch.diff.inverse import make_train_step
    from kytpu_torch.integrator.render import render

    veach = builders.veach_mis(512, 308)
    kprof.reset("rays")
    render(veach, spp=64, seed=3, rays_per_pass=1 << 20, device=cuda)
    assert kprof.launches("rays") == 11
    kprof.reset("rays")
    render(veach, spp=8, seed=3, cfg=kwf.KernelConfig(sampler="sobol"),
           device=cuda)
    assert kprof.launches("rays") == 0
    sc = builders.cornell_box(width=32, height=32)
    target = render(sc, spp=4, seed=2, clamp=False, device=cuda)
    for sampler, per_step in (("random", 1), ("hash", 1), ("sobol", 0)):
        step, _, _ = make_train_step(sc, target, spp=2,
                                     kernel_sampler=sampler)
        kprof.reset("rays")
        for i in range(3):
            step(krng.fold_in(krng.key(0), i))
        assert kprof.launches("rays") == 3 * per_step, sampler


@pytest.mark.cuda
def test_frame_reuses_its_tables_on_card(cuda, monkeypatch):
    """Veach's second frame on the card (the scene on the card, as the
    benchmark renders it) reads the key of its tables in one synchronising
    copy and packs nothing, launches K1 as often as the first frame, which
    packed, and gives that frame's bits; a frame with an empty cache, too."""
    from torch.profiler import ProfilerActivity, profile

    from kytpu_torch.integrator.render import render
    from kytpu_torch.kernels import route as kroute

    monkeypatch.setattr(kroute, "_frames", [])
    sc = builders.veach_mis(128, 77).to(cuda)
    frame = dict(spp=8, seed=9, rays_per_pass=128 * 77 * 2, device=cuda)
    k1 = kprof.launches("k1")
    first = render(sc, **frame)
    per_frame = kprof.launches("k1") - k1
    assert per_frame == 4
    with kprof.span("kytpu::unrecorded"):
        pass
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        second = render(sc, **frame)
    assert kprof.launches("k1") - k1 == 2 * per_frame
    recs = kprof.spans()
    tables = {i for i, r in enumerate(recs)
              if r.name.startswith("kytpu::tables.")}
    assert "kytpu::tables.pack" not in {recs[i].name for i in tables}
    syncs = 0
    for i, r in enumerate(recs):
        up, p = {i}, r.parent
        while p is not None:
            up.add(p)
            p = recs[p].parent
        syncs += r.syncs if up & tables else 0
    assert syncs <= 1
    assert torch.equal(second, first)
    kroute._frames.clear()
    assert torch.equal(render(sc, **frame), first)
