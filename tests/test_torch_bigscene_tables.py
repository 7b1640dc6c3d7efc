"""The host side of the port's big-scene kernels against kytpu's, and the
plain versions' routing and algebra on the CPU (kernels/bigscene.py).

- scene/mesh.py and the builders random_spheres / mesh_scene: bit-identical
  arrays and scene tables;
- extract_tables (Morton order, block bounds, global rows, table_of_row)
  and the cache layout: equal to kytpu's on random spheres, an icosphere
  mesh and the Cornell box;
- routing, kytpu's rule: render() and make_train_step() past 64 surfaces
  take the big-scene tracers where the tables take the scene (textured
  ones included) and K1-K4 where they do not (a rect that is not a
  parallelogram, an atlas past their select chain), each scene routed as
  kytpu's `extract_tables` decides; engine="bigscene" works at any size
  and raises for what the tables do not take; more than 32 lights raise;
- the plain K5 against the plain K1 on scenes both take (kytpu's own
  bound: different sweep arithmetic, so within 1e-3, test_bigscene.py:129);
- the plain K7 against central finite differences of the plain K5 (step
  1e-2, |ad - fd| <= 3e-3 max(|fd|, 1e-2), the bound of
  tests/test_kernel.py's replay check), and its sums by row against
  float64 sums.
"""

import jax
import numpy as np
import pytest
import torch

from kytpu.kernels import bigscene as jbs
from kytpu.scene import builders as jb
from kytpu.scene import mesh as jm
from kytpu_torch.core import rng as trng
from kytpu_torch.diff import inverse as tinv
from kytpu_torch.integrator.render import render
from kytpu_torch.kernels import bigscene as kbs
from kytpu_torch.kernels import route as kroute
from kytpu_torch.kernels import cull as kcull
from kytpu_torch.kernels import wavefront as kwf
from kytpu_torch.scene import builders as tb
from kytpu_torch.scene import mesh as tm
from kytpu_torch.scene.scene import generate_rays
from tests.test_torch_bigscene_texture_train import checker_scene
from tests.test_torch_cuda import many_lights
import tests.torch_threads  # noqa: F401  (one torch thread a process)

SCENE_FIELDS = ("mat_kind", "mat_diffuse", "mat_specular", "mat_exponent",
                "mat_eta", "mat_d_prob", "mat_s_prob", "emission",
                "light_index", "world_center", "world_radius",
                "env_radiance_")
GEO_FIELDS = ("pl_kind", "pl_p0", "pl_p1", "pl_p2", "pl_p3", "pl_normal",
              "pl_radius", "pl_area", "sp_center", "sp_radius", "sp_area")
LIGHT_FIELDS = ("emit", "position", "direction", "p0", "p1", "p2", "p3",
                "normal", "area", "center", "radius")

# a mesh with a degenerate (zero-area) face among 72
_VERTS, _FACES = jm.torus(nu=6, nv=6)
_FACES = np.concatenate([_FACES, [[0, 0, 1]]]).astype(np.int32)

BUILDS = {
    "spheres": lambda b: b.random_spheres(n=80, width=16, height=12, seed=3),
    "icosphere": lambda b: b.mesh_scene(*jm.icosphere(2), width=12,
                                        height=12),
    "degenerate": lambda b: b.mesh_scene(_VERTS, _FACES, width=8, height=8,
                                         light_scale=2.0),
    "cornell": lambda b: b.cornell_box(width=8, height=8),
}


@pytest.mark.parametrize("name", ["icosphere", "torus", "obj"])
def test_mesh_module_matches_kytpu(name):
    if name == "obj":
        src = ("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n# quad\n"
               "f 1/1 2/2 3/3 4/4\nf -1 -2 -3\n")
        pairs = [(jm.load_obj(src), tm.load_obj(src))]
    elif name == "torus":
        pairs = [(jm.torus(1.5, 0.4, 7, 5, (1, 2, 3)),
                  tm.torus(1.5, 0.4, 7, 5, (1, 2, 3)))]
    else:
        pairs = [(jm.icosphere(s, (0.5, 0, 1), 2.0),
                  tm.icosphere(s, (0.5, 0, 1), 2.0)) for s in range(3)]
    for (jv, jf), (tv, tf) in pairs:
        np.testing.assert_array_equal(jv, tv)
        np.testing.assert_array_equal(jf, tf)
        assert jv.dtype == tv.dtype and jf.dtype == tf.dtype
        for a, b in zip(jm.mesh_bounds(jv), tm.mesh_bounds(tv)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            jm.transform_mesh(jv, 1.5, 0.3, (1, 0, -1)),
            tm.transform_mesh(tv, 1.5, 0.3, (1, 0, -1)))


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_builders_and_tables_match_kytpu(name):
    jsc, tsc = BUILDS[name](jb), BUILDS[name](tb)
    for f in SCENE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jsc, f)),
                                      getattr(tsc, f).numpy(), err_msg=f)
    for f in GEO_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jsc.geometry, f)),
                                      getattr(tsc.geometry, f).numpy(),
                                      err_msg=f)
    for f in LIGHT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jsc.lights, f)),
                                      getattr(tsc.lights, f).numpy(),
                                      err_msg=f)
    assert tuple(jsc.lights.kinds) == tsc.lights.kinds
    assert tuple(jsc.lights.surface_ids) == tsc.lights.surface_ids
    for f in ("position", "front", "right", "up"):
        np.testing.assert_array_equal(np.asarray(getattr(jsc.camera, f)),
                                      getattr(tsc.camera, f).numpy())
    jstatic, jtab = jbs.extract_tables(jsc)
    tstatic, ttab = kbs.extract_tables(tsc)
    for k in kbs.CLASSES:
        for a, b in zip(jtab[k], ttab[k]):
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)
    assert jstatic["table_of_row"] == tstatic["table_of_row"]
    if name == "degenerate":
        assert len(tsc.mat_kind) == len(_FACES) - 1 + 2   # + ground, light
    for texp in (False, True):
        cfg = kwf.KernelConfig(max_depth=3, trainable_exponent=texp)
        jcfg = jbs.wf.KernelConfig(max_depth=3, trainable_exponent=texp)
        n_l = len(tstatic["lights"])
        assert kbs.bigres_layout(cfg, n_l, tsc.has_env) == \
            jbs._bigres_layout(jcfg, n_l, jsc.has_env)


def test_morton_and_block_bounds_match_kytpu():
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(37, 3))
    lo, hi = pts.min(0), pts.max(0)
    np.testing.assert_array_equal(jbs._morton3(pts, lo, hi),
                                  kcull.morton3(pts, lo, hi))
    radii = rng.random(37)
    np.testing.assert_array_equal(jbs._block_bounds(pts, radii),
                                  kcull.block_bounds(pts, radii))
    a = rng.random((13, 4)).astype(np.float32)
    np.testing.assert_array_equal(jbs._pad_rows(a), kbs._pad_rows(a))


def test_render_routes_past_64_surfaces():
    """Past 64 surfaces render() runs the big-scene tracer with render's own
    pass size (1 << 20 lanes); engine="bigscene" runs it at any size."""
    big = tb.random_spheres(n=80, width=8, height=6)
    cfg = kwf.KernelConfig(max_depth=2)
    img = render(big, spp=2, seed=5, cfg=cfg, device="cpu")
    ref = kbs.render_bigscene(big, spp=2, seed=5, cfg=cfg,
                              rays_per_pass=1 << 20)
    np.testing.assert_array_equal(img.numpy(), ref.numpy())
    small = tb.cornell_box(width=8, height=6)
    img = render(small, spp=2, seed=5, cfg=cfg, engine="bigscene",
                 device="cpu")
    ref = kbs.render_bigscene(small, spp=2, seed=5, cfg=cfg,
                              rays_per_pass=1 << 20)
    np.testing.assert_array_equal(img.numpy(), ref.numpy())


def test_train_step_routes_past_64_surfaces(monkeypatch):
    seen = []
    for mod, nm in ((kbs, "make_bigscene_diff_tracer"),
                    (kwf, "make_cuda_diff_tracer")):
        real = getattr(mod, nm)
        monkeypatch.setattr(mod, nm, lambda *a, real=real, nm=nm, **k: (
            seen.append(nm), real(*a, **k))[1])
    for sc in (tb.random_spheres(n=80, width=4, height=4),
               tb.cornell_box(width=4, height=4)):
        tinv.make_train_step(sc, np.zeros((4, 4, 3), np.float32),
                             device="cpu", kernel_sampler="sobol",
                             names=("mat_diffuse", "mat_exponent"))
    assert seen == ["make_bigscene_diff_tracer", "make_cuda_diff_tracer"]


def test_scenes_the_tables_do_not_take_raise():
    """Scenes past 64 surfaces that the port refused before the table
    kernels took textures and K1-K4 took any surface count: they render
    and train now, on the route kytpu takes, past 32 lights too. What
    still raises: a rect that is not a parallelogram under
    engine="bigscene"."""
    # a textured scene past 64 surfaces (kytpu's): the textured table kernels
    tex_sc = checker_scene(tb)
    img = render(tex_sc, spp=1, seed=5, device="cpu")
    ref = kbs.render_bigscene(tex_sc, spp=1, seed=5, rays_per_pass=1 << 20)
    np.testing.assert_array_equal(img.numpy(), ref.numpy())
    step, params, _ = tinv.make_train_step(
        tex_sc, np.zeros((8, 8, 3), np.float32), spp=1, max_depth=1,
        device="cpu", names=("tex_color_a",))
    assert set(params) == {"tex_color_a"}
    assert np.isfinite(float(step(trng.key(0))))
    # a rect that is not a parallelogram, past 64 surfaces: K1
    sc = checker_scene(tb, ground="plain", parallelogram=False)
    img = render(sc, spp=1, seed=5, device="cpu")
    ref = kwf.render_cuda(sc, spp=1, seed=5, rays_per_pass=1 << 20)
    np.testing.assert_array_equal(img.numpy(), ref.numpy())
    assert float(img.mean()) > 0
    with pytest.raises(NotImplementedError, match="parallelogram"):
        render(sc, spp=1, engine="bigscene", device="cpu")
    # past 32 lights: 71 surfaces, 70 lights render on K5 (kytpu's route)
    sc = many_lights(tb, 70, 12, 8)
    img = render(sc, spp=1, seed=5, device="cpu")
    ref = kbs.render_bigscene(sc, spp=1, seed=5, rays_per_pass=1 << 20)
    np.testing.assert_array_equal(img.numpy(), ref.numpy())
    assert float(img.mean()) > 0


ROUTES = {   # scene -> (kytpu's kernel family, and so the port's)
    "cornell_textured": lambda b: b.cornell_box(width=8, height=8,
                                                floor_checker=True),
    "spheres": lambda b: b.random_spheres(n=80, width=8, height=8),
    "checker_past_64": lambda b: checker_scene(b),
    "atlas16_past_64": lambda b: checker_scene(b, image=_IMG16),
    "rect_past_64": lambda b: checker_scene(b, ground="plain",
                                            parallelogram=False),
}
_IMG16 = np.random.default_rng(5).uniform(0.1, 0.9, (16, 16, 3)).astype(
    np.float32)


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_routing_matches_kytpu(name, monkeypatch):
    """render() and make_train_step() pick the kernel family kytpu's rule
    picks: the table kernels past 64 surfaces where kytpu's
    `extract_tables` takes the scene, else the baked ones (K1-K4)."""
    jsc, tsc = ROUTES[name](jb), ROUTES[name](tb)
    try:
        jbs.extract_tables(jsc)
        tables = int(jsc.mat_kind.shape[0]) > 64
    except NotImplementedError:
        tables = False
    # the builders that returned (make_train_step, as kytpu's, tries the
    # table kernels' tracer past 64 surfaces and takes K2/K3 on a refusal)
    seen = []
    for mod, nm in ((kbs, "make_bigscene_diff_tracer"),
                    (kwf, "make_cuda_diff_tracer"),
                    (kbs, "make_bigscene_tracer"),
                    (kwf, "make_cuda_tracer"), (kwf, "render_cuda")):
        real = getattr(mod, nm)
        monkeypatch.setattr(mod, nm, lambda *a, real=real, nm=nm, **k: (
            real(*a, **k), seen.append(nm))[0])
    render(tsc, spp=1, cfg=kwf.KernelConfig(max_depth=1), device="cpu")
    names = (("tex_color_a", "tex_color_b") if tsc.has_textures
             else ("mat_diffuse",))
    tinv.make_train_step(tsc, np.zeros((8, 8, 3), np.float32), max_depth=1,
                         device="cpu", names=names)
    # a frame runs its passes through render_cuda with its family's tracer
    assert seen == (["make_bigscene_tracer", "render_cuda",
                     "make_bigscene_diff_tracer"] if tables
                    else ["make_cuda_tracer", "render_cuda",
                          "make_cuda_diff_tracer"])


@pytest.mark.parametrize("engine", ["cuda", "bigscene"])
@pytest.mark.parametrize("name", sorted(ROUTES))
def test_router_matches_kytpu(name, engine, monkeypatch):
    """kernels/route.py picks the family kytpu's rule picks, the constructors
    it calls looked up on their modules: under engine="cuda" the table
    kernels past 64 surfaces where kytpu's `extract_tables` takes the scene
    (no extraction at or below 64 surfaces), else K1-K4; under
    engine="bigscene" the table kernels wherever `extract_tables` takes
    the scene, and its refusal raised."""
    jsc, tsc = ROUTES[name](jb), ROUTES[name](tb)
    try:
        jbs.extract_tables(jsc)
        takes = True
    except NotImplementedError:
        takes = False
    past = int(jsc.mat_kind.shape[0]) > 64
    seen = []
    for mod, nm in ((kbs, "extract_tables"), (kbs, "make_bigscene_tracer"),
                    (kwf, "make_cuda_tracer")):
        real = getattr(mod, nm)
        monkeypatch.setattr(mod, nm, lambda *a, real=real, nm=nm, **k: (
            seen.append(nm), real(*a, **k))[1])
    cfg = kwf.KernelConfig(max_depth=1)
    if engine == "bigscene" and not takes:
        with pytest.raises(NotImplementedError):
            kroute.tracer(tsc, cfg, engine)
        return
    kroute.tracer(tsc, cfg, engine)
    if engine == "bigscene" or (takes and past):
        assert seen == ["extract_tables", "make_bigscene_tracer"]
    else:
        assert seen == (["extract_tables"] if past else []) + [
            "make_cuda_tracer"]


def _lanes(sc, n, seed=0):
    w, h = sc.camera.width, sc.camera.height
    rng = np.random.default_rng(seed)
    pix = np.arange(n) % (w * h)
    pf = np.stack([pix % w + rng.random(n), pix // w + rng.random(n)], -1)
    o, d = generate_rays(sc.camera, torch.tensor(pf, dtype=torch.float32))
    return (o, d, torch.tensor(np.arange(n) // (w * h), dtype=torch.int32),
            torch.tensor(pix, dtype=torch.int32))


@pytest.mark.parametrize("scene", ["spheres24", "cornell_lights"])
def test_k5_matches_k1_where_both_run(scene):
    """The same draws through two sweeps of different arithmetic (kytpu's
    test_bigscene_matches_baked_same_draws): within 1e-3 on all but 0.5%
    of the lanes (a near-tie may pick another surface)."""
    sc = (tb.random_spheres(n=24, width=24, height=24, seed=0)
          if scene == "spheres24" else
          tb.cornell_box(tb.DEFAULT_SCENE | {tb.LIGHT_POINT,
                                             tb.LIGHT_ENVIRONMENT},
                         width=24, height=24))
    o, d, si, pix = _lanes(sc, 2048)
    for sampler in ("random", "sobol"):
        cfg = kwf.KernelConfig(max_depth=3, rows=8, sampler=sampler)
        big = kbs.trace_lanes(kbs.pack_big_tables(sc, cfg), cfg, o, d, 3, si,
                              pix).numpy()
        k1 = kwf.trace_lanes(kwf.pack_tables(sc, cfg), cfg, o, d, 3, si,
                             pix).numpy()
        assert np.isfinite(big).all()
        assert (np.abs(big - k1) > 1e-3).any(-1).mean() <= 0.005


def test_k7_matches_finite_differences():
    sc = tb.random_spheres(n=80, width=16, height=16, seed=1)
    cfg = kwf.KernelConfig(max_depth=2, rows=8, sampler="hash",
                           shadow="robust")
    n = 1024
    o, d, si, pix = _lanes(sc, n, 5)
    wts = torch.tensor(np.random.default_rng(6).random((n, 3)),
                       dtype=torch.float32)
    tracer = kbs.make_bigscene_diff_tracer(sc, cfg)
    p0 = [sc.mat_diffuse, sc.mat_specular, sc.emission, sc.env_radiance_]

    def loss(*p):
        return (tracer(*p, o, d, 9, si, pix) * wts).sum() / n

    leaves = [t.clone().requires_grad_() for t in p0]
    loss(*leaves).backward()
    light = sc.lights.surface_ids[0]
    kinds = sc.mat_kind.tolist()
    hits = np.bincount(kbs.trace_lanes(kbs.pack_big_tables(sc, cfg), cfg, o,
                                       d, 9, si, pix, residual=True)[2][0]
                       .numpy(), minlength=len(kinds) + 1)[1:]
    matte = max((r for r in range(1, len(kinds)) if kinds[r] == 0),
                key=lambda r: hits[r])
    mirror = max((r for r in range(len(kinds)) if kinds[r] == 1),
                 key=lambda r: hits[r])
    probes = [(0, (0, 0)), (0, (0, 2)), (0, (matte, 1)), (1, (mirror, 0)),
              (2, (light, 0)), (3, (2,))]
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
        assert abs(fd) > 1e-4, (argi, idx, fd)


def test_segment_sums_are_sums():
    """The sums by row are sums (against float64), over rows of 0, 1 and
    more than SEG_THREADS entries, at depth 2 (PB = 9) and with the
    exponent column (PB = 10)."""
    rng = np.random.default_rng(2)
    n, M = 700, 6
    for texp in (False, True):
        cfg = kwf.KernelConfig(max_depth=2, trainable_exponent=texp)
        B, PB = cfg.max_depth, kbs._per_bounce(cfg)
        dout = torch.tensor(rng.standard_normal((PB * B + 3, n)),
                            dtype=torch.float32)
        ids = rng.choice([0, 1, 2, 4, 6], size=(B + 1, n),
                         p=[0.2, 0.5, 0.2, 0.099, 0.001 * 1.0])
        ids[0, 0] = 6
        resi = torch.tensor(ids | (rng.integers(0, 4, ids.shape) << 20),
                            dtype=torch.int32)
        perm, starts = kbs.sort_rows(resi, M)
        got = kbs.segment_sums_plain(dout, perm, starts, n, B, PB).numpy()
        want = np.zeros((M, PB))
        dn = dout.double().numpy()
        for b in range(B + 1):
            for i in range(n):
                m = ids[b, i]
                if m == 0:
                    continue
                if b < B:
                    want[m - 1] += dn[PB * b:PB * b + PB, i]
                else:
                    want[m - 1, 6:9] += dn[PB * B:PB * B + 3, i]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
        assert (got[2] == 0).all() and (got[4] == 0).all()
