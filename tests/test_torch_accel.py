"""The port's uniform-grid accelerator (kytpu_torch/scene/accel.py)
against kytpu's and against the port's own sweep: the bake bit for bit,
closest and any hits through the DDA, Scene.occluded_from's route through
it, the numpy bridge, the builders' accel= and a fast-mode and a path-mode
frame through the grid.

Tolerance: the grid tables, lo, inv_h, h and dims bit for bit. Hits
(kytpu's rule for the grid against the sweep, tests/test_accel.py): valid
equal on every ray, t within rtol 1e-5 on hits, surface rows equal on more
than 99.9% of hits (ties), any-hit equal on more than 99.9% of rays. On a
triangle mesh kytpu's jitted triangle test drops hits (ROADMAP §3, "XLA CPU
rounding"; tests/test_torch_shapes.py): there every lane equals kytpu's
but lanes where the port hits a triangle that kytpu drops. Frames: against
kytpu rtol 1e-3/atol 1e-4 on more than 99.9% of values (the jnp engines'
bound), against the port's sweep atol 1e-4 on more than 99.9% (kytpu's
grid-against-sweep frame test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kytpu.integrator.fast import FastConfig
from kytpu.integrator.path import PathConfig
from kytpu.scene import accel as jaccel
from kytpu.scene import builders as jb
from kytpu.scene import mesh as jmesh
from kytpu.scene import scene as jscene
from kytpu_torch.scene import accel as taccel
from kytpu_torch.scene import builders as tb
from kytpu_torch.scene import mesh as tmesh
from kytpu_torch.scene import scene as tscene
from kytpu_torch.scene import shapes as tshapes
from kytpu_torch.scene.scene import scene_from_numpy
from tests.test_torch_scene import assert_same_tables
from tests.test_torch_shapes import _agree_but_triangle
from tests.torch_jnp import jrender, port_cfg, trender
import tests.torch_threads  # noqa: F401  (one torch thread a process)

N = 4096
SCENES = {
    "spheres": lambda b, **kw: b.random_spheres(60, seed=3, **kw),
    "icosphere": lambda b, **kw: b.mesh_scene(
        *(jmesh if b is jb else tmesh).icosphere(1), **kw),
}


def _random_rays(n, rng, lo=-15.0, hi=15.0):
    """kytpu's rays (tests/test_accel.py) as numpy."""
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.mark.parametrize("name", list(SCENES))
def test_bake_bit_identical(name):
    ref = jax.device_get(jaccel.build_grid(SCENES[name](jb,
                                                        accel=None).geometry))
    got = taccel.build_grid(SCENES[name](tb).geometry)
    assert_same_tables(ref, got, "grid")
    assert got.n_cells == int(np.prod(got.dims)) > 1


@pytest.mark.parametrize("name", list(SCENES))
def test_closest_hit_matches_kytpu_and_the_sweep(name):
    jg = SCENES[name](jb, accel=None).geometry
    tg = SCENES[name](tb).geometry
    grid = taccel.build_grid(tg)
    o, d = _random_rays(N, np.random.default_rng(0))
    tmax = np.full(N, np.inf, np.float32)
    t = torch.from_numpy
    tt, ts, tv = taccel.grid_closest_hit(grid, tg, t(o), t(d), t(tmax))
    tt, ts, tv = tt.numpy(), ts.numpy(), tv.numpy()
    # the port's sweep
    st, ss, sv = (x.numpy() for x in tshapes.closest_hit(tg, t(o), t(d),
                                                        t(tmax)))
    assert np.array_equal(tv, sv) and 0.05 < tv.mean() < 1
    np.testing.assert_allclose(tt[sv], st[sv], rtol=1e-5)
    assert (ts[sv] == ss[sv]).mean() > 0.999
    # kytpu's grid, jitted
    jt, js, jv = map(np.asarray, jax.jit(jaccel.grid_closest_hit)(
        jaccel.build_grid(jg), jg, jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(tmax)))
    key_j = np.where(jv, js, -1)
    key_t = np.where(tv, ts, -1)
    if name == "spheres":
        assert np.array_equal(jv, tv)
        assert (js[jv] == ts[jv]).mean() > 0.999
    else:
        _agree_but_triangle(key_j, key_t, tg, o, d, tmax)
    same = (key_j == key_t) & jv
    np.testing.assert_allclose(tt[same], jt[same], rtol=1e-5)


@pytest.mark.parametrize("name", list(SCENES))
@pytest.mark.parametrize("tm", [0.5, 3.0, np.inf])
def test_any_hit_matches_kytpu_and_the_sweep(name, tm):
    jg = SCENES[name](jb, accel=None).geometry
    tg = SCENES[name](tb).geometry
    o, d = _random_rays(N, np.random.default_rng(1))
    tmax = np.full(N, tm, np.float32)
    t = torch.from_numpy
    got = taccel.grid_any_hit(taccel.build_grid(tg), tg, t(o), t(d),
                              t(tmax)).numpy()
    sweep = tshapes.any_hit(tg, t(o), t(d), t(tmax)).numpy()
    assert (got == sweep).mean() > 0.999, (got != sweep).sum()
    ref = np.asarray(jax.jit(jaccel.grid_any_hit)(
        jaccel.build_grid(jg), jg, jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(tmax)))
    assert (got == ref).mean() > 0.999, (got != ref).sum()
    if name == "icosphere":
        _agree_but_triangle(ref, got, tg, o, d, tmax)
    assert 0 < got.mean() < 1


@pytest.mark.parametrize("tm", [0.5, 3.0, np.inf])
def test_occluded_from_routes_through_the_grid(tm, monkeypatch):
    """Scene.occluded_from without skip_row, the one route no jnp frame
    takes: through the grid, and equal to kytpu's and to the sweep's."""
    jsc = jb.random_spheres(60, 8, 8, seed=3, accel="grid")
    tsc = tb.random_spheres(60, 8, 8, seed=3, accel="grid")
    o, d = _random_rays(N, np.random.default_rng(2))
    tmax = np.full(N, tm, np.float32)
    calls = []
    real = taccel.grid_any_hit
    monkeypatch.setattr(taccel, "grid_any_hit",
                        lambda *a: calls.append(1) or real(*a))
    t = torch.from_numpy
    got = tscene.occluded_from(tsc, t(o), t(d), t(tmax)).numpy()
    assert calls
    ref = np.asarray(jax.jit(jscene.occluded_from)(
        jsc, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax)))
    sweep = tshapes.any_hit(tsc.geometry, t(o), t(d), t(tmax)).numpy()
    assert (got == ref).mean() > 0.999, (got != ref).sum()
    assert (got == sweep).mean() > 0.999, (got != sweep).sum()
    assert 0 < got.mean() < 1


def test_scene_from_numpy_carries_the_grid():
    ref = jax.device_get(jb.random_spheres(40, 8, 8, seed=2, accel="grid"))
    got = scene_from_numpy(ref)
    assert got.accel is not None
    assert_same_tables(ref, got)
    assert_same_tables(ref.accel, tb.random_spheres(40, 8, 8, seed=2,
                                                    accel="grid").accel)
    moved = got.to("cpu")
    assert moved.accel.dims == got.accel.dims


@pytest.mark.parametrize("accel", ["auto", None])
def test_auto_and_none_give_no_grid(accel):
    assert tb.random_spheres(20, 8, 8, accel=accel).accel is None
    assert jb.random_spheres(20, 8, 8, accel=accel).accel is None
    v, f = tmesh.icosphere(0)
    assert tb.mesh_scene(v, f, width=8, height=8, accel=accel).accel is None


def test_grid_frame_matches_kytpu_and_the_sweep():
    cfg = FastConfig(max_depth=2)
    kw = dict(spp=1, seed=4, clamp=False, engine="jnp")
    ref = np.asarray(jrender.render(
        jb.random_spheres(100, 24, 24, accel="grid"), cfg=cfg, **kw))
    grid = trender.render(tb.random_spheres(100, 24, 24, accel="grid"),
                          cfg=port_cfg(cfg), device="cpu", **kw).numpy()
    sweep = trender.render(tb.random_spheres(100, 24, 24), cfg=port_cfg(cfg),
                           device="cpu", **kw).numpy()
    assert np.isfinite(grid).all() and grid.mean() > 0
    assert np.isclose(grid, ref, rtol=1e-3, atol=1e-4).mean() > 0.999
    assert np.isclose(grid, sweep, atol=1e-4).mean() > 0.999


def test_grid_path_frame_matches_kytpu_and_the_sweep(monkeypatch):
    """The path engine's both_mis frame: its closest hits through
    Scene.intersect and its shadow rays through occluded and
    occluded_from, each routed through the grid."""
    cfg = PathConfig(max_depth=2, strategy="both_mis")
    kw = dict(spp=1, seed=4, clamp=False, engine="jnp")
    ref = np.asarray(jrender.render(
        jb.random_spheres(100, 24, 24, accel="grid"), cfg=cfg, **kw))
    calls = {"grid_closest_hit": 0, "grid_any_hit": 0}
    for name in calls:
        def counted(*a, _real=getattr(taccel, name), _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(taccel, name, counted)
    grid = trender.render(tb.random_spheres(100, 24, 24, accel="grid"),
                          cfg=port_cfg(cfg), device="cpu", **kw).numpy()
    assert all(calls.values()), calls
    sweep = trender.render(tb.random_spheres(100, 24, 24), cfg=port_cfg(cfg),
                           device="cpu", **kw).numpy()
    assert np.isfinite(grid).all() and grid.mean() > 0
    assert np.isclose(grid, ref, rtol=1e-3, atol=1e-4).mean() > 0.999
    assert np.isclose(grid, sweep, atol=1e-4).mean() > 0.999
