"""The port's intersection sweeps (kytpu_torch/scene/shapes.py, scene.py)
against kytpu's, jitted: closest_hit and any_hit dense (Cornell, Veach, a
scene of every shape kind) and over chunks of 128 rows
(random_spheres(300), 302 surfaces), skip_row, normals, uv on every shape
kind, spheres included, and scene.intersect / occluded / occluded_from.

Tolerance: hit rows, validity and occlusion equal on every lane; t,
positions, normals and uv within rtol=1e-5/atol=1e-6 (XLA contracts the
multiply-adds of the ray tests), a sphere's normal (hit - centre) / r
within atol=2e-5, since it divides the hit's last bits by a radius of
0.2-1.

One fault of the reference shows here, and the port does not copy it.
kytpu's triangle test leans on the degenerate fourth edge (p3 == p0)
giving exactly 0 (shapes.py planar_test), but jitted on the CPU XLA
contracts its cross product u1 v2 - u2 v1 into fma(u1, v2, -u2 v1), the
rounding residual of a product, so a hit whose edge tests are all >= 0 is
kept or dropped by that residual's sign: kytpu's jnp engines lose part of
the hits on one face of every triangle. The port computes the 0. So on the
scene with a triangle every lane agrees except lanes where the port hits
the triangle and kytpu does not (`_agree_but_triangle`).
"""

import jax
import numpy as np
import pytest
import torch

from kytpu.scene import builders as jb
from kytpu.scene import scene as jscene
from kytpu.scene import shapes as jshapes
from kytpu_torch.scene import builders as tb
from kytpu_torch.scene import scene as tscene
from kytpu_torch.scene import shapes as tshapes
import tests.torch_threads  # noqa: F401  (one torch thread a process)

N = 2048


def close(got, ref, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=1e-5,
                               atol=atol)


def _agree_but_triangle(ref, got, tg, o, d, tmax):
    """ref == got (kytpu's and the port's per-lane answers) except on lanes
    where the port's planar test accepts a triangle row that kytpu's
    jitted one drops -> the share of such lanes."""
    diff = ref != got
    if not diff.any():
        return 0.0
    t = torch.from_numpy
    _, acc = tshapes.intersect_planar(tg, t(o[diff]), t(d[diff]),
                                      t(tmax[diff]))
    tri = (tg.pl_kind == tshapes.TRI)[None]
    assert (acc & tri).any(1).all(), "a lane differs off the triangles"
    return float(diff.mean())


def _every_kind(shapes):
    """A triangle, a rectangle, a disk and two spheres."""
    g = shapes.GeometryBuilder()
    g.add_triangle((-1.0, -1.0, -3.0), (1.0, -1.0, -3.5), (0.0, 1.0, -3.2))
    g.add_rectangle((-2.0, -1.5, -5.0), (-2.0, 1.5, -5.0), (2.0, 1.5, -5.5),
                    (2.0, -1.5, -5.5))
    g.add_disk((1.5, 0.5, -2.5), (0.3, 0.2, 1.0), 0.6)
    g.add_sphere((-1.2, 0.4, -2.0), 0.5)
    g.add_sphere((0.7, -0.6, -4.0), 0.9)
    return g.build()[0]


GEOMS = {
    "cornell": lambda: (jb.cornell_box(width=8, height=8).geometry,
                        tb.cornell_box(width=8, height=8).geometry),
    "veach": lambda: (jb.veach_mis(16, 12).geometry,
                      tb.veach_mis(16, 12).geometry),
    "every_kind": lambda: (_every_kind(jshapes), _every_kind(tshapes)),
    "spheres300": lambda: (jb.random_spheres(300, 8, 8).geometry,
                           tb.random_spheres(300, 8, 8).geometry),
}


def _rays(tg, seed):
    """Rays from points in the geometry's bound towards random points of
    it, and a few along the axes (ties at shared edges)."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([tg.pl_p0.numpy(), tg.pl_p2.numpy(),
                          tg.sp_center.numpy()])
    lo, hi = pts.min(0), pts.max(0)
    o = rng.uniform(lo, hi, (N, 3))
    tgt = rng.uniform(lo, hi, (N, 3))
    d = tgt - o
    sign = np.where(np.arange(16) % 2, 1, -1)[:, None]
    d[:16] = np.eye(3)[np.arange(16) % 3] * sign
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.where(rng.random(N) < 0.5, np.inf,
                    rng.uniform(0.1, 5.0, N)).astype(np.float32)
    return o.astype(np.float32), d.astype(np.float32), tmax


@pytest.mark.parametrize("name", list(GEOMS))
def test_closest_and_any_hit(name):
    jg, tg = GEOMS[name]()
    assert (tg.n_surfaces > 2 * tshapes._SWEEP_CHUNK) == (name == "spheres300")
    o, d, tmax = _rays(tg, 1)
    t = torch.from_numpy
    jt, js, jv = map(np.asarray, jax.jit(jshapes.closest_hit)(jg, o, d,
                                                               tmax))
    tt, ts, tv = tshapes.closest_hit(tg, t(o), t(d), t(tmax))
    key_j = np.where(jv, js, -1)
    key_t = np.where(tv.numpy(), ts.numpy(), -1)
    share = _agree_but_triangle(key_j, key_t, tg, o, d, tmax)
    assert share == 0.0 or name == "every_kind"
    same = key_j == key_t
    assert tv.float().mean() > 0.05
    close(tt.numpy()[same & jv], jt[same & jv])
    # normals and uv at kytpu's hits, each package from its own tables
    p = np.where(jv[:, None], o + jt[:, None] * d, o).astype(np.float32)
    close(tshapes.surface_normal(tg, t(js), t(p), t(d)),
          jax.jit(jshapes.surface_normal)(jg, js, p, d), atol=2e-5)
    close(tshapes.surface_uv(tg, t(js), t(p)),
          jax.jit(jshapes.surface_uv)(jg, js, p))
    tm = np.where(np.isfinite(tmax), tmax, 3.0).astype(np.float32)
    ja = np.asarray(jax.jit(jshapes.any_hit)(jg, o, d, tm))
    ta = tshapes.any_hit(tg, t(o), t(d), t(tm)).numpy()
    _agree_but_triangle(ja, ta, tg, o, d, tm)
    assert 0 < ta.mean() < 1
    # skip_row, one row for all lanes and one a lane (-1 skips nothing)
    rows = np.random.default_rng(2).integers(-1, tg.n_surfaces, N)
    for skip in (int(js[0]), rows.astype(np.int32)):
        ja = np.asarray(jax.jit(jshapes.any_hit)(jg, o, d, tm, skip))
        ta = tshapes.any_hit(tg, t(o), t(d), t(tm),
                             torch.as_tensor(skip)).numpy()
        _agree_but_triangle(ja, ta, tg, o, d, tm)


@pytest.mark.parametrize("name", ["every_kind", "spheres300"])
def test_uv_on_every_surface(name):
    """uv at points spread over each surface's plane or sphere, row by
    row, whether or not a ray reaches them."""
    jg, tg = GEOMS[name]()
    rng = np.random.default_rng(3)
    sid = rng.integers(0, tg.n_surfaces, N).astype(np.int32)
    base = np.where((sid < tg.n_planar)[:, None],
                    tg.pl_p0.numpy()[np.minimum(sid, tg.n_planar - 1)],
                    tg.sp_center.numpy()[np.maximum(sid - tg.n_planar, 0)])
    off = rng.normal(size=(N, 3)).astype(np.float32)
    p = (base + off).astype(np.float32)
    close(tshapes.surface_uv(tg, torch.from_numpy(sid), torch.from_numpy(p)),
          jax.jit(jshapes.surface_uv)(jg, sid, p))


@pytest.mark.parametrize("name", ["veach", "spheres300"])
def test_scene_intersect_and_shadows(name):
    make = {"veach": lambda b: b.veach_mis(16, 12),
            "spheres300": lambda b: b.random_spheres(300, 8, 8)}[name]
    jsc, tsc = make(jb), make(tb)
    o, d, _ = _rays(tsc.geometry, 4)
    t = torch.from_numpy
    jh = jax.jit(jscene.intersect)(jsc, o, d)
    th = tscene.intersect(tsc, t(o), t(d))
    for f in ("valid", "sid", "light_index"):
        assert np.array_equal(np.asarray(getattr(jh, f)),
                              getattr(th, f).numpy()), f
    v = np.asarray(jh.valid)
    for f in ("t", "position", "normal", "wo", "emission", "uv"):
        close(getattr(th, f)[torch.from_numpy(v)],
              np.asarray(getattr(jh, f))[v], 2e-5 if f == "normal" else 1e-6)
    dist = np.random.default_rng(5).uniform(0.5, 4.0, N).astype(np.float32)
    n = np.asarray(jh.normal)
    assert np.array_equal(
        np.asarray(jax.jit(jscene.occluded)(jsc, o, n, d, dist)),
        tscene.occluded(tsc, t(o), t(n), t(d), t(dist)).numpy())
    skip = tsc.lights.surface_ids[0]
    assert np.array_equal(
        np.asarray(jax.jit(lambda *a: jscene.occluded_from(
            jsc, *a, skip_row=skip))(o, d, dist)),
        tscene.occluded_from(tsc, t(o), t(d), t(dist), skip).numpy())
    close(tscene.spawn_ray(t(o), t(n), t(d)),
          jax.jit(jscene.spawn_ray)(o, n, d))
