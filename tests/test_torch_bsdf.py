"""The port's BSDFs, frames and warps (kytpu_torch/bsdf, core/frame.py,
core/math.py) against kytpu's, jitted, on the same numpy-seeded lanes.

Tolerance: rtol=1e-5 with atol=1e-7 for values near 0 (a float32 result
off by a few ulps: XLA contracts multiply-adds and has its own cos, sin
and pow; the port rounds float64 transcendentals). The sampled lobe of a
glass lane (u < Fresnel) and of a plastic lane (u < s_prob) must match on
every lane: no draw here lies within rounding of its threshold. Two inputs
are conditioned so that a last-bit difference grows past that bound, and
the tests keep away from them: a Phong value pow(cos, e) turns a relative
difference of cos into e times it, and the world-frame transforms differ
in the last bit of cos, so the world-frame test draws exponents in [1, 10]
(the local-frame test, on the same cosines in both packages, [1, 40]);
a delta lobe's f = R / |cos| at a grazing world-frame sample turns the
absolute last-bit difference of cos into a relative one of f, so the
world-frame samples compare f |cos|, what the integrators multiply into a
path's throughput; and a cosine-hemisphere sample at the disk's rim,
z = sqrt(1 - r^2) with r near 1, turns a last-bit difference of r^2 into
its square root.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kytpu import bsdf as jbsdf
from kytpu.core import frame as jframe
from kytpu.core import math as jm
from kytpu_torch import bsdf as tbsdf
from kytpu_torch.core import frame as tframe
from kytpu_torch.core import math as tm
import tests.torch_threads  # noqa: F401  (one torch thread a process)

N = 512
RTOL, ATOL = 1e-5, 1e-7


def close(got, ref):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=RTOL,
                               atol=ATOL)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _params(kind, seed=0, max_exponent=40.0):
    """(numpy fields of BsdfParams, wo, wi, u2) for N lanes of one BSDF
    kind (a list of kinds mixes them lane by lane)."""
    rng = np.random.default_rng(seed)
    kinds = np.resize(np.asarray(kind, np.int32), N)
    f = dict(kind=kinds,
             color=rng.uniform(0.05, 1.0, (N, 3)).astype(np.float32),
             color2=rng.uniform(0.05, 1.0, (N, 3)).astype(np.float32),
             eta=rng.uniform(1.2, 2.0, N).astype(np.float32),
             exponent=rng.uniform(1.0, max_exponent, N).astype(np.float32))
    wo, wi = _unit(rng, N), _unit(rng, N)
    u2 = rng.random((N, 2)).astype(np.float32)
    return f, wo, wi, u2


def _both(f):
    return (jbsdf.BsdfParams(**{k: jnp.asarray(v) for k, v in f.items()}),
            tbsdf.BsdfParams(**{k: torch.from_numpy(v) for k, v in f.items()}))


KINDS = {"lambert": jbsdf.LAMBERT, "mirror": jbsdf.MIRROR,
         "glass": jbsdf.GLASS, "phong": jbsdf.PHONG,
         "mixed": [jbsdf.LAMBERT, jbsdf.MIRROR, jbsdf.GLASS, jbsdf.PHONG]}


@pytest.mark.parametrize("kind", list(KINDS))
def test_local_eval_pdf_sample(kind):
    f, wo, wi, u2 = _params(KINDS[kind])
    jp, tp = _both(f)
    t = torch.from_numpy
    close(tbsdf.eval_local(tp, t(wo), t(wi)),
          jax.jit(jbsdf.eval_local)(jp, wo, wi))
    close(tbsdf.pdf_local(tp, t(wo), t(wi)),
          jax.jit(jbsdf.pdf_local)(jp, wo, wi))
    ref = jax.jit(jbsdf.sample_local)(jp, wo, u2)
    got = tbsdf.sample_local(tp, t(wo), t(u2))
    assert np.array_equal(np.asarray(ref.delta), got.delta.numpy())
    for name in ("f", "wi", "pdf"):
        close(getattr(got, name), getattr(ref, name))
    assert np.array_equal(np.asarray(jbsdf.is_delta(jp)),
                          tbsdf.is_delta(tp).numpy())


def test_world_wrappers():
    f, wo, wi, u2 = _params(KINDS["mixed"], seed=1, max_exponent=10.0)
    n = _unit(np.random.default_rng(2), N)
    jp, tp = _both(f)
    t = torch.from_numpy
    je, jpdf = jax.jit(jbsdf.eval_and_pdf_world)(jp, n, wo, wi)
    te, tpdf = tbsdf.eval_and_pdf_world(tp, t(n), t(wo), t(wi))
    close(te, je)
    close(tpdf, jpdf)
    close(tbsdf.eval_world(tp, t(n), t(wo), t(wi)), je)
    close(tbsdf.pdf_world(tp, t(n), t(wo), t(wi)), jpdf)
    ref = jax.jit(jbsdf.sample_world)(jp, n, wo, u2)
    got = tbsdf.sample_world(tp, t(n), t(wo), t(u2))
    assert np.array_equal(np.asarray(ref.delta), got.delta.numpy())
    for name in ("wi", "pdf"):
        close(getattr(got, name), getattr(ref, name))
    close(got.f * tm.absdot(got.wi, t(n))[:, None],
          ref.f * jm.absdot(ref.wi, n)[:, None])


def test_resolve_bsdf_plastic_pick():
    rng = np.random.default_rng(3)
    mk = np.resize(np.arange(4, dtype=np.int32), N)
    dif = rng.random((N, 3)).astype(np.float32)
    spec = rng.random((N, 3)).astype(np.float32)
    expo = rng.uniform(1, 100, N).astype(np.float32)
    eta = rng.uniform(1, 2, N).astype(np.float32)
    sp = rng.random(N).astype(np.float32)
    dp = (1.0 - sp).astype(np.float32)
    u = rng.random(N).astype(np.float32)
    args = (mk, dif, spec, expo, eta, dp, sp, u)
    ref = jax.jit(jbsdf.resolve_bsdf)(*args)
    got = tbsdf.resolve_bsdf(*(torch.from_numpy(a) for a in args))
    assert np.array_equal(np.asarray(ref.kind), got.kind.numpy())
    for name in ("color", "color2", "eta", "exponent"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)),
                                      getattr(got, name).numpy())
    # both lobes of plastic are picked
    assert {1, 3} <= set(got.kind[mk == 3].tolist()) | {1}


def test_frame():
    n = _unit(np.random.default_rng(4), N)
    n[:8] = [[1, 0, 0], [-1, 0, 0], [0.995, 0.0998749, 0], [0, 1, 0],
             [0, 0, 1], [0, 0, -1], [0.99, 0.141067, 0], [0.7, 0.7, 0.1414]]
    w = _unit(np.random.default_rng(5), N)
    js = jax.jit(jframe.make_frame)(n)
    ts = tframe.make_frame(torch.from_numpy(n))
    for a, b in zip(ts, js):
        close(a, b)
    close(tframe.to_local(*ts, torch.from_numpy(w)),
          jax.jit(jframe.to_local)(*js, w))
    close(tframe.to_world(*ts, torch.from_numpy(w)),
          jax.jit(jframe.to_world)(*js, w))


WARPS = ["uniform_disk_sample", "concentric_disk_sample",
         "cosine_hemisphere_sample", "uniform_hemisphere_sample",
         "uniform_sphere_sample", "uniform_triangle_sample"]


@pytest.mark.parametrize("name", WARPS)
def test_warps(name):
    u = np.random.default_rng(6).random((N, 2)).astype(np.float32)
    u[:2] = [[0.5, 0.5], [0.5, 0.25]]
    close(getattr(tm, name)(torch.from_numpy(u)),
          jax.jit(getattr(jm, name))(u))


def test_cone_mis_fresnel_reflect_refract_offset():
    rng = np.random.default_rng(7)
    u = rng.random((N, 2)).astype(np.float32)
    cmax = rng.uniform(0.1, 0.99, N).astype(np.float32)
    t = torch.from_numpy
    close(tm.uniform_cone_sample(t(u), t(cmax)),
          jax.jit(jm.uniform_cone_sample)(u, cmax))
    close(tm.uniform_cone_pdf(t(cmax)), jm.uniform_cone_pdf(cmax))
    a, b, c, d = (rng.uniform(0.1, 3, N).astype(np.float32) for _ in range(4))
    for h in ("balance_heuristic", "power_heuristic"):
        close(getattr(tm, h)(t(a), t(b), t(c), t(d)),
              jax.jit(getattr(jm, h))(a, b, c, d))
    cos_i = rng.uniform(-1, 1, N).astype(np.float32)
    eta = rng.uniform(1.1, 2.0, N).astype(np.float32)
    one = np.ones(N, np.float32)
    close(tm.fresnel_dielectric(t(cos_i), t(one), t(eta)),
          jax.jit(jm.fresnel_dielectric)(cos_i, one, eta))
    ci = np.abs(cos_i)
    close(tm.fresnel_schlick(t(ci), t(one), t(eta)),
          jax.jit(jm.fresnel_schlick)(ci, one, eta))
    close(tm.fresnel_schlick_f0(t(ci), t(a / 3)),
          jax.jit(jm.fresnel_schlick_f0)(ci, a / 3))
    wo, n, dd = _unit(rng, N), _unit(rng, N), _unit(rng, N)
    close(tm.reflect(t(wo), t(n)), jax.jit(jm.reflect)(wo, n))
    n_h = np.where((np.sum(wo * n, -1) < 0)[:, None], -n, n)
    jwt, jok = jax.jit(jm.refract)(wo, n_h, 1.0 / eta)
    twt, tok = tm.refract(t(wo), t(n_h), tm.div(1.0, t(eta)))
    assert np.array_equal(np.asarray(jok), tok.numpy())
    close(twt, jwt)
    p = rng.normal(size=(N, 3)).astype(np.float32)
    close(tm.offset_ray_origin(t(p), t(n), t(dd)),
          jax.jit(jm.offset_ray_origin)(p, n, dd))
