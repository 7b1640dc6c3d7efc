"""The port's light sampling (kytpu_torch/light/lights.py) against kytpu's,
jitted, for the five light kinds: sample_li, pdf_li (at the sampled
directions and at random ones) and light_power, on the lights of the
scenes that carry each kind, from numpy-seeded shade points and draws.

Tolerance: rtol=1e-4 with atol=1e-6 (directions, pdfs, radiance, power);
sampled positions atol=1e-5 of the scene's world radius: a sphere light's
cone sample takes sin_alpha = sqrt(1 - cos_alpha^2) near cos_alpha = 1,
which turns the last bit of cos_alpha (XLA contracts the multiply-adds
that make it) into about 1e-5 scene units of the sampled point on
Veach's lights.
Every lane's pdf > 0 test and facing test must match.
"""

import jax
import numpy as np
import pytest
import torch

from kytpu.light import lights as jl
from kytpu.scene import builders as jb
from kytpu_torch.light import lights as tl
from kytpu_torch.scene import builders as tb
import tests.torch_threads  # noqa: F401  (one torch thread a process)

N = 512
RTOL, ATOL = 1e-4, 1e-6

SCENES = {
    "point": (lambda b: b.cornell_box({jb.LIGHT_POINT}, 8, 8), jl.POINT),
    "direction": (lambda b: b.cornell_box({jb.LIGHT_DIRECTION}, 8, 8),
                  jl.DIRECTION),
    "rect": (lambda b: b.cornell_box(width=8, height=8), jl.AREA_RECT),
    "sphere": (lambda b: b.veach_mis(16, 12), jl.AREA_SPHERE),
    "env": (lambda b: b.cornell_box({jb.LIGHT_ENVIRONMENT}, 8, 8), jl.ENV),
}


def close(got, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=RTOL,
                               atol=atol)


def _shade_points(jsc, i, seed):
    """Points spread over the scene's bound and, for a sphere light, inside
    it and far from it (the Taylor fallback), with unit normals."""
    rng = np.random.default_rng(seed)
    c = np.asarray(jsc.world_center)
    r = float(jsc.world_radius)
    p = c + rng.uniform(-0.7, 0.7, (N, 3)) * r
    if jsc.lights.kinds[i] == jl.AREA_SPHERE:
        lc = np.asarray(jsc.lights.center[i])
        lr = float(jsc.lights.radius[i])
        p[:64] = lc + rng.uniform(-0.5, 0.5, (64, 3)) * lr
        p[64:128] = lc + rng.normal(size=(64, 3)) * 200.0 * lr
    n = rng.normal(size=(N, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return p.astype(np.float32), n.astype(np.float32)


@pytest.mark.parametrize("name", list(SCENES))
def test_sample_pdf_power(name):
    make, kind = SCENES[name]
    jsc, tsc = make(jb), make(tb)
    idx = [i for i, k in enumerate(jsc.lights.kinds) if k == kind]
    assert idx
    t = torch.from_numpy
    for i in idx:
        p, n = _shade_points(jsc, i, seed=i)
        u2 = np.random.default_rng(10 + i).random((N, 2)).astype(np.float32)
        ref = jax.jit(lambda p, n, u: jl.sample_li(
            jsc.lights, i, jsc.world_radius, p, n, u))(p, n, u2)
        got = tl.sample_li(tsc.lights, i, tsc.world_radius, t(p), t(n),
                           t(u2))
        assert np.array_equal(np.asarray(ref.pdf) > 0, got.pdf.numpy() > 0)
        assert np.array_equal(np.asarray(ref.li).any(-1),
                              got.li.numpy().any(-1))
        close(got.position, ref.position,
              atol=1e-5 * float(jsc.world_radius))
        for f in ("wi", "pdf", "li"):
            close(getattr(got, f), getattr(ref, f))
        w_rand = np.random.default_rng(20 + i).normal(size=(N, 3))
        w_rand = (w_rand / np.linalg.norm(w_rand, axis=-1,
                                          keepdims=True)).astype(np.float32)
        for wi in (np.array(ref.wi), w_rand):
            close(tl.pdf_li(tsc.lights, i, t(p), t(n), t(wi)),
                  jax.jit(lambda p, n, w: jl.pdf_li(jsc.lights, i, p, n, w))(
                      p, n, wi))
        close(tl.light_power(tsc.lights, i, tsc.world_radius),
              jl.light_power(jsc.lights, i, jsc.world_radius))
        assert tl.is_delta_light(kind) == jl.is_delta_light(kind)
