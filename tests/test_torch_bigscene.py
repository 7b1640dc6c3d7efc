"""The plain big-scene forward K5 against kytpu's, lane by lane.

The same numpy-seeded camera rays, seed and lane ids go through kytpu's
`make_bigscene_tracer` (its Pallas kernel in interpret mode, where the
"random" sampler is the hash stream the port reproduces) and through the
port's `trace_lanes` on CPU tensors (the plain K5): random_spheres(n=80)
(82 surfaces, a sphere light and the sky), 2048 lanes, rows=8.
kytpu runs sweep="scalar" here, whose arithmetic the port transcribes;
test_torch_bigscene_sobol.py holds the port once against kytpu's default
matmul sweep. Tolerance: at most 0.5% of lanes outside rtol=1e-3/atol=1e-4
(kytpu's interpreted arithmetic fuses multiply-adds and has its own cos and
rsqrt; the forward tests of K1 use the same bound).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kytpu.kernels import bigscene as jbs
from kytpu.kernels import wavefront as jwf
from kytpu.scene import builders as jb
from kytpu.scene import scene as jscene
from kytpu_torch.kernels import bigscene as kbs
from kytpu_torch.kernels import wavefront as kwf
from kytpu_torch.scene import builders as tb
import tests.torch_threads  # noqa: F401  (one torch thread a process)

W = H = 32


def spheres(b):
    return b.random_spheres(n=80, width=W, height=H, seed=0)


def camera_lanes(jsc, n, seed=1):
    """(o, d, si, pix) numpy lanes: jittered camera rays of kytpu's jitted
    ray generation (the port's is bit-identical), sample index, pixel id."""
    rng = np.random.default_rng(seed)
    npix = W * H
    pid = np.arange(n) % npix
    pf = np.stack([pid % W + rng.random(n), pid // W + rng.random(n)],
                  -1).astype(np.float32)
    o, d = jscene.generate_rays(jsc.camera, jnp.asarray(pf))
    return (np.asarray(o), np.asarray(d),
            (np.arange(n) // npix).astype(np.int32), pid.astype(np.int32))


def lanes_agree(got, ref, max_share=0.005):
    assert np.isfinite(got).all()
    share = (~np.isclose(got, ref, rtol=1e-3, atol=1e-4)).any(-1).mean()
    assert share <= max_share, share
    return share


def trace_both(sampler, shadow, depth, sweep="scalar", n=2048, seed=5):
    jsc, tsc = spheres(jb), spheres(tb)
    o, d, si, pix = camera_lanes(jsc, n)
    kw = dict(max_depth=depth, rows=8, sampler=sampler, shadow=shadow)
    tr = jbs.make_bigscene_tracer(jsc, jwf.KernelConfig(sweep=sweep, **kw),
                                  interpret=True)
    extra = ((jnp.asarray(si), jnp.asarray(pix)) if sampler != "random"
             else ())
    ref = np.asarray(tr(jsc, jnp.asarray(o), jnp.asarray(d), seed, *extra))
    cfg = kwf.KernelConfig(sweep=sweep, **kw)
    got = kbs.trace_lanes(kbs.pack_big_tables(tsc, cfg), cfg,
                          *map(torch.from_numpy, (o, d)), seed,
                          *map(torch.from_numpy, (si, pix))).numpy()
    return got, ref


@pytest.mark.parametrize("sampler, shadow", [("random", "parity"),
                                             ("hash", "robust")])
def test_k5_lanes_match_kytpu(sampler, shadow):
    got, ref = trace_both(sampler, shadow, depth=2)
    lanes_agree(got, ref)
    assert ref.mean() > 0.05
