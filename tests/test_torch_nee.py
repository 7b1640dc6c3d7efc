"""The port's next-event estimation (kytpu_torch/light/nee.py) against
kytpu's, jitted: the six strategies under both light selections at the
first hits of Veach MIS camera rays (four Phong plates under four sphere
lights and a small one), and both_mis under sobol draws and robust
shadows. Both packages resolve the same hits' BSDFs from the same threefry
keys (bit-exact draws) and estimate direct light a lane.

Tolerance: radiance within rtol=1e-3/atol=1e-4 with at most 0.5% of lanes
outside (tests/torch_jnp.py); the share outside is printed.
"""

import jax
import numpy as np
import pytest
import torch

from kytpu.core import rng as jrng
from kytpu.integrator import path as jpath
from kytpu.light import nee as jnee
from kytpu.scene import builders as jb
from kytpu.scene import scene as jscene
from kytpu_torch.core import rng as trng
from kytpu_torch.integrator import path as tpath
from kytpu_torch.light import nee as tnee
from kytpu_torch.scene import builders as tb
from kytpu_torch.scene import scene as tscene
from tests.torch_jnp import lanes_agree
from tests.test_torch_wavefront import camera_rays
import tests.torch_threads  # noqa: F401  (one torch thread a process)

W, H, N = 24, 16, 1536


def _direct(strategy, selection, sampler="random", shadow="parity"):
    jsc, tsc = jb.veach_mis(W, H), tb.veach_mis(W, H)
    o, d, si, pix = camera_rays(jsc, N, seed=11)
    index = si if sampler == "sobol" else None

    def ref(o, d, pix, si):
        keys = jax.vmap(lambda p: jax.random.fold_in(jax.random.key(9), p))(
            pix)
        k_lobe, k_nee = jrng.split_channels(keys, 2)
        hit = jscene.intersect(jsc, o, d)
        idx = si if sampler == "sobol" else None
        params = jpath._resolve(jsc, hit, k_lobe, sampler, idx)
        active = hit.valid & ~jpath.kbsdf.is_delta(params)
        return jnee.sample_all_lights(jsc, hit, params, k_nee, active,
                                      strategy, selection, sampler, idx,
                                      shadow)

    t = torch.from_numpy
    keys = trng.fold_in(trng.key(9), t(pix).long())
    k_lobe, k_nee = trng.split_channels(keys, 2)
    tindex = t(si).long() if index is not None else None
    hit = tscene.intersect(tsc, t(o), t(d))
    params = tpath._resolve(tsc, hit, k_lobe, sampler, tindex)
    active = hit.valid & ~tpath.kbsdf.is_delta(params)
    got = tnee.sample_all_lights(tsc, hit, params, k_nee, active, strategy,
                                 selection, sampler, tindex, shadow).numpy()
    return np.asarray(jax.jit(ref)(o, d, pix, si)), got


@pytest.mark.parametrize("selection", ["all", "single"])
@pytest.mark.parametrize("strategy", jnee.STRATEGIES)
def test_strategies(strategy, selection):
    ref, got = _direct(strategy, selection)
    share = lanes_agree(got, ref)
    lit = (np.abs(ref) > 0).any(-1).mean()
    print(f"{strategy}/{selection}: {share:.4f} of lanes outside, "
          f"{lit:.3f} lit")
    assert strategy == "idle" or lit > 0.005


@pytest.mark.parametrize("sampler, shadow", [("sobol", "parity"),
                                             ("random", "robust")])
def test_both_mis_sobol_and_robust(sampler, shadow):
    ref, got = _direct("both_mis", "all", sampler, shadow)
    share = lanes_agree(got, ref)
    print(f"both_mis {sampler}/{shadow}: {share:.4f} of lanes outside")


def test_strategy_names_match():
    assert tnee.STRATEGIES == jnee.STRATEGIES
    assert tpath.VARIANTS == jpath.VARIANTS
