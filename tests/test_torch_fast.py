"""The port's fast engine (kytpu_torch/integrator/fast.py) against kytpu's,
through trace_lanes of both packages on the same lanes: its three samplers
(one fused threefry draw of 2L + 4 uniforms a bounce, the debug constant,
per-purpose Owen-Sobol draws), an environment-lit Cornell box, a
point-lit one (the full, unhalved delta-light NEE), Veach MIS and robust
shadows. 16x16 frames (Veach 24x16), 2 samples a pixel, depth 3.

Tolerance: radiance within rtol=1e-3/atol=1e-4 with at most 0.5% of lanes
outside (tests/torch_jnp.py); the share outside is printed.
"""

import numpy as np
import pytest
import torch

from kytpu.integrator import fast as jfast
from kytpu.integrator.fast import FastConfig
from kytpu.scene import builders as jb
from kytpu_torch.core import rng as trng
from kytpu_torch.integrator import fast as tfast
from kytpu_torch.scene import builders as tb
from tests.torch_jnp import lanes_agree, trace_pair

SCENES = {
    "cornell": lambda b: b.cornell_box(width=16, height=16),
    "cornell_env": lambda b: b.cornell_box(
        {jb.LIGHT_ENVIRONMENT, jb.SMALL_GLASS_SPHERE}, 16, 16),
    "cornell_point": lambda b: b.cornell_box(
        {jb.LIGHT_POINT, jb.SMALL_MIRROR_SPHERE}, 16, 16),
    "veach": lambda b: b.veach_mis(24, 16),
}

CASES = {
    "random": ("cornell", {}),
    "debug": ("cornell", dict(sampler="debug")),
    "sobol": ("cornell", dict(sampler="sobol")),
    "env": ("cornell_env", {}),
    "point": ("cornell_point", {}),
    "veach_robust": ("veach", dict(shadow="robust")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_trace_lanes_fast(case):
    scene, kw = CASES[case]
    make = SCENES[scene]
    ref, got = trace_pair(make(jb), make(tb), FastConfig(max_depth=3, **kw),
                          "path", spp=2, seed=6)
    share = lanes_agree(got, ref)
    print(f"fast {case}: {share:.4f} of {len(ref)} lanes outside the bound")


def test_fused_draws_bit_exact():
    """_draws: uniform(fold_in(k, bounce), (2L + 4,)) a lane, to the bit;
    and the sobol columns in the same order."""
    import jax
    pix = np.arange(300, dtype=np.int32)
    jkeys = jax.vmap(lambda p: jax.random.fold_in(jax.random.key(4), p))(pix)
    tkeys = trng.fold_in(trng.key(4), torch.from_numpy(pix).long())
    for b in (0, 3):
        np.testing.assert_array_equal(
            np.asarray(jfast._draws(jkeys, b, 14, "random")),
            tfast._draws(tkeys, b, 14, "random").numpy())
        idx = (pix % 7).astype(np.int32)
        np.testing.assert_array_equal(
            np.asarray(jfast._draws_sobol(jkeys, b, 5, idx)),
            tfast._draws_sobol(tkeys, b, 5, torch.from_numpy(idx).long())
            .numpy())


def test_fast_refuses_unknown_sampler():
    sc = tb.cornell_box(width=4, height=4)
    o = torch.zeros(2, 3)
    d = torch.tensor([[0.0, 0.0, -1.0]] * 2)
    keys = trng.fold_in(trng.key(0), torch.arange(2))
    with pytest.raises(ValueError, match="sampler"):
        tfast.li_path_fast(sc, o, d, keys,
                           tfast.FastConfig(sampler="stratified"))
    with pytest.raises(ValueError, match="sample index"):
        tfast.li_path_fast(sc, o, d, keys, tfast.FastConfig(sampler="sobol"))
