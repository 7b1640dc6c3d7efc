"""The plain big-scene K5, K6 and K7 on 33 lights past 64 surfaces (many_lights
with 31 more spheres) against kytpu's table kernels run interpreted
(sweep="scalar"), through each package's diff tracer: 512 lanes, depth 1,
the hash sampler, shadow="robust" (test_torch_lights_many.py `big_vjp`).
Tolerances as test_torch_bigscene_res.py: the radiance at most 0.5% of lanes
outside rtol=1e-3/atol=1e-4, each gradient table within rtol=1e-4 plus 1e-6
of its largest entry, the cache's planes on the bounces a lane reached."""

import numpy as np

from kytpu_torch.kernels import bigscene as kbs
from tests.test_torch_bigscene import lanes_agree
from tests.test_torch_lights_many import big_vjp
import tests.torch_threads  # noqa: F401  (one torch thread a process)


def test_big_kernels_past_the_caps_match_kytpu():
    got, ref, cfg, tables = big_vjp("lights33")
    lanes_agree(got[0], ref[0])
    for a, b in zip(got[1], ref[1]):
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6 * scale)
    resf, resi = got[2:]
    jresf, jresi = ref[2:]
    assert resf.shape == jresf.shape and resi.shape == jresi.shape
    ix, _ = kbs.layout_of(tables.static, cfg)
    reached = [np.ones(resf.shape[1], bool)]
    for b in range(cfg.max_depth):
        reached.append(reached[-1] & (resf[ix[("tu", b)]] != 0))
    bad = ((resi != 0) & (resi != jresi)).any(0)
    for tag, k in ix.items():
        bad |= reached[tag[1]] & ~np.isclose(resf[k], jresf[k], rtol=1e-3,
                                             atol=1e-4)
    assert bad.mean() <= 0.005, bad.mean()
    static = tables.static
    assert len(static["lights"]) > 32 or static["n_textures"] > 64


