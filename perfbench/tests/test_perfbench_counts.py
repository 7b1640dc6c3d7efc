"""The work counts on hand-counted lanes: a Tally of a synthetic cache
and k1_ops / k3_ops against the per-lane-bounce counts written out."""

import torch

from perfbench.counts import transport
from perfbench.reference import oracle
from perfbench.reference.frozen.kernels import wavefront as wf

CONFIG = {"scene": "veach_mis", "args": {"width": 8, "height": 8},
          "transport": {"nee": "all", "sampler": "random",
                        "shadow": "parity", "rr_start": 3}}


def _static_cfg():
    cfg = oracle.kernel_config(CONFIG, {"max_depth": 2})
    static = wf.pack_tables(oracle.build_scene(CONFIG, "cpu"), cfg).static
    return static, cfg


def test_a_lane_that_ends_at_its_first_hit():
    """One lane, no extension, no shadow ray that reached its light: one
    closest-hit sweep and one shading of the first vertex."""
    static, cfg = _static_cfg()
    ix, res_n = wf.residual_layout(static, cfg)
    t = transport.Tally()
    t.add(static, cfg, torch.zeros(res_n, 1))
    n_pl, n_sp, n_l = (len(static["planar"]), len(static["spheres"]),
                       len(static["lights"]))
    assert (n_pl, n_sp, n_l) == (6, 5, 5)
    # Veach: 6 planar rows (4 plates, floor, back wall) at 31, 5 spheres
    # at 33, 32 a hit; 62 + 6 + 134 a light + 90 below the horizon
    assert transport.k1_ops(static, cfg, t) == (
        31 * 6 + 33 * 5 + 32) + (62 + 6 + 134 * 5 + 90)
    # K3: one traced bounce of 45 + 27 a light, 6 at the horizon
    assert transport.k3_ops(static, cfg, t) == 45 + 27 * 5 + 6


def test_a_lane_with_one_lit_shadow_ray_and_an_extension():
    static, cfg = _static_cfg()
    ix, res_n = wf.residual_layout(static, cfg)
    cache = torch.zeros(res_n, 1)
    cache[ix[("B", 0, 2)]] = 0.5     # light 2 reached at bounce 0
    cache[ix[("tu", 0)]] = 0.25      # the lane goes on to bounce 1
    t = transport.Tally()
    t.add(static, cfg, cache)
    assert t.reached == [1, 1, 0] and t.lit[0][2] == 1 and t.lit_any == [1, 0]
    skips, sph = wf._occl_skips(static, cfg)
    fast = [bool(s.get("fast")) for s in static["planar"]]
    ray = (sum(27 if fast[r] else 34 for r in range(6) if r not in skips[2])
           + 19 * (5 - len(sph[2])))
    shared = (33 * sum(1 for r in range(6) if fast[r] and any(
        r not in skips[i] for i in range(5)))
        + 13 * sum(1 for j in range(5) if any(j not in sph[i]
                                              for i in range(5))))
    hit, shade = 31 * 6 + 33 * 5 + 32, 62 + 6 + 134 * 5 + 90
    assert transport.k1_ops(static, cfg, t) == 2 * (hit + shade) + ray + shared
    assert transport.k3_ops(static, cfg, t) == 2 * (45 + 27 * 5) + 6
