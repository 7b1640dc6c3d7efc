"""The port's path integrators (kytpu_torch/integrator/path.py) against
kytpu's, through trace_lanes of both packages on the same lanes (pixel
ids tiled, sample ids repeated; bit-exact threefry and Sobol draws): the
four variants, direct lighting and the three AOVs, under the random,
sobol, stratified and debug samplers and the tent filter, on Cornell
boxes (the default one with its mirror and glass spheres, and one with
glass, point, directional and environment lights) and Veach MIS.
16x16 frames (Veach 24x16), 2 samples a pixel, depth 3.

Tolerance: radiance within rtol=1e-3/atol=1e-4 with at most 0.5% of lanes
outside (tests/torch_jnp.py); the share outside is printed.
"""

import pytest

from kytpu.integrator.path import PathConfig
from kytpu.scene import builders as jb
from kytpu_torch.scene import builders as tb
from tests.torch_jnp import lanes_agree, trace_pair

SCENES = {
    "cornell": lambda b: b.cornell_box(width=16, height=16),
    "cornell_lights": lambda b: b.cornell_box(
        {jb.LARGE_GLASS_SPHERE, jb.LIGHT_POINT, jb.LIGHT_DIRECTION,
         jb.LIGHT_ENVIRONMENT}, 16, 16),
    "veach": lambda b: b.veach_mis(24, 16),
}

CASES = {
    "iteration": ("cornell", dict(variant="iteration"), "path"),
    "simple": ("cornell", dict(variant="simple"), "path"),
    "recursion": ("cornell", dict(variant="recursion"), "path"),
    "defered": ("cornell", dict(variant="defered"), "path"),
    "iteration_lights": ("cornell_lights", {}, "path"),
    "veach_single": ("veach", dict(light_selection="single"), "path"),
    "direct_veach": ("veach", dict(strategy="light_mis"), "direct"),
    "sobol": ("cornell", dict(sampler="sobol"), "path"),
    "stratified": ("cornell", dict(sampler="stratified", strata=(2, 2)),
                   "path"),
    "debug": ("cornell", dict(sampler="debug"), "path"),
    "tent": ("cornell_lights", dict(filter="tent", variant="simple"),
             "path"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_trace_lanes_path(case):
    scene, kw, mode = CASES[case]
    make = SCENES[scene]
    cfg = PathConfig(max_depth=3, **kw)
    ref, got = trace_pair(make(jb), make(tb), cfg, mode, spp=2, seed=5)
    share = lanes_agree(got, ref)
    print(f"{case}: {share:.4f} of {len(ref)} lanes outside the bound")


@pytest.mark.parametrize("which", ["position", "normal", "basecolor"])
def test_trace_lanes_aov(which):
    make = SCENES["cornell_lights"]
    ref, got = trace_pair(make(jb), make(tb), PathConfig(), "aov", which,
                          spp=1, seed=3)
    share = lanes_agree(got, ref)
    print(f"aov {which}: {share:.4f} of lanes outside the bound")
