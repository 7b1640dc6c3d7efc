"""The port's frame entry points on the jnp engines
(kytpu_torch/integrator/render.py) against kytpu's: render(engine="jnp")
and engine="fast" through passes of `rays_per_pass` lanes, render_aov,
a sphere-UV-textured scene and an image texture past the kernels' cap
(both only the jnp engines render); render_region against the frame's
crop and debug_pixel against its pixel (to the bit, in the port);
debug_area; and a PathConfig given to engine="cuda", which runs the
KernelConfig kytpu maps it to.

Tolerance: pixels within rtol=1e-3/atol=1e-4 with at most 0.5% outside
(tests/torch_jnp.py), each the mean of 4 samples.
"""

import numpy as np
import pytest
import torch

from kytpu.integrator.fast import FastConfig
from kytpu.integrator.path import PathConfig
from kytpu.scene import builders as jb
from kytpu_torch.integrator import path as tpath
from kytpu_torch.kernels import wavefront as twf
from kytpu_torch.scene import builders as tb
from tests.torch_jnp import jrender, lanes_agree, port_cfg, trender

_RNG = np.random.default_rng(8)
IMG = _RNG.uniform(0.1, 0.9, (8, 8, 3)).astype(np.float32)
BIG = _RNG.uniform(0.1, 0.9, (257, 256, 3)).astype(np.float32)


def _textured_sphere(b, w=16, h=16):
    """A floor and two textured spheres (a checker and an image) under the
    sky and a point light: sphere uv, which the kernels do not take."""
    a = b._SceneAssembler()
    chk = a.add_checker(np.full(3, 0.2, np.float32),
                        np.full(3, 0.8, np.float32), scale=(4.0, 2.0))
    img = a.add_image_texture(IMG)
    a.surface(a.geo.add_rectangle((-3, -1, -3), (-3, -1, 3), (3, -1, 3),
                                  (3, -1, -3)),
              a.matte(np.full(3, 0.5, np.float32)))
    a.surface(a.geo.add_sphere((-0.6, 0.0, 0.0), 0.5),
              a.matte(np.full(3, 0.5, np.float32), texture=chk))
    a.surface(a.geo.add_sphere((0.7, 0.0, 0.3), 0.5),
              a.plastic(np.full(3, 0.5, np.float32), np.full(3, 0.3,
                                                             np.float32),
                        20.0, texture=img))
    a.add_light(kind=b.klights.ENV, emit=np.full(3, 0.8, np.float32))
    a.add_light(kind=b.klights.POINT, emit=np.full(3, 6.0, np.float32),
                position=np.array([0.0, 3.0, 2.0], np.float32))
    return a.build(b.kscene.make_camera((0, 1, 6), (0, -0.2, -1), (0, 1, 0),
                                        50.0, w, h))


SCENES = {
    "cornell": lambda b: b.cornell_box(width=16, height=16),
    "veach": lambda b: b.veach_mis(24, 16),
    "sphere_uv": _textured_sphere,
    "big_image": lambda b: b.cornell_box(width=12, height=12, back_image=BIG),
}

CASES = {
    "cornell_path": ("cornell", PathConfig(max_depth=3), "jnp", "path"),
    "cornell_fast_mode": ("cornell", PathConfig(max_depth=3), "jnp", "fast"),
    "veach_fast": ("veach", FastConfig(max_depth=2), "fast", "path"),
    "veach_direct": ("veach", PathConfig(), "path", "direct"),
    "cornell_stratified": ("cornell", PathConfig(max_depth=2,
                                                 sampler="stratified"),
                           "jnp", "path"),
    "sphere_uv": ("sphere_uv", PathConfig(max_depth=3), "jnp", "path"),
    "sphere_uv_fast": ("sphere_uv", FastConfig(max_depth=3), "jnp", "path"),
    "big_image": ("big_image", PathConfig(max_depth=2), "jnp", "path"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_render_matches_kytpu(case):
    scene, cfg, engine, mode = CASES[case]
    make = SCENES[scene]
    tsc = make(tb)
    # passes of half the frame's pixels, one sample each
    npix = tsc.camera.width * tsc.camera.height
    kw = dict(spp=4, seed=11, mode=mode, clamp=False,
              rays_per_pass=npix // 2)
    ref = np.asarray(jrender.render(make(jb), cfg=cfg, engine=engine, **kw))
    got = trender.render(tsc, cfg=port_cfg(cfg), engine=engine,
                         device="cpu", **kw).numpy()
    assert got.shape == ref.shape
    share = lanes_agree(got.reshape(-1, 3), ref.reshape(-1, 3))
    print(f"{case}: {share:.4f} of pixels outside the bound")


def test_render_aov_matches_kytpu():
    make = SCENES["sphere_uv"]
    ref = np.asarray(jrender.render_aov(make(jb), "basecolor", spp=2))
    got = trender.render_aov(make(tb), "basecolor", spp=2,
                             device="cpu").numpy()
    lanes_agree(got.reshape(-1, 3), ref.reshape(-1, 3))


@pytest.mark.parametrize("cfg", [tpath.PathConfig(max_depth=3),
                                 tpath.PathConfig(max_depth=3,
                                                  sampler="sobol")])
def test_region_is_the_frames_crop(cfg):
    """A region re-rendered one sample a pass equals the frame rendered in
    passes of 100 lanes, cropped, to the bit; so does debug_pixel, and
    debug_area composites it inside a red border."""
    sc = tb.veach_mis(24, 16)
    kw = dict(spp=3, seed=2, cfg=cfg, clamp=False, device="cpu")
    frame = trender.render(sc, engine="jnp", rays_per_pass=100, **kw)
    region = trender.render_region(sc, 5, 3, 19, 11, **kw)
    assert torch.equal(region, frame[3:11, 5:19])
    assert torch.equal(trender.debug_pixel(sc, 7, 9, **kw), frame[9, 7])
    full = np.zeros((16, 24, 3), np.float32)
    out = trender.debug_area(sc, full, 5, 3, 19, 11, **kw)
    assert np.array_equal(out[4:10, 6:18], frame[4:10, 6:18].numpy())
    assert (out[3, 5:19] == [1.0, 0.0, 0.0]).all()
    assert not out[:3].any()


def test_path_config_routed_to_the_kernel():
    """engine="cuda" with a PathConfig runs the KernelConfig kytpu maps it
    to (max_depth, sobol or random, shadow), here the plain K1."""
    sc = tb.cornell_box(width=8, height=8)
    cfg = tpath.PathConfig(max_depth=2, sampler="sobol", shadow="robust",
                           variant="simple")
    kcfg = twf.KernelConfig(max_depth=2, sampler="sobol", shadow="robust")
    assert trender._kernel_config(cfg) == kcfg
    assert trender._kernel_config(tpath.PathConfig(sampler="stratified")) \
        == twf.KernelConfig()
    kw = dict(spp=2, seed=4, clamp=False, device="cpu", engine="cuda")
    assert torch.equal(trender.render(sc, cfg=cfg, **kw),
                       trender.render(sc, cfg=kcfg, **kw))


def test_modes_and_engines_refused():
    sc = tb.cornell_box(width=4, height=4)
    with pytest.raises(ValueError, match="mode"):
        trender.render(sc, spp=1, engine="jnp", mode="bogus", device="cpu")
    with pytest.raises(ValueError, match="engine='jnp'"):
        trender.render(sc, spp=1, engine="cuda", mode="aov", aov="normal",
                       device="cpu")
    with pytest.raises(ValueError, match="KernelConfig"):
        trender.render(sc, spp=1, engine="jnp", cfg=twf.KernelConfig(),
                       device="cpu")
    with pytest.raises(ValueError, match="AOV"):
        trender.render_aov(sc, "bogus", spp=1, device="cpu")
