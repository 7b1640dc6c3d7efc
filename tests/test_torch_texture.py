"""Textures in the port against kytpu's: the texture module, the builders'
textured scenes and their kernel tables, the plain K1 with in-kernel
textures, and what the kernels refuse.

Scenes (kytpu's texture demos, ported): cornell_box(floor_checker=True),
a checkered matte floor; cornell_box(back_image=img) with an 8x8 atlas,
which kytpu fetches through its select chain (at most 64 texels,
power-of-two sides), and a 16x16 one, past the chain's cap, which it
fetches through its separable matmul route. The port fetches both with one
four-tap gather and keeps each route's addition order
(kernels/wavefront.py `_image_color`).

- scene/texture.py: tables bit-identical to kytpu's; `eval_texture`
  within 1e-6 of kytpu's on random uv (two products and sums a texel);
- the builders' scenes and `scene_from_numpy` of kytpu's: every table
  bit-identical, and `extract_static`'s texture records and uv bakes
  equal to kytpu's;
- the plain K1 lane by lane against kytpu's K1 in interpret mode (2048
  lanes, depth 2, rows=8, hash sampler), the bound of
  test_torch_wavefront.py: at most 0.5% of lanes outside rtol=1e-3 /
  atol=1e-4 and the means within 3 standard errors
  (test_torch_texture_select.py: the 8x8 atlas);
- refusals, as kytpu's: a texture bound to a sphere and an atlas past
  65,536 texels; a textured scene past 64 surfaces, refused before the
  big-scene kernels took textures, renders and trains through them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kytpu.kernels import wavefront as jwf
from kytpu.scene import builders as jb
from kytpu.scene import texture as jtex
from kytpu_torch.core import rng as trng
from kytpu_torch.diff import inverse as tinv
from kytpu_torch.integrator.render import render
from kytpu_torch.kernels import bigscene as kbs
from kytpu_torch.kernels import wavefront as twf
from kytpu_torch.scene import builders as tb
from kytpu_torch.scene import texture as ttex
from kytpu_torch.scene.scene import scene_from_numpy
from tests.test_torch_wavefront import camera_rays, lanes_agree

_RNG = np.random.default_rng(4)
IMG4 = _RNG.uniform(0.1, 0.9, (4, 4, 3)).astype(np.float32)
IMG8 = _RNG.uniform(0.1, 0.9, (8, 8, 3)).astype(np.float32)
IMG16 = _RNG.uniform(0.1, 0.9, (16, 16, 3)).astype(np.float32)
SCENES = {
    "checker": dict(floor_checker=True),
    "img4": dict(back_image=IMG4),
    "img8": dict(back_image=IMG8),
    "img16": dict(back_image=IMG16),
}


def cornell(b, name, width=24, height=16):
    return b.cornell_box(width=width, height=height, **SCENES[name])


def trace_both(name, n=2048, seed=7, max_depth=2):
    """(port plain K1, kytpu interpret-mode K1) radiance on the same
    lanes of a textured Cornell box."""
    jsc, tsc = cornell(jb, name), cornell(tb, name)
    kw = dict(max_depth=max_depth, rr_start=0, rows=8, sampler="hash")
    o, d, si, pix = camera_rays(jsc, n)
    tracer = jwf.make_pallas_tracer(jsc, jwf.KernelConfig(**kw),
                                    interpret=True)
    ref = np.asarray(tracer(jsc, jnp.asarray(o), jnp.asarray(d),
                            jnp.int32(seed), jnp.asarray(si),
                            jnp.asarray(pix)))
    cfg = twf.KernelConfig(**kw)
    got = twf.trace_lanes_plain(twf.pack_tables(tsc, cfg), cfg,
                                torch.from_numpy(o), torch.from_numpy(d),
                                seed, torch.from_numpy(si),
                                torch.from_numpy(pix))
    return got.numpy(), ref


def test_texture_module_matches_kytpu():
    entries = [dict(kind=ttex.CHECKER, color_a=np.float32([0.1, 0.2, 0.3]),
                    color_b=np.float32([0.9, 0.8, 0.7]), scale=(6.0, 3.0)),
               dict(kind=ttex.IMAGE, image=IMG8, scale=(2.0, 1.0)),
               dict(kind=ttex.IMAGE, image=IMG8[::-1].copy())]
    jt = jtex.build([dict(e) for e in entries])
    tt = ttex.build(entries)
    for f in ("kind", "color_a", "color_b", "scale", "image_index", "image"):
        a, b = np.asarray(getattr(jt, f)), getattr(tt, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    rng = np.random.default_rng(0)
    uv = rng.uniform(-2.0, 2.0, (512, 2)).astype(np.float32)
    tid = rng.integers(0, 3, 512).astype(np.int32)
    ref = np.asarray(jtex.eval_texture(jt, jnp.asarray(tid), jnp.asarray(uv)))
    got = ttex.eval_texture(tt, torch.from_numpy(tid),
                            torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert ttex.empty().n_textures == 0


@pytest.mark.parametrize("name", ["checker", "img8", "img16"])
def test_textured_tables_match_kytpu(name):
    jsc, tsc = cornell(jb, name), cornell(tb, name)
    back = scene_from_numpy(jax.device_get(jsc))
    for sc in (tsc, back):
        assert sc.has_textures and np.array_equal(np.asarray(jsc.tex_id),
                                                  sc.tex_id.numpy())
        for f in ("kind", "color_a", "color_b", "scale", "image_index",
                  "image"):
            a, b = np.asarray(getattr(jsc.textures, f)), \
                getattr(sc.textures, f).numpy()
            assert a.shape == b.shape and np.array_equal(a, b), f
        for f in ("mat_kind", "mat_diffuse", "mat_d_prob", "mat_s_prob"):
            assert np.array_equal(np.asarray(getattr(jsc, f)),
                                  getattr(sc, f).numpy()), f
    js, ts = jwf.extract_static(jsc), twf.extract_static(tsc)
    assert ts["textures"] == js["textures"]
    for k in ("n_textures", "n_texels", "n_images"):
        assert ts[k] == js[k], k
    for a, b in zip(js["planar"], ts["planar"]):
        for k in ("uv_anchor", "uv_f1", "uv_f2", "uv_disk"):
            assert a.get(k) == b.get(k), k
    assert [r.get("sep", False) for r in ts["textures"]] == (
        [True] if name == "img16" else [False])
    assert twf.kernel_texture_support(tsc) is None


@pytest.mark.parametrize("name", ["checker", "img16"])
def test_textured_k1_matches_kytpu(name):
    got, ref = trace_both(name)
    lanes_agree(got, ref)


def _sphere_textured(b):
    a = b._SceneAssembler()
    tex = a.add_checker(np.full(3, 0.2, np.float32),
                        np.full(3, 0.8, np.float32))
    a.surface(a.geo.add_rectangle((-3, -1, -3), (-3, -1, 3), (3, -1, 3),
                                  (3, -1, -3)),
              a.matte(np.full(3, 0.5, np.float32)))
    a.surface(a.geo.add_sphere((0.0, 0.0, 0.0), 0.5),
              a.matte(np.full(3, 0.5, np.float32), texture=tex))
    a.add_light(kind=b.klights.ENV, emit=np.ones(3, np.float32))
    return a.build(b.kscene.make_camera((0, 1, 6), (0, -0.2, -1), (0, 1, 0),
                                        50.0, 4, 4))


def test_unsupported_textures_raise():
    # a texture on a sphere: planar surfaces only, as kytpu's kernels
    jsc, tsc = _sphere_textured(jb), _sphere_textured(tb)
    assert jwf._kernel_texture_support(jsc) is not None
    assert "planar" in twf.kernel_texture_support(tsc)
    with pytest.raises(NotImplementedError, match="planar"):
        render(tsc, spp=1, device="cpu")
    with pytest.raises(NotImplementedError, match="planar"):
        twf.make_cuda_diff_tracer(tsc)
    # an atlas past 65,536 texels
    big = np.full((257, 256, 3), 0.5, np.float32)
    assert jwf._kernel_texture_support(
        jb.cornell_box(width=4, height=4, back_image=big)) is not None
    tsc = tb.cornell_box(width=4, height=4, back_image=big)
    with pytest.raises(NotImplementedError, match="65536"):
        render(tsc, spp=1, device="cpu")
    # a textured scene past 64 surfaces: the textured big-scene kernels
    a = tb._SceneAssembler()
    tex = a.add_image_texture(IMG4)
    a.surface(a.geo.add_rectangle((-9, 0, -9), (-9, 0, 9), (9, 0, 9),
                                  (9, 0, -9)),
              a.matte(tb._full(0.5), texture=tex))
    for k in range(70):
        a.surface(a.geo.add_sphere((k % 10 - 5.0, 0.3, k // 10 - 3.0), 0.2),
                  a.matte(tb._full(0.5)))
    a.add_light(kind=tb.klights.ENV, emit=tb._full(1.0))
    sc = a.build(tb.kscene.make_camera((0, 3, 9), (0, -0.3, -1), (0, 1, 0),
                                       50.0, 4, 4))
    frames = [render(sc, spp=1, engine=engine, device="cpu")
              for engine in ("cuda", "bigscene")]
    assert torch.equal(*frames) and float(frames[0].mean()) > 0
    tracer = kbs.make_bigscene_diff_tracer(sc, backward="replay")
    assert tracer.tabs.has_img and isinstance(tracer.tabs, kbs._BigDiffTables)
    step, params, _ = tinv.make_train_step(
        sc, np.zeros((4, 4, 3), np.float32), spp=1, max_depth=1,
        device="cpu", names=("tex_image",))
    assert np.isfinite(float(step(trng.key(0))))
    assert params["tex_image"].shape == (1, 4, 4, 3)
    # a texture leaf the scene does not read
    with pytest.raises(ValueError, match="tex_image"):
        tinv.make_train_step(cornell(tb, "checker", 4, 4),
                             np.zeros((4, 4, 3), np.float32), device="cpu",
                             names=("tex_image",))
