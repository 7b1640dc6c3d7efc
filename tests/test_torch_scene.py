"""kytpu_torch's scenes against kytpu's: builder tables bit for bit, the
numpy bridge, extract_static and camera rays."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kytpu.kernels import wavefront as jwf
from kytpu.scene import builders as jb
from kytpu.scene import scene as jscene
from kytpu_torch.kernels import wavefront as twf
from kytpu_torch.scene import builders as tb
from kytpu_torch.scene import scene as tscene

ALL_LIGHTS = {jb.LARGE_GLASS_SPHERE, jb.LIGHT_POINT, jb.LIGHT_DIRECTION,
              jb.LIGHT_ENVIRONMENT}
CORNELL_FLAGS = [
    jb.DEFAULT_SCENE,
    {jb.LIGHT_AREA}, {jb.LIGHT_DIRECTION}, {jb.LIGHT_POINT},
    {jb.LIGHT_ENVIRONMENT},
    {jb.LARGE_MIRROR_SPHERE, jb.LIGHT_AREA},
    {jb.LARGE_GLASS_SPHERE, jb.LIGHT_AREA},
    {jb.SMALL_MIRROR_SPHERE, jb.LIGHT_POINT},
    {jb.SMALL_GLASS_SPHERE, jb.LIGHT_ENVIRONMENT},
    ALL_LIGHTS,
]


def assert_same_tables(ref, got, path="scene"):
    """Every tensor field equals the JAX package's leaf bit for bit."""
    if dataclasses.is_dataclass(got):
        for f in dataclasses.fields(got):
            assert_same_tables(getattr(ref, f.name), getattr(got, f.name),
                               f"{path}.{f.name}")
    elif isinstance(got, torch.Tensor):
        a = np.atleast_1d(np.asarray(ref))
        b = np.atleast_1d(got.numpy())
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), path
    else:
        assert ref == got, path


@pytest.mark.parametrize("flags", CORNELL_FLAGS,
                         ids=lambda f: "+".join(sorted(f)))
def test_cornell_tables_bit_identical(flags):
    ref = jax.device_get(jb.cornell_box(flags, width=16, height=12))
    assert_same_tables(ref, tb.cornell_box(flags, width=16, height=12))


@pytest.mark.parametrize("swap", [False, True])
def test_veach_tables_bit_identical(swap):
    ref = jax.device_get(jb.veach_mis(40, 24, replicate_reference_swap=swap))
    assert_same_tables(ref, tb.veach_mis(40, 24,
                                         replicate_reference_swap=swap))


@pytest.mark.parametrize("make", [lambda b: b.veach_mis(20, 12),
                                  lambda b: b.cornell_box(ALL_LIGHTS, 8, 8)])
def test_scene_from_numpy_round_trip(make):
    ref = jax.device_get(make(jb))
    ported = tscene.scene_from_numpy(ref)
    assert_same_tables(ref, ported)
    assert_same_tables(ref, ported.to("cpu"))


@pytest.mark.parametrize("make", [lambda b: b.veach_mis(20, 12),
                                  lambda b: b.cornell_box(width=8, height=8),
                                  lambda b: b.cornell_box(ALL_LIGHTS, 8, 8)])
def test_extract_static_same_dict(make):
    assert twf.extract_static(make(tb)) == jwf.extract_static(make(jb))


@pytest.mark.parametrize("make", [lambda b: b.veach_mis(512, 308),
                                  lambda b: b.cornell_box(width=256,
                                                          height=256)])
def test_generate_rays_match(make):
    """Same film points -> the rays of kytpu's jitted frame renderer, to
    1 ulp (in practice bit for bit)."""
    jsc, tsc = make(jb), make(tb)
    w, h = jsc.camera.width, jsc.camera.height
    pf = (np.random.default_rng(0).random((20000, 2))
          * np.array([w, h])).astype(np.float32)
    o_r, d_r = jax.jit(lambda p: jscene.generate_rays(jsc.camera, p))(
        jnp.asarray(pf))
    o_t, d_t = tscene.generate_rays(tsc.camera, torch.from_numpy(pf))
    np.testing.assert_array_equal(np.asarray(o_r), o_t.numpy())
    ulps = np.abs(np.asarray(d_r).view(np.int32)
                  - d_t.numpy().view(np.int32))
    assert ulps.max() <= 1
