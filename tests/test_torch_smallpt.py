"""builders.smallpt (kytpu's 9-sphere smallpt Cornell box at 1/100 scale):
its tables bit-identical to kytpu's, the plain K1 lane by lane against
kytpu's K1 in interpret mode (8x8, depth 2, 512 lanes, the forward tests'
bound: at most 0.5% of lanes outside rtol=1e-3/atol=1e-4 and the means
within 3 standard errors), and the trainable exponent's gradient through
K3 and K4 identically 0 (no Phong row), as kytpu's tests/test_kernel.py
asserts for its own kernel. The radius-1,000 wall spheres exercise the
stable sphere quadratic."""

import jax.numpy as jnp
import numpy as np
import torch

from kytpu.kernels import wavefront as jwf
from kytpu.scene import builders as jb
from kytpu_torch.kernels import wavefront as kwf
from kytpu_torch.scene import builders as tb
from tests.test_torch_bigscene_tables import (GEO_FIELDS, LIGHT_FIELDS,
                                              SCENE_FIELDS)
from tests.test_torch_wavefront import camera_rays, lanes_agree


def test_smallpt_tables_match_kytpu():
    jsc, tsc = jb.smallpt(8, 8), tb.smallpt(8, 8)
    for f in SCENE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jsc, f)),
                                      getattr(tsc, f).numpy(), err_msg=f)
    for f in GEO_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jsc.geometry, f)),
                                      getattr(tsc.geometry, f).numpy(),
                                      err_msg=f)
    for f in LIGHT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jsc.lights, f)),
                                      getattr(tsc.lights, f).numpy(),
                                      err_msg=f)
    assert tuple(jsc.lights.surface_ids) == tsc.lights.surface_ids
    for f in ("position", "front", "right", "up"):
        np.testing.assert_array_equal(np.asarray(getattr(jsc.camera, f)),
                                      getattr(tsc.camera, f).numpy())
    assert jwf.extract_static(jsc) == kwf.extract_static(tsc)


def test_smallpt_k1_matches_kytpu():
    jsc, tsc = jb.smallpt(8, 8), tb.smallpt(8, 8)
    kw = dict(max_depth=2, rows=8, sampler="hash")
    o, d, si, pix = camera_rays(jsc, 512)
    ref = np.asarray(jwf.make_pallas_tracer(
        jsc, jwf.KernelConfig(**kw), interpret=True)(
            jsc, jnp.asarray(o), jnp.asarray(d), jnp.int32(7),
            jnp.asarray(si), jnp.asarray(pix)))
    cfg = kwf.KernelConfig(**kw)
    got = kwf.trace_lanes(kwf.pack_tables(tsc, cfg), cfg,
                          *map(torch.tensor, (o, d)), 7,
                          *map(torch.tensor, (si, pix))).numpy()
    lanes_agree(got, ref)
    assert ref.mean() > 0


def test_smallpt_exponent_gradient_is_zero():
    sc = tb.smallpt(8, 8)
    cfg = kwf.KernelConfig(max_depth=3, rows=8, trainable_exponent=True)
    o, d, _, _ = camera_rays(jb.smallpt(8, 8), 256)
    o, d = torch.tensor(o), torch.tensor(d)
    for backward in ("residual", "replay"):
        leaves = [t.clone().requires_grad_() for t in (
            sc.mat_diffuse, sc.mat_specular, sc.emission, sc.mat_exponent)]
        out = kwf.make_cuda_diff_tracer(sc, cfg, backward=backward)(
            *leaves, torch.zeros(3), o, d, 5)
        out.sum().backward()
        assert torch.isfinite(out).all() and float(out.mean()) > 0
        assert (leaves[3].grad == 0).all(), backward
        assert float(leaves[0].grad.abs().max()) > 0
