"""The plain residual forward (K2) and coefficient-cache backward (K3)
against kytpu's, on the default Cornell box (the all-lights Cornell box is in
test_torch_wavefront_res_lights.py).

The same numpy-seeded rays, seed and upstream gradient go through
`jax.vjp` of kytpu's `make_pallas_diff_tracer` (K2 and K3 in interpret mode)
and through `torch.autograd` of the port's `make_cuda_diff_tracer` on CPU
tensors (the plain versions), 2048 lanes at depth 2, rows=8.

Tolerances:
- gradients: |port - kytpu| <= 1e-4 |kytpu| + 1e-6 max|kytpu| per table
  (float32 sums over 2048 lanes taken in another order); entries that are
  structurally zero (a mirror row's diffuse, a matte row's specular, a
  non-light row's emission, env without an environment) are exactly 0 in
  both;
- cache: kytpu's residual planes, read from the vjp's residuals: every
  float plane within rtol=1e-3/atol=1e-4 and every int entry the port marks
  live (resi != 0) equal to kytpu's in bits 0-9, on all but 0.5% of lanes,
  the bound of the forward tests (test_torch_wavefront.py); the port writes
  0 where a lane died, kytpu the sid of its frozen ray.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kytpu import bsdf as jbsdf
from kytpu.kernels import wavefront as jwf
from kytpu.light import lights as jlights
from kytpu.scene import builders as jb
from kytpu_torch.kernels import wavefront as twf
from kytpu_torch.scene import builders as tb
from tests.test_torch_wavefront import SCENES, camera_rays

N = 2048


def trace_grads(name, sampler, nee, n=N, seed=7):
    """kytpu's and the port's (radiance, (dd, ds, de, denv), resf, resi) on
    the same lanes and upstream gradient, all numpy."""
    jsc, tsc = SCENES[name](jb), SCENES[name](tb)
    kw = dict(max_depth=2, rr_start=0, rows=8, sampler=sampler, nee=nee,
              shadow="parity")
    o, d, si, pix = camera_rays(jsc, n)
    g = np.random.default_rng(3).standard_normal((n, 3)).astype(np.float32)
    env = (np.asarray(jsc.env_radiance_, np.float32) if jsc.has_env
           else np.zeros(3, np.float32))

    tracer = jwf.make_pallas_diff_tracer(jsc, jwf.KernelConfig(**kw),
                                         interpret=True)
    extra = ((jnp.asarray(si), jnp.asarray(pix)) if sampler == "hash"
             else ())
    out, vjp = jax.vjp(
        lambda a, b, c, e: tracer(a, b, c, e, jnp.asarray(o), jnp.asarray(d),
                                  jnp.int32(seed), *extra),
        jsc.mat_diffuse, jsc.mat_specular, jsc.emission, jnp.asarray(env))
    jgrads = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    # the custom vjp's residuals: resf (res_n, rows, 128), resi (D+1, ...)
    res = [np.asarray(x) for x in jax.tree_util.tree_leaves(vjp)
           if getattr(x, "ndim", 0) == 3]
    jresf = next(x for x in res if x.dtype == np.float32)
    jresi = next(x for x in res if x.dtype == np.int32)
    ref = (np.asarray(out), jgrads, jresf.reshape(len(jresf), -1)[:, :n],
           jresi.reshape(len(jresi), -1)[:, :n])

    cfg = twf.KernelConfig(**kw)
    leaves = [t.clone().requires_grad_() for t in (
        tsc.mat_diffuse, tsc.mat_specular, tsc.emission, torch.tensor(env))]
    lanes = [torch.from_numpy(np.array(a)) for a in (o, d, si, pix)]
    out_t = twf.make_cuda_diff_tracer(tsc, cfg)(*leaves, lanes[0], lanes[1],
                                                seed, lanes[2], lanes[3])
    out_t.backward(torch.from_numpy(g))
    tables = twf._DiffTables(tsc, cfg)(*[t.detach() for t in leaves])
    big_l, resf, resi = twf.trace_lanes_plain(tables, cfg, *lanes[:2], seed,
                                              *lanes[2:], residual=True)
    np.testing.assert_array_equal(big_l.numpy(), out_t.detach().numpy())
    got = (big_l.numpy(), [t.grad.numpy() for t in leaves], resf.numpy(),
           resi.numpy())
    return got, ref, jwf.extract_static(jsc)


def grads_agree(got, ref, static):
    kinds = np.asarray(static["mats"]["kind"])
    light = np.asarray(static["mats"]["light_index"]) >= 0
    has_env = any(lt["kind"] == jlights.ENV for lt in static["lights"])
    structural = [kinds == jbsdf.MAT_MIRROR, kinds == jbsdf.MAT_MATTE, ~light,
                  np.array(not has_env)]
    for name, a, b, zero in zip(("dd", "ds", "de", "denv"), got, ref,
                                structural):
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6 * scale,
                                   err_msg=name)
        assert (a[zero] == 0).all() and (b[zero] == 0).all(), name
    assert any(np.abs(a).max() > 1e-3 for a in got)   # not trivially zero


def cache_agrees(got, ref, max_share=0.005):
    resf, resi = got
    jresf, jresi = ref
    assert resf.shape == jresf.shape and resi.shape == jresi.shape
    bad_f = ~np.isclose(resf, jresf, rtol=1e-3, atol=1e-4)
    live = resi != 0
    bad_i = live & ((resi & 0x3FF) != jresi)
    share = (bad_f.any(0) | bad_i.any(0)).mean()
    assert share <= max_share, share
    return share


CASES = [("random", "all"), ("hash", "all"), ("random", "single")]


@pytest.fixture(scope="module", params=CASES, ids=["-".join(c) for c in CASES])
def cornell(request):
    return trace_grads("cornell", *request.param)


def test_radiance_matches_kytpu(cornell):
    (big_l, *_), (ref_l, *_), _ = cornell
    np.testing.assert_allclose(big_l, ref_l, rtol=1e-3, atol=1e-4)


def test_gradients_match_kytpu(cornell):
    got, ref, static = cornell
    grads_agree(got[1], ref[1], static)


def test_cache_matches_kytpu(cornell):
    got, ref, _ = cornell
    cache_agrees(got[2:], ref[2:])


def test_residual_radiance_is_k1s():
    """K2's radiance is K1's arithmetic: the plain versions agree bit for
    bit, and so do their CPU wrappers."""
    sc = SCENES["cornell_lights"](tb)
    o, d, si, pix = camera_rays(SCENES["cornell_lights"](jb), 512)
    lanes = [torch.from_numpy(np.array(a)) for a in (o, d, si, pix)]
    for sampler, nee in (("random", "all"), ("hash", "single")):
        cfg = twf.KernelConfig(max_depth=3, rr_start=1, rows=1,
                               sampler=sampler, nee=nee)
        tables = twf.pack_tables(sc, cfg)
        k1 = twf.trace_lanes(tables, cfg, *lanes[:2], 11, *lanes[2:])
        k2, resf, resi = twf.trace_lanes(tables, cfg, *lanes[:2], 11,
                                         *lanes[2:], residual=True)
        np.testing.assert_array_equal(k1.numpy(), k2.numpy())
        assert resf.shape == (twf.residual_layout(tables.static, cfg)[1], 512)
        assert resi.shape == (4, 512) and resi.dtype == torch.int32


def test_sum_lanes_is_a_sum():
    """K3's fixed-order reduction is a sum over lanes (checked against
    float64), for lane counts that fill blocks partly and pass the second
    pass's stride."""
    rng = np.random.default_rng(0)
    for n in (1, 129, 128 * 256 + 77):
        acc = rng.standard_normal((n, 5)).astype(np.float32)
        got = twf.sum_lanes(torch.from_numpy(acc)).numpy()
        np.testing.assert_allclose(got, acc.astype(np.float64).sum(0),
                                   rtol=1e-5, atol=1e-3)
