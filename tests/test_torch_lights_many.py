"""K1-K8 past 32 lights and 64 textures: the port's plain versions against
kytpu's kernels run interpreted, on scenes both packages build from the
same numpy arrays (tests/test_torch_cuda.py many_lights: a point light and
sphere lights in a row, and a floor of checker quads, each with a texture
of its own).

Every case runs shadow="robust": under "parity" the sphere lights show the
self-occlusion near-tie that test_torch_wavefront_veach.py describes (a
scene of a point and one sphere light has 0.6% of its lanes outside the
bound in K1 and K5 alike).

- K1 at 33 lights (nee="single", random sampler: kytpu's interpreted K1
  with every light's shadow ray, nee="all", takes minutes to trace at 33
  lights), 1,024 lanes, depth 1, against kytpu's K1: the bound of the
  other forward tests (at most 0.5% of lanes outside rtol=1e-3/atol=1e-4,
  the means within 3 standard errors);
- K2 and K3 there through each package's diff tracer
  (test_torch_lights_many_res.py);
- K4 against K3 at 33 and 64 lights (nee="all", hash; 64 lights is past
  64 surfaces, the row-tagged route), the reference's bound rtol=2e-3
  plus 2e-5 of the table's largest entry;
- K5, K6 and K7 at 33 lights past 64 surfaces (31 more spheres) and on 65
  checker textures against kytpu's table kernels
  (test_torch_lights_many_big.py, test_torch_lights_many_tex.py); K8
  against K7 there, 512 lanes at depth 2 (the reference's bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kytpu.kernels import bigscene as jbs
from kytpu.kernels import wavefront as jwf
from kytpu.scene import builders as jb
from kytpu_torch.kernels import bigscene as kbs
from kytpu_torch.kernels import wavefront as twf
from kytpu_torch.scene import builders as tb
from tests.test_torch_bigscene import camera_lanes, lanes_agree
from tests.test_torch_cuda import many_lights
from tests.test_torch_wavefront import trace_both
import tests.torch_threads  # noqa: F401  (one torch thread a process)

CROSS_RTOL, CROSS_ATOL = 2e-3, 2e-5


def test_k1_past_32_lights_matches_kytpu():
    got, ref = trace_both("many_lights33", "random", "single", "robust",
                          n=1024, max_depth=1)
    lanes_agree(got, ref)
    assert ref.mean() > 0.01


@pytest.mark.parametrize("n_lights", [33, 64])
def test_k4_against_k3_past_32_lights(n_lights):
    sc = many_lights(tb, n_lights)
    cfg = twf.KernelConfig(max_depth=2, rows=8, sampler="hash")
    o, d, si, pix = (torch.from_numpy(np.array(a)) for a in
                     camera_lanes(many_lights(jb, n_lights), 1024))
    tables = twf.pack_tables(sc, cfg)
    assert twf.row_tagged(tables.static) == (n_lights > 63)
    big_l, resf, resi = twf.trace_lanes_plain(tables, cfg, o, d, 5, si, pix,
                                              residual=True)
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1024, 3)).astype(np.float32))
    k3 = twf.bwd_res_plain(tables, cfg, g, big_l, resf, resi)
    k4 = twf.bwd_replay_plain(tables, cfg, o, d, 5, si, pix, g, big_l)
    for a, b in zip(k4, k3):
        scale = max(1.0, float(b.abs().max()))
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=CROSS_RTOL,
                                   atol=CROSS_ATOL * scale)
    assert float(k3[2].abs().max()) > 1e-3   # the lights' emission


SCENES = {
    "lights33": lambda b: many_lights(b, 33, extra_spheres=31),
    "checkers65": lambda b: many_lights(b, 2, n_checkers=65),
}


def big_vjp(name, n=512, seed=5):
    """kytpu's and the port's (radiance, gradients, resf, resi) of the
    big-scene diff tracers on the same lanes and upstream gradient; the
    gradients of (diffuse, specular, emission[, checker a, checker b],
    env)."""
    jsc, tsc = SCENES[name](jb), SCENES[name](tb)
    assert int(tsc.mat_kind.shape[0]) > 64
    o, d, si, pix = camera_lanes(jsc, n)
    g = np.random.default_rng(3).standard_normal((n, 3)).astype(np.float32)
    kw = dict(max_depth=1, rows=8, sampler="hash", shadow="robust")
    jt = [jsc.mat_diffuse, jsc.mat_specular, jsc.emission]
    if jsc.has_textures:
        jt += [jsc.textures.color_a, jsc.textures.color_b]
    jt.append(jnp.zeros(3, jnp.float32))
    # kytpu's cull="off" sweeps every row with the culled sweep's results
    # and traces in less time
    tracer = jbs.make_bigscene_diff_tracer(
        jsc, jwf.KernelConfig(sweep="scalar", cull="off", **kw),
        interpret=True)
    out, vjp = jax.vjp(lambda *p: tracer(*p, jnp.asarray(o), jnp.asarray(d),
                                         jnp.int32(seed), jnp.asarray(si),
                                         jnp.asarray(pix)), *jt)
    jg = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    res = [np.asarray(x) for x in jax.tree_util.tree_leaves(vjp)
           if getattr(x, "ndim", 0) == 3]
    jresf = next(x for x in res if x.dtype == np.float32)
    jresi = next(x for x in res if x.dtype == np.int32)
    cfg = twf.KernelConfig(**kw)
    leaves = [torch.from_numpy(np.array(x)).requires_grad_() for x in jt]
    lanes = [torch.from_numpy(np.array(a)) for a in (o, d, si, pix)]
    out_t = kbs.make_bigscene_diff_tracer(tsc, cfg)(
        *leaves, lanes[0], lanes[1], seed, lanes[2], lanes[3])
    out_t.backward(torch.from_numpy(g))
    tables = kbs.pack_big_tables(tsc, cfg)
    _, resf, resi = kbs.trace_lanes_plain(tables, cfg, *lanes[:2], seed,
                                          *lanes[2:], residual=True)
    got = (out_t.detach().numpy(), [t.grad.numpy() for t in leaves],
           resf.numpy(), resi.numpy())
    ref = (np.asarray(out), jg, jresf.reshape(len(jresf), -1)[:, :n],
           jresi.reshape(len(jresi), -1)[:, :n])
    return got, ref, cfg, tables


@pytest.mark.parametrize("name", list(SCENES))
def test_k8_against_k7_past_the_caps(name):
    """The plain K8 against the plain K7 on the same lanes and gradient
    (depth 2, hash), within the reference's bound."""
    sc = SCENES[name](tb)
    cfg = twf.KernelConfig(max_depth=2, rows=8, sampler="hash",
                           shadow="robust")
    o, d, si, pix = (torch.from_numpy(np.array(a)) for a in
                     camera_lanes(SCENES[name](jb), 512))
    tables = kbs.pack_big_tables(sc, cfg)
    big_l, resf, resi = kbs.trace_lanes_plain(tables, cfg, o, d, 5, si, pix,
                                              residual=True)
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (512, 3)).astype(np.float32))
    k7 = kbs.bwd_res_plain(tables, cfg, g, big_l, resf, resi)
    k8 = kbs.sums_plain(tables, cfg, *kbs.bwd_replay_plain(
        tables, cfg, o, d, 5, si, pix, g, big_l))
    for a, b in zip(k8, k7):
        scale = max(1.0, float(b.abs().max()))
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=CROSS_RTOL,
                                   atol=CROSS_ATOL * scale)
    assert float(k7[2].abs().max()) > 1e-3
