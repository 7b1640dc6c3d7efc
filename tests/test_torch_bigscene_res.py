"""The plain big-scene residual forward K6 and cache backward K7 against
kytpu's, through the autograd of each package's diff tracer.

The same numpy-seeded lanes, seed and upstream gradient go through
`jax.vjp` of kytpu's `make_bigscene_diff_tracer` (K6 and K7 in interpret
mode, sweep="scalar") and through `torch.autograd` of the port's
`make_bigscene_diff_tracer` on CPU tensors: random_spheres(n=80), 1024
lanes at depth 2, rows=8, the hash sampler with the trainable exponent
(test_torch_bigscene_res_robust.py: random sampler, robust shadows).

Tolerances:
- radiance: as the forward tests (at most 0.5% of lanes outside
  rtol=1e-3/atol=1e-4);
- gradients (dd, ds, de, [dexp,] denv): |port - kytpu| <= 1e-4 |kytpu| +
  1e-6 max(1, max|kytpu|) per table; both sum in fixed but different
  orders (the port by row in a sorted order, kytpu by segment_sum);
- cache: kytpu's residual planes, read from the vjp's residuals. The
  port's K6 writes 0 for the bounces a lane never reached (kytpu keeps
  tracing the dead lane's frozen ray and caches that hit's colours and
  row, with zero coefficients), so the float planes are compared on the
  bounces a lane reached (b = 0, or "tu" of b - 1 not 0) and the int
  planes where the port's entry is not 0: on all but 0.5% of lanes, every
  float plane within rtol=1e-3/atol=1e-4 and every int entry equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kytpu.kernels import bigscene as jbs
from kytpu.kernels import wavefront as jwf
from kytpu.scene import builders as jb
from kytpu_torch.kernels import bigscene as kbs
from kytpu_torch.kernels import wavefront as kwf
from kytpu_torch.scene import builders as tb
from tests.test_torch_bigscene import camera_lanes, lanes_agree, spheres


def vjp_both(sampler, shadow, texp, depth=2, n=1024, seed=5):
    jsc, tsc = spheres(jb), spheres(tb)
    o, d, si, pix = camera_lanes(jsc, n)
    g = np.random.default_rng(3).standard_normal((n, 3)).astype(np.float32)
    env = np.asarray(jsc.env_radiance_, np.float32)
    kw = dict(max_depth=depth, rows=8, sampler=sampler, shadow=shadow,
              trainable_exponent=texp)
    jt = [jsc.mat_diffuse, jsc.mat_specular, jsc.emission] + (
        [jsc.mat_exponent] if texp else []) + [jnp.asarray(env)]
    tracer = jbs.make_bigscene_diff_tracer(
        jsc, jwf.KernelConfig(sweep="scalar", **kw), interpret=True)
    extra = ((jnp.asarray(si), jnp.asarray(pix)) if sampler != "random"
             else ())
    out, vjp = jax.vjp(lambda *p: tracer(*p, jnp.asarray(o), jnp.asarray(d),
                                         jnp.int32(seed), *extra), *jt)
    jg = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    res = [np.asarray(x) for x in jax.tree_util.tree_leaves(vjp)
           if getattr(x, "ndim", 0) == 3]
    jresf = next(x for x in res if x.dtype == np.float32)
    jresi = next(x for x in res if x.dtype == np.int32)

    cfg = kwf.KernelConfig(**kw)
    leaves = [torch.from_numpy(np.array(x)).requires_grad_() for x in jt]
    lanes = [torch.from_numpy(a) for a in (o, d, si, pix)]
    out_t = kbs.make_bigscene_diff_tracer(tsc, cfg)(
        *leaves, lanes[0], lanes[1], seed, lanes[2], lanes[3])
    out_t.backward(torch.from_numpy(g))
    _, resf, resi = kbs.trace_lanes_plain(
        kbs.pack_big_tables(tsc, cfg), cfg, *lanes[:2], seed, *lanes[2:],
        residual=True)
    got = (out_t.detach().numpy(), [t.grad.numpy() for t in leaves],
           resf.numpy(), resi.numpy())
    ref = (np.asarray(out), jg, jresf.reshape(len(jresf), -1)[:, :n],
           jresi.reshape(len(jresi), -1)[:, :n])
    return got, ref, cfg, len(tsc.lights.kinds)


def check_against_kytpu(sampler, shadow, texp):
    got, ref, cfg, n_lights = vjp_both(sampler, shadow, texp)
    lanes_agree(got[0], ref[0])
    for a, b in zip(got[1], ref[1]):
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6 * scale)
    assert all(np.abs(a).max() > 1e-3 for a in got[1][:3])
    resf, resi = got[2:]
    jresf, jresi = ref[2:]
    assert resf.shape == jresf.shape and resi.shape == jresi.shape
    ix, _ = kbs.bigres_layout(cfg, n_lights, True)
    reached = [np.ones(resf.shape[1], bool)]
    for b in range(cfg.max_depth):
        reached.append(reached[-1] & (resf[ix[("tu", b)]] != 0))
    bad = ((resi != 0) & (resi != jresi)).any(0)
    for tag, k in ix.items():
        bad |= reached[tag[1]] & ~np.isclose(resf[k], jresf[k], rtol=1e-3,
                                             atol=1e-4)
    assert bad.mean() <= 0.005, bad.mean()
    assert reached[1].mean() > 0.3   # the cache covers secondary bounces


def test_k6_k7_match_kytpu_hash_exponent():
    check_against_kytpu("hash", "parity", texp=True)
