"""The plain big-scene path-replay backward K8 against kytpu's, through the
autograd of each package's diff tracer, and against the port's own K7.

The same numpy-seeded lanes, seed and upstream gradient go through
`jax.vjp` of kytpu's `make_bigscene_diff_tracer(backward="replay")` (K5
and K8 in interpret mode, sweep="scalar") and through `torch.autograd` of
the port's `make_bigscene_diff_tracer(backward="replay")` on CPU tensors:
random_spheres(n=80), 1024 lanes at depth 2, rows=8; here the hash sampler
with the trainable exponent (test_torch_bigscene_replay_random.py: random
sampler, robust shadows; test_torch_bigscene_replay_sobol.py: sobol, and
central differences).

Tolerances:
- gradients against kytpu's K8 (dd, ds, de, [dexp,] denv): |port - kytpu|
  <= 2e-3 |kytpu| + 2e-5 max(1, max|kytpu|) per table, the reference's own
  bound between its two backwards (tests/test_kernel.py:630): the tail
  peel R_{b+1} = (R_b - E_b) / T_b cancels where a bounce's NEE term is
  most of the radiance, so last-bit differences of E_b between XLA's fused
  CPU arithmetic and the port's IEEE steps grow; both sum in fixed but
  different orders (the port by row in a sorted order, kytpu by
  segment_sum);
- against the port's K7 on the same lanes: the same bound (another
  algebra for the same sum: the replay peels T_b = f |cos| / pdf, the
  cache backward colour * tu).
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
from tests.test_torch_bigscene import camera_lanes, spheres
import tests.torch_threads  # noqa: F401  (one torch thread a process)

RTOL, ATOL = 2e-3, 2e-5


def close(got, ref):
    """Each table within RTOL of its entry plus ATOL of its largest."""
    for a, b in zip(got, ref):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL * scale)


def replay_both(sampler, shadow, texp, depth=2, n=1024, seed=5):
    """(the port's K8 gradient, kytpu's K8 gradient, the port's K7
    gradient) of one upstream gradient on one set of lanes."""
    jsc, tsc = spheres(jb), spheres(tb)
    o, d, si, pix = camera_lanes(jsc, n)
    g = np.random.default_rng(3).standard_normal((n, 3)).astype(np.float32)
    env = np.asarray(jsc.env_radiance_, np.float32)
    kw = dict(max_depth=depth, rows=8, sampler=sampler, shadow=shadow,
              trainable_exponent=texp)
    jt = [jsc.mat_diffuse, jsc.mat_specular, jsc.emission] + (
        [jsc.mat_exponent] if texp else []) + [jnp.asarray(env)]
    tracer = jbs.make_bigscene_diff_tracer(
        jsc, jwf.KernelConfig(sweep="scalar", **kw), interpret=True,
        backward="replay")
    extra = ((jnp.asarray(si), jnp.asarray(pix)) if sampler != "random"
             else ())
    _, vjp = jax.vjp(lambda *p: tracer(*p, jnp.asarray(o), jnp.asarray(d),
                                       jnp.int32(seed), *extra), *jt)
    ref = [np.asarray(x) for x in vjp(jnp.asarray(g))]

    cfg = kwf.KernelConfig(**kw)
    lanes = [torch.from_numpy(a) for a in (o, d, si, pix)]
    grads = []
    for backward in ("replay", "residual"):
        leaves = [torch.from_numpy(np.array(x)).requires_grad_() for x in jt]
        out = kbs.make_bigscene_diff_tracer(tsc, cfg, backward=backward)(
            *leaves, lanes[0], lanes[1], seed, lanes[2], lanes[3])
        out.backward(torch.from_numpy(g))
        grads.append([t.grad.numpy() for t in leaves])
    return grads[0], ref, grads[1]


def check_against_kytpu(sampler, shadow, texp):
    k8, ref, k7 = replay_both(sampler, shadow, texp)
    close(k8, ref)
    close(k8, k7)
    assert all(np.abs(a).max() > 1e-3 for a in k8[:3])
    if texp:
        assert np.abs(k8[3]).max() > 0   # the plastic spheres' dexp


def test_k8_matches_kytpu_hash_exponent():
    check_against_kytpu("hash", "parity", texp=True)


def test_k8_lane_products_and_sums():
    """The plain K8's per-lane products: its row tags are K6's rows, a dead
    bounce is tagged 0 with every adjoint 0, and `sums_plain` of them is
    what `bwd_replay` returns."""
    tsc = spheres(tb)
    cfg = kwf.KernelConfig(max_depth=2, rows=8, sampler="hash")
    o, d, si, pix = (torch.from_numpy(a)
                     for a in camera_lanes(spheres(jb), 512))
    tables = kbs.pack_big_tables(tsc, cfg)
    big_l, _, resi = kbs.trace_lanes_plain(tables, cfg, o, d, 3, si, pix,
                                           residual=True)
    g = torch.ones((512, 3))
    dout, acc, tags = kbs.bwd_replay_plain(tables, cfg, o, d, 3, si, pix, g,
                                           big_l)
    assert dout.shape == (9 * 2 + 3, 512) and acc.shape == (512, 3 + 3 * 2)
    assert torch.equal(tags, resi & kbs.RESI_ROW_MASK)
    assert (tags == 0).any() and (tags[1] != 0).any()
    for b in range(3):
        planes = dout[9 * b:9 * b + (9 if b < 2 else 3)]
        assert (planes[:, tags[b] == 0] == 0).all()
    got = kbs.bwd_replay(tables, cfg, o, d, 3, si, pix, g, big_l)
    want = kbs.sums_plain(tables, cfg, dout, acc, tags)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
