"""Texture gradients of the port's big-scene backwards K7 and K8 against
kytpu's table kernel (ROADMAP item M9b), at the size of kytpu's own check
(tests/test_bigscene.py:442): a 12x12 Cornell box with a checker floor
and a 4x4 back-wall atlas, 288 jittered lanes, depth 3 (rr_start=3 keeps
Russian roulette out), the random sampler.

The same lanes, seed and upstream gradient go through `jax.vjp` of kytpu's
`make_bigscene_diff_tracer` (interpret mode, sweep="scalar") and through
`torch.autograd` of the port's, on CPU tensors, under the residual
backward (test_torch_bigscene_texture_replay.py: the replay backward):

- the port's K7 against kytpu's K7, every leaf (diffuse, specular,
  emission, checker colours, texels): within rtol=1e-4 plus 1e-5 of the
  leaf's largest entry;
- one central difference (step 1e-2) of a checker channel and of the texel
  with the largest adjoint through the port's residual tracer: within
  rtol=5e-3 plus 1e-5, kytpu's bound for the same check.
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
from tests.test_torch_wavefront import camera_rays
import tests.torch_threads  # noqa: F401  (one torch thread a process)

IMG4 = np.linspace(0.1, 0.9, 4 * 4 * 3, dtype=np.float32).reshape(4, 4, 3)


def close(got, ref, rtol, atol):
    for k, (a, b) in enumerate(zip(got, ref)):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol * scale,
                                   err_msg=f"leaf {k}")


W = H = 12
N, SEED = 2 * W * H, 5
CFG = kwf.KernelConfig(max_depth=3, rows=8)


def scenes():
    return (jb.cornell_box(width=W, height=H, floor_checker=True,
                           back_image=IMG4),
            tb.cornell_box(width=W, height=H, floor_checker=True,
                           back_image=IMG4))


def grads_both(backward, depth=3):
    """(the port's gradients, kytpu's) of one upstream gradient on one set
    of lanes under `backward` at `depth`, and the lanes."""
    jsc, tsc = scenes()
    o, d, _, _ = camera_rays(jsc, N)
    g = np.random.default_rng(3).standard_normal((N, 3)).astype(np.float32)
    env = np.zeros(3, np.float32)
    leaves = [jsc.mat_diffuse, jsc.mat_specular, jsc.emission,
              jsc.textures.color_a, jsc.textures.color_b, jsc.textures.image]
    tracer = jbs.make_bigscene_diff_tracer(
        jsc, jwf.KernelConfig(max_depth=depth, rows=8, sweep="scalar"),
        interpret=True, backward=backward)
    _, vjp = jax.vjp(lambda *p: tracer(*p, jnp.asarray(env), jnp.asarray(o),
                                       jnp.asarray(d), jnp.int32(SEED)),
                     *leaves)
    ref = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    lanes = (torch.tensor(env), torch.tensor(o), torch.tensor(d), SEED)
    return port_grads(tsc, backward, lanes, g, depth), ref, tsc, lanes, g


def port_grads(tsc, backward, lanes, g, depth=3):
    tl = [torch.tensor(np.asarray(x)).requires_grad_() for x in (
        tsc.mat_diffuse, tsc.mat_specular, tsc.emission,
        tsc.textures.color_a, tsc.textures.color_b, tsc.textures.image)]
    cfg = kwf.KernelConfig(max_depth=depth, rows=8)
    out = kbs.make_bigscene_diff_tracer(tsc, cfg, backward=backward)(
        *tl, *lanes)
    out.backward(torch.tensor(g))
    return [t.grad.numpy() for t in tl]


def test_texture_gradients_match_kytpu():
    got, ref, tsc, lanes, g = grads_both("residual")
    close(got, ref, 1e-4, 1e-5)
    # the texture adjoints are live, the textured rows' diffuse share 0
    assert np.abs(got[3]).sum() > 0 and np.abs(got[5]).sum() > 0
    rows = [r["row"] for r in kwf.extract_static(tsc)["textures"]]
    assert (got[0][rows] == 0).all()

    # central differences through the port's residual tracer
    tracer = kbs.make_bigscene_diff_tracer(tsc, CFG)
    gt = torch.tensor(g)

    def loss(ta, ti):
        with torch.no_grad():
            p = [tsc.mat_diffuse, tsc.mat_specular, tsc.emission, ta,
                 tsc.textures.color_b, ti]
            return float((tracer(*p, *lanes) * gt).sum())

    eps = 1e-2
    ta0, ti0 = tsc.textures.color_a, tsc.textures.image
    dta = torch.zeros_like(ta0)
    dta[0, 1] = eps
    fd = (loss(ta0 + dta, ti0) - loss(ta0 - dta, ti0)) / (2 * eps)
    np.testing.assert_allclose(got[3][0, 1], fd, rtol=5e-3, atol=1e-5)
    g_ti = np.abs(got[5]).sum(-1)[0]
    iy, ix = np.unravel_index(np.argmax(g_ti), g_ti.shape)
    dti = torch.zeros_like(ti0)
    dti[0, iy, ix, 0] = eps
    fd = (loss(ta0, ti0 + dti) - loss(ta0, ti0 - dti)) / (2 * eps)
    np.testing.assert_allclose(got[5][0, iy, ix, 0], fd, rtol=5e-3,
                               atol=1e-5)
