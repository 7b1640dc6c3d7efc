"""The trainable exponent and the textures together through the port's
big-scene kernels against kytpu's table kernel, at the size of kytpu's own
check (tests/test_bigscene.py:528): an 8x8 Cornell box with a checker floor
and a 4x4 back-wall atlas, depth 2, 64 jittered lanes, the random sampler;
the cache interleaves the "Bk"/"tuk" planes with "tx"/"ty". The port's K7
against kytpu's on the seven leaves (diffuse, specular, emission, exponent,
checker colours, texels): within rtol=1e-4 plus 1e-5 of the leaf's largest
entry; the port's K8 against its K7 within rtol=2e-3 plus 2e-5 (kytpu's
own check holds its replay to its residual backward)."""

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
from tests.test_torch_bigscene_texture_grad import IMG4, close
from tests.test_torch_wavefront import camera_rays
import tests.torch_threads  # noqa: F401  (one torch thread a process)


def test_exponent_and_texture_gradients_match_kytpu():
    jsc = jb.cornell_box(width=8, height=8, floor_checker=True,
                         back_image=IMG4)
    tsc = tb.cornell_box(width=8, height=8, floor_checker=True,
                         back_image=IMG4)
    n, seed = 64, 5
    o, d, _, _ = camera_rays(jsc, n)
    g = np.random.default_rng(3).standard_normal((n, 3)).astype(np.float32)
    env = np.zeros(3, np.float32)
    leaves = [jsc.mat_diffuse, jsc.mat_specular, jsc.emission,
              jnp.asarray(jsc.mat_exponent), jsc.textures.color_a,
              jsc.textures.color_b, jsc.textures.image]
    cfg = kwf.KernelConfig(max_depth=2, rows=8, trainable_exponent=True)
    tracer = jbs.make_bigscene_diff_tracer(
        jsc, jwf.KernelConfig(max_depth=2, rows=8, sweep="scalar",
                              trainable_exponent=True), interpret=True)
    _, vjp = jax.vjp(lambda *p: tracer(*p, jnp.asarray(env), jnp.asarray(o),
                                       jnp.asarray(d), jnp.int32(seed)),
                     *leaves)
    ref = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    got = {}
    for backward in ("residual", "replay"):
        tl = [torch.tensor(np.asarray(x)).requires_grad_() for x in leaves]
        out = kbs.make_bigscene_diff_tracer(tsc, cfg, backward=backward)(
            *tl, torch.tensor(env), torch.tensor(o), torch.tensor(d), seed)
        out.backward(torch.tensor(g))
        got[backward] = [t.grad.numpy() for t in tl]
    close(got["residual"], ref, 1e-4, 1e-5)
    close(got["replay"], got["residual"], 2e-3, 2e-5)
    assert np.abs(got["residual"][4]).sum() > 0   # the checker's
    assert np.abs(got["residual"][6]).sum() > 0   # the texels'
