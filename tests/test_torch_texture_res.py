"""The plain textured K2 and K3 against kytpu's: the checker floor and the
16x16 atlas (kytpu's separable route); test_torch_texture_res_select.py
has the 4x4 atlas (its select chain), test_torch_texture_replay*.py the
replay backward K4.

The same numpy-seeded rays, seed and upstream gradient go through
`jax.vjp` of kytpu's `make_pallas_diff_tracer` (K2 and K3 in interpret
mode) and `torch.autograd` of the port's `make_cuda_diff_tracer` on CPU
tensors, over the tables in kytpu's public order (diffuse, specular,
emission, texa, texb, [timg,] env): 1024 lanes at depth 2, rows=8, the
hash sampler.

Tolerances:
- gradients: |port - kytpu| <= 1e-4 |kytpu| + 1e-5 max(1, max|kytpu|) per
  table. A textured hit's diffuse comes from kytpu's interpreted select
  chain or matmul (fused multiply-adds) and the port's IEEE steps, which
  differ in the last bits, and a texel's gradient is a sum over the few
  lanes that hit near it, taken in another order; the textured row's
  diffuse-table gradient is exactly 0 in both;
- cache: kytpu's residual planes from the vjp's residuals, where the port
  marks a bounce live (resi != 0): every float plane, the "tx"/"ty" texel
  coordinates included, within rtol=1e-3/atol=1e-4 and the int entries
  equal in bits 0-10 (bit 10: the checker parity), on all but 0.5% of the
  lanes (the forward tests' bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kytpu.kernels import wavefront as jwf
from kytpu.scene import builders as jb
from kytpu_torch.kernels import wavefront as twf
from kytpu_torch.scene import builders as tb
from tests.test_torch_texture import cornell
from tests.test_torch_wavefront import camera_rays

RTOL, ATOL = 1e-4, 1e-5


def tex_grads(name, backward="residual", depth=2, n=1024, seed=5,
              kytpu=True):
    """(port, kytpu): (radiance, gradients in the tracers' order, resf,
    resi) on the same lanes; kytpu has no cache under backward="replay",
    and kytpu=False leaves its side out (None)."""
    jsc, tsc = cornell(jb, name), cornell(tb, name)
    kw = dict(max_depth=depth, rows=8, sampler="hash")
    o, d, si, pix = camera_rays(jsc, n)
    g = np.random.default_rng(3).standard_normal((n, 3)).astype(np.float32)
    img = name.startswith("img")
    jt = [jsc.mat_diffuse, jsc.mat_specular, jsc.emission,
          jsc.textures.color_a, jsc.textures.color_b] + (
        [jsc.textures.image] if img else []) + [jnp.zeros(3)]
    ref = None
    if kytpu:
        ref = _kytpu_side(jsc, jt, kw, backward, (o, d, si, pix), g, seed)

    cfg = twf.KernelConfig(**kw)

    leaves = [torch.from_numpy(np.array(x)).requires_grad_() for x in jt]
    lanes = [torch.from_numpy(np.array(a)) for a in (o, d, si, pix)]
    out_t = twf.make_cuda_diff_tracer(tsc, cfg, backward)(
        *leaves, lanes[0], lanes[1], seed, lanes[2], lanes[3])
    out_t.backward(torch.from_numpy(g))
    tables = twf.pack_tables(tsc, cfg)
    _, resf, resi = twf.trace_lanes_plain(tables, cfg, *lanes[:2], seed,
                                          *lanes[2:], residual=True)
    got = (out_t.detach().numpy(), [t.grad.numpy() for t in leaves],
           resf.numpy(), resi.numpy())
    return got, ref, tables.static


def _kytpu_side(jsc, jt, kw, backward, lanes, g, seed):
    o, d, si, pix = (jnp.asarray(a) for a in lanes)
    n = len(g)
    tracer = jwf.make_pallas_diff_tracer(jsc, jwf.KernelConfig(**kw),
                                         interpret=True, backward=backward)
    out, vjp = jax.vjp(lambda *p: tracer(*p, o, d, jnp.int32(seed), si, pix),
                       *jt)
    jg = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    jresf = jresi = None
    if backward == "residual":
        res = [np.asarray(x) for x in jax.tree_util.tree_leaves(vjp)
               if getattr(x, "ndim", 0) == 3]
        jresf = next(x for x in res if x.dtype == np.float32)
        jresf = jresf.reshape(len(jresf), -1)[:, :n]
        jresi = next(x for x in res if x.dtype == np.int32)
        jresi = jresi.reshape(len(jresi), -1)[:, :n]
    return np.asarray(out), jg, jresf, jresi


def grads_agree(got, ref, static):
    for a, b in zip(got, ref):
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL * scale)
    row = static["textures"][0]["row"]
    assert got[0][row].tolist() == [0.0] * 3 and (ref[0][row] == 0).all()
    # the texture leaves carry gradient: texa/texb for a checker, timg for
    # an image
    tex = got[3:5] if static["textures"][0]["kind"] == "checker" else got[5:6]
    assert all(np.abs(t).max() > 1e-3 for t in tex)


def cache_agrees(got, ref, static, max_share=0.005):
    resf, resi = got
    jresf, jresi = ref
    assert resf.shape == jresf.shape and resi.shape == jresi.shape
    ix, _ = twf.residual_layout(static, twf.KernelConfig(max_depth=2))
    live = resi != 0
    bad = (live & ((resi & 0x7FF) != (jresi & 0x7FF))).any(0)
    for tag, k in ix.items():
        off = ~np.isclose(resf[k], jresf[k], rtol=1e-3, atol=1e-4)
        # kytpu writes a dead lane's frozen-ray texel coordinates
        bad |= off & live[tag[1]] if tag[0] in ("tx", "ty") else off
    assert bad.mean() <= max_share, bad.mean()


def check(name):
    got, ref, static = tex_grads(name)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-3, atol=1e-4)
    grads_agree(got[1], ref[1], static)
    cache_agrees(got[2:], ref[2:], static)
    ix, _ = twf.residual_layout(static, twf.KernelConfig(max_depth=2))
    if static["textures"][0]["kind"] == "checker":
        assert ((got[3] & 1024) != 0).any()   # the parity bit is written
    else:
        assert (got[2][ix[("tx", 0)]] != 0).any()


def test_textured_k2_k3_match_kytpu_checker():
    check("checker")


def test_textured_k2_k3_match_kytpu_separable():
    check("img16")
