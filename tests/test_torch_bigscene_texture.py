"""Textures in the port's big-scene kernels K5-K8 against kytpu's table
kernel (kernels/bigscene.py; ROADMAP item M9b).

- the textured scene's tables: `extract_tables` and the cache layout with
  the "tx"/"ty" planes equal to kytpu's, and its refusal of an atlas past
  the select chain, as kytpu's;
- the plain textured K5, lane by lane, against kytpu's table kernel in
  interpret mode (sweep="scalar") at the size of kytpu's own check
  (tests/test_bigscene.py:423): a 16x16 Cornell box with a checker floor
  and an 8x8 back-wall atlas, depth 3, 512 lanes, the random sampler
  (test_torch_bigscene_texture_hash.py: the hash sampler); at most 0.5%
  of lanes outside rtol=1e-3/atol=1e-4, the means within 3 standard
  errors (the bound of the other forward tests);
- the plain textured K5 against the port's K1 on the same draws: at most
  0.5% of lanes off by more than 1e-3 (kytpu's own bound between its two
  kernels, test_torch_bigscene_tables.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kytpu.kernels import bigscene as jbs
from kytpu.kernels import wavefront as jwf
from kytpu.scene import builders as jb
from kytpu_torch.integrator.render import render
from kytpu_torch.kernels import bigscene as kbs
from kytpu_torch.kernels import wavefront as kwf
from kytpu_torch.scene import builders as tb
from tests.test_torch_wavefront import camera_rays, lanes_agree

IMG8 = np.linspace(0, 1, 8 * 8 * 3, dtype=np.float32).reshape(8, 8, 3)
IMG16 = np.random.default_rng(2).uniform(0.1, 0.9, (16, 16, 3)).astype(
    np.float32)


def textured(b, width=16, height=16, image=IMG8):
    return b.cornell_box(width=width, height=height, floor_checker=True,
                         back_image=image)


def test_textured_tables_match_kytpu():
    jsc, tsc = textured(jb), textured(tb)
    jstatic, jtab = jbs.extract_tables(jsc)
    tstatic, ttab = kbs.extract_tables(tsc)
    for k in kbs.CLASSES:
        for a, b in zip(jtab[k], ttab[k]):
            np.testing.assert_array_equal(a, b, err_msg=k)
    assert tstatic["textures"] == jstatic["textures"]
    for texp in (False, True):
        cfg = kwf.KernelConfig(max_depth=3, trainable_exponent=texp)
        jcfg = jwf.KernelConfig(max_depth=3, trainable_exponent=texp)
        n_l = len(tstatic["lights"])
        assert kbs.layout_of(tstatic, cfg) == jbs._bigres_layout(
            jcfg, n_l, jsc.has_env, True)
    tables = kbs.pack_big_tables(tsc, kwf.KernelConfig())
    rec = kwf.texture_record_of_row(tstatic)
    assert tables.tex_rec.tolist() == rec and sorted(rec)[-1] == 1
    assert tables.timg.shape == (64, 3) and tables.texa.shape == (2, 3)
    # kytpu's refusal of an atlas past the select chain; render() takes
    # the scene on K1
    sep = textured(tb, 4, 4, IMG16)
    with pytest.raises(NotImplementedError, match="select chain"):
        jbs.extract_tables(textured(jb, 4, 4, IMG16))
    with pytest.raises(NotImplementedError, match="select chain"):
        render(sep, spp=1, engine="bigscene", device="cpu")


def _lanes(n=512):
    jsc, tsc = textured(jb), textured(tb)
    o, d, si, pix = camera_rays(jsc, n)
    return jsc, tsc, (o, d, si, pix)


def check_k5_against_kytpu(sampler):
    jsc, tsc, (o, d, si, pix) = _lanes()
    kw = dict(max_depth=3, rows=8, sampler=sampler)
    tr = jbs.make_bigscene_tracer(jsc, jwf.KernelConfig(sweep="scalar", **kw),
                                  interpret=True)
    extra = ((jnp.asarray(si), jnp.asarray(pix)) if sampler != "random"
             else ())
    ref = np.asarray(tr(jsc, jnp.asarray(o), jnp.asarray(d), 9, *extra))
    cfg = kwf.KernelConfig(**kw)
    got = kbs.make_bigscene_tracer(tsc, cfg)(
        tsc, *map(torch.tensor, (o, d)), 9,
        *map(torch.tensor, (si, pix))).numpy()
    lanes_agree(got, ref)
    assert ref.mean() > 0.01


def test_textured_k5_matches_kytpu():
    check_k5_against_kytpu("random")


def test_textured_k5_matches_k1():
    _, tsc, (o, d, si, pix) = _lanes(2048)
    lanes = [torch.tensor(a) for a in (o, d, si, pix)]
    for sampler in ("random", "sobol"):
        cfg = kwf.KernelConfig(max_depth=3, rows=8, sampler=sampler)
        big = kbs.trace_lanes(kbs.pack_big_tables(tsc, cfg), cfg, *lanes[:2],
                              3, *lanes[2:]).numpy()
        k1 = kwf.trace_lanes(kwf.pack_tables(tsc, cfg), cfg, *lanes[:2], 3,
                             *lanes[2:]).numpy()
        assert np.isfinite(big).all()
        assert (np.abs(big - k1) > 1e-3).any(-1).mean() <= 0.005
