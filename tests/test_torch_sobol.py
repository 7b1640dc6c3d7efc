"""The "sobol" sampler of the port against kytpu's.

Bit for bit: core/lds.py's uint32 maps, rng.bits (jax.random.bits),
rng.uniform/uniform2(..., "sobol", index) (kytpu's camera draw), and the
in-kernel word maps (_rev_bits, _lk_hash, _superset_xor, _site_seeds) and
the lane stream of the plain `_Rng` against kytpu's `_Rng(sobol=...)`. The
(0,2) property of the in-kernel pair as tests/test_kernel.py:390-434
states it, on the port's own maps.

Lane by lane: the plain K1 and K2 under sobol against kytpu's kernels in
interpret mode (tolerance of test_torch_wavefront.py and
test_torch_wavefront_res.py), a small render(cfg sampler="sobol",
device="cpu") frame against render_pallas(interpret=True) (the same
passes, so the same lanes; each pixel within rtol=1e-3/atol=1e-4 on all
but 0.5% of pixels), and two sobol train steps against kytpu's (losses
rtol=1e-5, parameters atol=1e-5, as test_torch_train.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kytpu.core import lds as jlds
from kytpu.core import rng as jrng
from kytpu.diff import inverse as jinv
from kytpu.integrator.path import PathConfig
from kytpu.kernels import wavefront as jwf
from kytpu.scene import builders as jb
from kytpu_torch.core import lds as tlds
from kytpu_torch.core import rng as trng
from kytpu_torch.diff import inverse as tinv
from kytpu_torch.integrator.render import render
from kytpu_torch.kernels import wavefront as twf
from kytpu_torch.scene import builders as tb
from tests.test_torch_wavefront import lanes_agree, trace_both
from tests.test_torch_wavefront_res import cache_agrees, grads_agree, \
    trace_grads


def _u32(n, seed):
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64) \
        .astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_lds_maps_match_kytpu():
    x, s0, s1, s2 = (_u32(4096, k) for k in range(4))
    jx = jnp.asarray(x)
    pairs = [
        (jlds.reverse_bits(jx), tlds.reverse_bits(_t(x))),
        (jlds._laine_karras(jx, jnp.asarray(s0)),
         tlds.laine_karras(_t(x), _t(s0))),
        (jlds.nested_uniform_scramble(jx, jnp.asarray(s1)),
         tlds.nested_uniform_scramble(_t(x), _t(s1))),
        *zip(jlds.sobol_point2(jx), tlds.sobol_point2(_t(x))),
        *zip(jlds.owen_sobol2(jx, jnp.asarray(s0), jnp.asarray(s1),
                              jnp.asarray(s2)),
             tlds.owen_sobol2(_t(x), _t(s0), _t(s1), _t(s2))),
        (jlds.owen_sobol1(jx, jnp.asarray(s0), jnp.asarray(s1)),
         tlds.owen_sobol1(_t(x), _t(s0), _t(s1))),
    ]
    for ref, got in pairs:
        ref = np.asarray(ref)
        if ref.dtype == np.float32:
            np.testing.assert_array_equal(ref, got.numpy())
        else:
            np.testing.assert_array_equal(ref.astype(np.int64), got.numpy())


@pytest.mark.parametrize("seed", [0, 1234, -5])
def test_bits_match_jax(seed):
    k = jax.random.fold_in(jax.random.key(seed), 9)
    kt = trng.fold_in(trng.key(seed), 9)
    for n in (1, 3, 7):
        np.testing.assert_array_equal(
            np.asarray(jax.random.bits(k, (n,))).astype(np.int64),
            trng.bits(kt, n).numpy())
    data = np.arange(-40, 3000, 13, dtype=np.int32)
    keys = jax.vmap(jax.random.fold_in, (None, 0))(k, jnp.asarray(data))
    ref = jax.vmap(lambda kk: jax.random.bits(kk, (3,)))(keys)
    got = trng.bits(trng.fold_in(kt, torch.from_numpy(data)), 3)
    np.testing.assert_array_equal(np.asarray(ref).astype(np.int64),
                                  got.numpy())


@pytest.mark.parametrize("seed", [0, 77])
def test_sobol_camera_draws_match_kytpu(seed):
    """render_pallas's sobol jitter: a key per pixel, the sample index as
    the point index."""
    pid = np.arange(600, dtype=np.int32) % 150
    si = (np.arange(600) // 150 + 3).astype(np.int32)
    key = jax.random.key(seed)
    keys = jax.vmap(lambda p: jax.random.fold_in(key, p))(jnp.asarray(pid))
    kt = trng.fold_in(trng.key(seed), torch.from_numpy(pid))
    np.testing.assert_array_equal(
        np.asarray(jrng.uniform2(keys, "sobol", jnp.asarray(si))),
        trng.uniform2(kt, "sobol", torch.from_numpy(si)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jrng.uniform(keys, (), "sobol", jnp.asarray(si))),
        trng.uniform(kt, (), "sobol", torch.from_numpy(si)).numpy())


def test_in_kernel_word_maps_match_kytpu():
    x = _u32(4096, 5).view(np.int32)
    s = np.int32(-1234567)
    jx = jnp.asarray(x)
    tx = twf._u32(torch.from_numpy(x))
    u32 = lambda a: np.asarray(a).astype(np.int64) & 0xFFFFFFFF  # noqa
    np.testing.assert_array_equal(u32(jwf._rev_bits(jx)),
                                  tlds.reverse_bits(tx).numpy())
    np.testing.assert_array_equal(u32(jwf._lk_hash(jx, s)),
                                  tlds.laine_karras(tx, int(s) & 0xFFFFFFFF)
                                  .numpy())
    np.testing.assert_array_equal(u32(jwf._superset_xor(jx)),
                                  twf._superset_xor(tx).numpy())
    for ctr in range(64):
        assert twf._site_seeds(ctr) == jwf._site_seeds(ctr)


def test_in_kernel_stream_matches_kytpu():
    """The plain `_Rng` sobol branch draws kytpu's values: uniform() and
    uniform2() in a mixed order, 1024 lanes."""
    si = np.random.default_rng(1).integers(0, 5000, 1024).astype(np.int32)
    ph = _u32(1024, 2).view(np.int32)
    ref = jwf._Rng(np.int32(42), False, sobol=(jnp.asarray(si.reshape(8, 128)),
                                              jnp.asarray(ph.reshape(8, 128))))
    got = twf._Rng(None, None, sobol=(twf._u32(torch.from_numpy(si)),
                                      twf._u32(torch.from_numpy(ph))))
    for op in ("uniform", "uniform2", "uniform2", "uniform", "uniform2"):
        if op == "uniform":
            pairs = [(ref.uniform((8, 128)), got.uniform())]
        else:
            pairs = zip(ref.uniform2((8, 128)), got.uniform2())
        for r, g in pairs:
            np.testing.assert_array_equal(np.asarray(r).reshape(-1), g.numpy())


def _assert_02(x, y, total):
    """Every elementary interval of every 2^m-aligned block holds one
    point, m = 0..6."""
    for m in range(7):
        n = 1 << m
        for blk in range(total // n):
            xs, ys = x[blk * n:(blk + 1) * n], y[blk * n:(blk + 1) * n]
            for a in range(m + 1):
                cells = set(zip((xs * (1 << a)).astype(int),
                                (ys * (1 << (m - a))).astype(int)))
                assert len(cells) == n, (m, blk, a)


def test_in_kernel_pair_is_a_02_sequence():
    i = torch.arange(256, dtype=torch.int64)
    d0 = tlds.reverse_bits(i).numpy() / 2**32
    d1 = tlds.reverse_bits(twf._superset_xor(i)).numpy() / 2**32
    _assert_02(d0, d1, 256)
    rng = twf._Rng(None, None, sobol=(i, torch.full((256,), -1234567
                                                    & 0xFFFFFFFF)))
    u1, u2 = rng.uniform2()
    _assert_02(u1.numpy(), u2.numpy(), 256)
    # 1D sites are stratified too
    u = rng.uniform().numpy()
    assert sorted(set((u * 256).astype(int))) == list(range(256))
    # distinct draw sites are decorrelated
    u1b, _ = rng.uniform2()
    cells = set(zip((u1.numpy() * 16).astype(int),
                    (u1b.numpy() * 16).astype(int)))
    assert 150 < len(cells) < 256


@pytest.mark.parametrize("name, nee, shadow", [
    ("cornell", "all", "robust"), ("cornell_lights", "single", "parity")])
def test_trace_lanes_plain_sobol_matches_interpreted_kernel(name, nee, shadow):
    got, ref = trace_both(name, "sobol", nee, shadow)
    lanes_agree(got, ref)


def test_residual_kernels_sobol_match_kytpu():
    got, ref, static = trace_grads("cornell", "sobol", "all")
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-3, atol=1e-4)
    cache_agrees(got[2:], ref[2:])
    grads_agree(got[1], ref[1], static)


def test_render_sobol_matches_render_pallas():
    kw = dict(max_depth=2, rows=8, sampler="sobol")
    jsc = jb.cornell_box(width=16, height=12)
    ref = np.asarray(jwf.render_pallas(jsc, spp=4, seed=11,
                                       cfg=jwf.KernelConfig(**kw),
                                       clamp=False, interpret=True))
    got = render(tb.cornell_box(width=16, height=12), spp=4, seed=11,
                 cfg=twf.KernelConfig(**kw), clamp=False, device="cpu")
    assert got.shape == (12, 16, 3)
    share = (~np.isclose(got.numpy(), ref, rtol=1e-3, atol=1e-4)).any(-1) \
        .mean()
    assert share <= 0.005, share


def test_sobol_train_steps_match_kytpu():
    w = h = 8
    tsc = tb.cornell_box(width=w, height=h)
    target = render(tsc, spp=16, seed=3, clamp=False, device="cpu").numpy()
    jsc = jb.cornell_box(width=w, height=h)
    jsc = dataclasses.replace(jsc, mat_diffuse=jsc.mat_diffuse * 0.4)
    tsc = dataclasses.replace(tsc, mat_diffuse=tsc.mat_diffuse * 0.4)
    step, params, opt = jinv.make_train_step(
        jsc, jnp.asarray(target), spp=2, cfg=PathConfig(max_depth=2),
        engine="pallas", kernel_sampler="sobol")
    tstep, tp, _ = tinv.make_train_step(tsc, target, spp=2, max_depth=2,
                                        kernel_sampler="sobol", device="cpu")
    for i in range(2):
        params, opt, loss = step(params, opt, jax.random.key(i))
        np.testing.assert_allclose(float(tstep(trng.key(i))), float(loss),
                                   rtol=1e-5)
        for name, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(params[name]),
                                       rtol=0, atol=1e-5, err_msg=name)
