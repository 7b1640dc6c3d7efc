"""kytpu_torch's random numbers against kytpu's, bit for bit: threefry
camera jitter (jax.random under its defaults) and the kernel's int32 hashes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kytpu.kernels import wavefront as jwf
from kytpu_torch.core import rng as trng
from kytpu_torch.kernels import wavefront as twf

SEEDS = [0, 1234, -5, 2**31 - 1]


def _words(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in(seed):
    k = jax.random.key(seed)
    kt = trng.key(seed)
    np.testing.assert_array_equal(_words(k), kt.numpy())
    for data in (0, 1, 7919, 2**31 - 1, -3):
        np.testing.assert_array_equal(
            _words(jax.random.fold_in(k, np.int32(data))),
            trng.fold_in(kt, data).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_frame_jitter(seed):
    """render_pallas's "random" pass jitter: one key, (k*npix, 2) draws."""
    kk = jax.random.fold_in(jax.random.key(seed), 3)
    ref = np.asarray(jax.random.uniform(kk, (1531, 2)))
    got = trng.uniform(trng.fold_in(trng.key(seed), 3), (1531, 2)).numpy()
    np.testing.assert_array_equal(ref, got)


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_per_lane_keys(seed):
    """render_pallas's "hash" jitter: a key per lane, (2,) draws each."""
    data = np.arange(-50, 9000, 7, dtype=np.int32)
    k = jax.random.key(seed)
    keys = jax.vmap(jax.random.fold_in, (None, 0))(k, jnp.asarray(data))
    ref = np.asarray(jax.vmap(lambda kk: jax.random.uniform(kk, (2,)))(keys))
    kt = trng.fold_in(trng.key(seed), torch.from_numpy(data))
    np.testing.assert_array_equal(_words(keys), kt.numpy())
    np.testing.assert_array_equal(ref, trng.uniform(kt, (2,)).numpy())


def _rand_i32(n, seed):
    return np.random.default_rng(seed).integers(
        -2**31, 2**31, n, dtype=np.int64).astype(np.int32)


def _u32(a):
    return np.asarray(a).astype(np.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("seed", [0, 7, -123456789])
def test_pix_hash(seed):
    pid, si = _rand_i32(4096, 1), _rand_i32(4096, 2)
    ref = jwf._pix_hash(jnp.asarray(si),
                        jwf._pix_hash(jnp.asarray(pid), jnp.int32(seed)))
    got = twf._pix_hash(twf._u32(torch.from_numpy(si)),
                        twf._pix_hash(twf._u32(torch.from_numpy(pid)), seed))
    np.testing.assert_array_equal(_u32(ref), got.numpy())


def test_bits_to_unit():
    x = _rand_i32(4096, 3)
    ref = np.asarray(jwf._bits_to_unit(jnp.asarray(x)))
    got = twf._bits_to_unit(twf._u32(torch.from_numpy(x))).numpy()
    np.testing.assert_array_equal(ref, got)


@pytest.mark.parametrize("seed", [7, -2**31])
def test_tile_keyed_stream(seed):
    """sampler="random": the lowbias chain keyed by tile seed and lane
    position, five draws of one 8x128 tile."""
    r = jwf._Rng(jnp.int32(seed), False)
    ref = [np.asarray(r.uniform((8, 128))).reshape(-1) for _ in range(5)]
    t = twf._Rng(torch.full((1024,), seed & 0xFFFFFFFF, dtype=torch.int64),
                 torch.arange(1024))
    for a in ref:
        np.testing.assert_array_equal(a, t.uniform().numpy())


def test_per_lane_stream():
    """sampler="hash": the lowbias chain keyed per lane."""
    key = _rand_i32(1024, 4)
    r = jwf._Rng(jnp.asarray(key.reshape(8, 128)), False, per_lane=True)
    t = twf._Rng(twf._u32(torch.from_numpy(key)), None)
    for _ in range(5):
        np.testing.assert_array_equal(
            np.asarray(r.uniform((8, 128))).reshape(-1), t.uniform().numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_split(seed):
    k = jax.random.fold_in(jax.random.key(seed), 17)
    kt = trng.fold_in(trng.key(seed), 17)
    for num in (2, 3, 8):
        np.testing.assert_array_equal(_words(jax.random.split(k, num)),
                                      trng.split(kt, num).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo, hi", [(0, 2**31 - 1), (0, 10), (-5, 70000),
                                    (-2**31, 2**31 - 1)])
def test_randint(seed, lo, hi):
    """The train step's kernel seed: randint(key, (), 0, 2**31 - 1, int32),
    and other spans (below and past 2**16, the full int32 range)."""
    for i in range(20):
        k = jax.random.fold_in(jax.random.key(seed), i)
        ref = int(jax.random.randint(k, (), lo, hi, jnp.int32))
        assert trng.randint(trng.fold_in(trng.key(seed), i), lo, hi) == ref


@pytest.mark.parametrize("sampler", ["random", "sobol", "debug"])
def test_jnp_engine_draws(sampler):
    """kytpu/core/rng.py's per-ray plumbing of the jnp engines, bit for
    bit: sample_keys, bounce_key, split_channels (jax.random.split under
    vmap), the per-key uniform and uniform2 draws of each sampler."""
    from kytpu.core import rng as jr
    pix = np.arange(777, dtype=np.int32) * 13
    si = (np.arange(777) % 5).astype(np.int32)
    jk = jr.sample_keys(jax.random.key(31), jnp.asarray(pix), 4)
    tk = trng.sample_keys(trng.key(31), torch.from_numpy(pix).long(), 4)
    np.testing.assert_array_equal(_words(jk), tk.numpy())
    jk, tk = jr.bounce_key(jk, 2), trng.bounce_key(tk, 2)
    np.testing.assert_array_equal(_words(jk), tk.numpy())
    jparts, tparts = jr.split_channels(jk, 5), trng.split_channels(tk, 5)
    index = si if sampler == "sobol" else None
    tindex = torch.from_numpy(si).long() if index is not None else None
    for a, b in zip(jparts, tparts):
        np.testing.assert_array_equal(_words(a), b.numpy())
        np.testing.assert_array_equal(
            np.asarray(jr.uniform(a, (), sampler, index)),
            trng.uniform(b, (), sampler, tindex).numpy())
        np.testing.assert_array_equal(
            np.asarray(jr.uniform2(a, sampler, index)),
            trng.uniform2(b, sampler, tindex).numpy())
    for spp in (1, 2, 6, 9, 16, 17):
        assert trng.stratum_grid(spp) == jr.stratum_grid(spp)
