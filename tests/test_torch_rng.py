"""kytpu_torch's random numbers against kytpu's, bit for bit: threefry
camera jitter (jax.random under its defaults) and the kernel's int32 hashes;
the python-int threefry on key words kept on the host against the tensor
one, and the camera-rays kernel's plain version against the chains it
replaced."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kytpu.kernels import wavefront as jwf
from kytpu_torch.core import rng as trng
from kytpu_torch.kernels import shading as ksh
from kytpu_torch.scene.scene import generate_rays
import tests.torch_threads  # noqa: F401  (one torch thread a process)

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
    got = ksh.pix_hash(ksh.u32(torch.from_numpy(si)),
                       ksh.pix_hash(ksh.u32(torch.from_numpy(pid)), seed))
    np.testing.assert_array_equal(_u32(ref), got.numpy())


def test_bits_to_unit():
    x = _rand_i32(4096, 3)
    ref = np.asarray(jwf._bits_to_unit(jnp.asarray(x)))
    got = ksh.bits_to_unit(ksh.u32(torch.from_numpy(x))).numpy()
    np.testing.assert_array_equal(ref, got)


@pytest.mark.parametrize("seed", [7, -2**31])
def test_tile_keyed_stream(seed):
    """sampler="random": the lowbias chain keyed by tile seed and lane
    position, five draws of one 8x128 tile."""
    r = jwf._Rng(jnp.int32(seed), False)
    ref = [np.asarray(r.uniform((8, 128))).reshape(-1) for _ in range(5)]
    t = ksh.Rng(torch.full((1024,), seed & 0xFFFFFFFF, dtype=torch.int64),
                torch.arange(1024))
    for a in ref:
        np.testing.assert_array_equal(a, t.uniform().numpy())


def test_per_lane_stream():
    """sampler="hash": the lowbias chain keyed per lane."""
    key = _rand_i32(1024, 4)
    r = jwf._Rng(jnp.asarray(key.reshape(8, 128)), False, per_lane=True)
    t = ksh.Rng(ksh.u32(torch.from_numpy(key)), None)
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


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**32 - 1, -9])
def test_int_threefry_fold_in_randint(seed):
    """The python-int threefry2x32, fold_in_words and randint_words, on key
    words that stay on the host, equal the tensor versions to the bit,
    words and data past 2**31 included."""
    w = np.random.default_rng(seed & 0xFFFF).integers(
        0, 2**32, (64, 4), dtype=np.uint64).astype(np.int64)
    w[0] = [2**32 - 1, 2**31, 0, 2**32 - 1]
    t = torch.from_numpy(w)
    y0, y1 = trng.threefry2x32(t[:, 0], t[:, 1], t[:, 2], t[:, 3])
    for row, a, b in zip(w.tolist(), y0.tolist(), y1.tolist()):
        assert trng.threefry2x32(*row) == (a, b)
    k = trng.fold_in(trng.key(seed), 11)
    words = trng.words(k)
    assert words == tuple(k.tolist())
    for data in (0, 1, 7919, 2**31 - 1, 2**31, 2**32 - 1, 2**40 + 3, -3):
        assert trng.fold_in_words(words, data) == tuple(
            trng.fold_in(k, data).tolist())
    for lo, hi in ((0, 2**31 - 1), (0, 10), (-5, 70000),
                   (-2**31, 2**31 - 1)):
        assert trng.randint_words(words, lo, hi) == trng.randint(k, lo, hi)


def _loss_rays_as_it_stood(cam, key, spp, sampler):
    """diff/inverse.py _kernel_loss's unsharded jitter and rays before
    kernels/camera.py."""
    w = cam.width
    npix = w * cam.height
    lane_pid = torch.arange(npix).repeat(spp)
    lane_sid = torch.arange(spp).repeat_interleave(npix)
    if sampler == "hash":
        u = trng.uniform(trng.fold_in(key, lane_sid * npix + lane_pid), (2,))
    else:
        u = trng.uniform(key, (spp * npix, 2))
    px = (lane_pid % w).to(torch.float32) + u[:, 0]
    py = (lane_pid // w).to(torch.float32) + u[:, 1]
    return generate_rays(cam, torch.stack([px, py], -1))


def _pass_rays_as_it_stood(cam, seed, k, p, sampler):
    """kernels/wavefront.py render_cuda's jitter and rays of pass p before
    kernels/camera.py."""
    w = cam.width
    npix = w * cam.height
    pid = torch.arange(npix, dtype=torch.int64)
    px0 = (pid % w).to(torch.float32).repeat(k)
    py0 = (pid // w).to(torch.float32).repeat(k)
    pid_k = pid.repeat(k)
    key = trng.key(seed)
    if sampler == "hash":
        si = p * k + torch.arange(k, dtype=torch.int64).repeat_interleave(
            npix)
        u = trng.uniform(trng.fold_in(key, si * npix + pid_k), (2,))
    else:
        u = trng.uniform(trng.fold_in(key, p), (k * npix, 2))
    return generate_rays(
        cam, torch.stack([px0 + u[:, 0], py0 + u[:, 1]], dim=-1))


@pytest.mark.parametrize("sampler", ["random", "hash"])
@pytest.mark.parametrize("seed", [0, 2**31 + 7, -5])
def test_lane_rays_plain_matches_the_sites(sampler, seed):
    """kernels/camera.py lane_rays' plain version, on the CPU, against the
    two sites' chains as they stood, to the bit: the train step's lanes
    under a step key, and frame passes p = 3 and one whose sample base
    times npix wraps past 2**32, on an odd film (7 x 5)."""
    from kytpu_torch.kernels import camera as kcam
    from kytpu_torch.scene import builders
    from kytpu_torch.utils import profiling as kprof

    cam = builders.veach_mis(7, 5).camera
    npix, spp, k = 35, 3, 4
    before = kprof.launches("rays")
    key = trng.fold_in(trng.key(seed), 9)
    got = kcam.lane_rays(cam, trng.words(key), spp * npix, npix, sampler)
    want = _loss_rays_as_it_stood(cam, key, spp, sampler)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    root = (0, seed & 0xFFFFFFFF)
    for p in (3, 40_000_000):
        if sampler == "hash":
            got = kcam.lane_rays(cam, root, k * npix, npix, "hash", p * k)
        else:
            got = kcam.lane_rays(cam, trng.fold_in_words(root, p), k * npix,
                                 npix, "random")
        want = _pass_rays_as_it_stood(cam, seed, k, p, sampler)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    # the CPU's plain version launches nothing
    assert kprof.launches("rays") == before
