# Frozen copy of kytpu_torch/core/rng.py at commit 35fb5ad, imports
# rewritten to this package: the benchmark's plain reference.
"""Threefry-2x32 draws, bit-exact with jax.random (kytpu/core/rng.py).

The frame renderers and the train step draw camera jitter and kernel seeds
with `jax.random` under jax's defaults (threefry2x32 with
`jax_threefry_partitionable` on). This module reproduces the calls they
make -- `key(seed)`, `fold_in(key, data)`, `split(key, num)`,
`bits(key, n)`, `uniform(key, shape)` and the scalar `randint(key, lo, hi)`
-- on int64 tensors holding uint32 words, vectorised over any number of
keys. A key is a `(..., 2)` int64 tensor. `uniform(keys, shape,
sampler="sobol", index)` is kytpu's Owen-Sobol camera draw (core/lds.py).
"""

from __future__ import annotations

import torch

from perfbench.reference.frozen.core import lds

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block (20 rounds) on uint32 words in int64 tensors.
    Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """jax.random.key(seed) for a 32-bit seed: the words (0, seed)."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in: threefry of the counter (0, data) under key k.
    `data` is an int or an int tensor (wrapped to uint32) broadcasting
    against the key's leading shape."""
    if not isinstance(data, torch.Tensor):
        data = torch.tensor(int(data) & _M32, dtype=torch.int64,
                            device=k.device)
    data = data.to(torch.int64) & _M32
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split of one key -> (num, 2): with partitionable threefry,
    key i is threefry of the counter (0, i), which is fold_in(k, i)."""
    return fold_in(k, torch.arange(num, dtype=torch.int64, device=k.device))


def randint(k: torch.Tensor, minval: int, maxval: int) -> int:
    """jax.random.randint(k, (), minval, maxval, jnp.int32) as a python int.

    jax draws 32 high and 32 low bits from the two halves of split(k) and
    folds them into the span with uint32 arithmetic, whose products wrap
    (for a span past 2**16 the high bits' multiplier wraps to 0)."""
    if not -2**31 <= minval < maxval <= 2**31 - 1:
        raise ValueError(f"int32 range [{minval}, {maxval}) expected")
    k1, k2 = split(k, 2)
    hi = int(bits(k1, 1)[0])
    lo = int(bits(k2, 1)[0])
    span = (maxval - minval) & _M32
    mult = (2**16 % span) ** 2 & _M32
    mult %= span
    off = ((hi % span) * mult & _M32) + lo % span
    off = (off & _M32) % span
    v = (minval + off) & _M32
    return v - (1 << 32) if v >= 1 << 31 else v


def bits(k: torch.Tensor, n: int) -> torch.Tensor:
    """jax.random.bits(k, (n,)) as uint32 words: the flat counters 0..n-1
    (hi word 0) under threefry, the xor of its two outputs. Shape:
    k.shape[:-1] + (n,)."""
    ctr = torch.arange(n, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[..., 0, None], k[..., 1, None],
                          torch.zeros_like(ctr), ctr)
    return y0 ^ y1


def root_key(seed: int, device=None) -> torch.Tensor:
    return key(seed, device)


def sample_keys(k: torch.Tensor, pixel_ids: torch.Tensor,
                sample_id) -> torch.Tensor:
    """One key a ray: fold the sample id, then each pixel id, into k."""
    return fold_in(fold_in(k, sample_id), pixel_ids)


def bounce_key(keys: torch.Tensor, bounce) -> torch.Tensor:
    """The per-bounce keys of per-ray keys (N, 2)."""
    return fold_in(keys, bounce)


def split_channels(keys: torch.Tensor, n: int) -> tuple:
    """jax.random.split(k, n) of each of the (N, 2) keys -> n (N, 2) key
    tensors, one a purpose (key i of a split is fold_in(k, i))."""
    return tuple(fold_in(keys, i) for i in range(n))


def stratum_grid(spp: int) -> tuple[int, int]:
    """Largest near-square (a, b) with a*b <= spp: the camera strata grid
    (ky.cpp:978)."""
    a = int(spp ** 0.5)
    while a > 1 and spp % a:
        a -= 1
    return a, spp // a


def uniform(k: torch.Tensor, shape=(), sampler: str = "random",
            index: torch.Tensor | None = None) -> torch.Tensor:
    """jax.random.uniform(k, shape) in float32 on [0, 1); `k` may carry
    leading batch dimensions, which lead the result.

    sampler="debug" draws the constant 0.5 (the reference's
    debug_sampler_t, ky.cpp:922-947). sampler="sobol" with `index`, (N,)
    per-key sample ids, is kytpu's `uniform(keys, shape, "sobol", index)`:
    each of the (N, 2) keys gives three words (`bits(k, 3)`) that seed a
    shuffled Owen-scrambled Sobol point of that index (core/lds.py); shape
    is () or (2,)."""
    shape = tuple(shape)
    if sampler == "debug":
        return torch.full(k.shape[:-1] + shape, 0.5, dtype=torch.float32,
                          device=k.device)
    if sampler == "sobol" and index is not None:
        seeds = bits(k, 3)
        if shape == ():
            return lds.owen_sobol1(index, seeds[..., 0], seeds[..., 1])
        if shape != (2,):
            raise ValueError(f"sobol draws take shape () or (2,), got {shape}")
        u0, u1 = lds.owen_sobol2(index, seeds[..., 0], seeds[..., 1],
                                 seeds[..., 2])
        return torch.stack([u0, u1], dim=-1)
    n = 1
    for s in shape:
        n *= s
    fbits = ((bits(k, n) >> 9) | 0x3F800000).to(torch.int32)
    u = fbits.view(torch.float32) - 1.0
    return torch.clamp_min(u, 0.0).reshape(k.shape[:-1] + shape)


def uniform2(k: torch.Tensor, sampler: str = "random",
             index: torch.Tensor | None = None) -> torch.Tensor:
    return uniform(k, (2,), sampler, index)
