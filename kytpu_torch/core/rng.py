"""Threefry-2x32 draws, bit-exact with jax.random (kytpu/core/rng.py).

The frame renderers and the train step draw camera jitter and kernel seeds
with `jax.random` under jax's defaults (threefry2x32 with
`jax_threefry_partitionable` on). This module reproduces the calls they
make -- `key(seed)`, `fold_in(key, data)`, `split(key, num)`,
`uniform(key, shape)` and the scalar `randint(key, lo, hi)` -- on int64
tensors holding uint32 words, vectorised over any number of keys. A key is
a `(..., 2)` int64 tensor.
"""

from __future__ import annotations

import torch

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
    hi = int(random_bits(k1, 1)[0])
    lo = int(random_bits(k2, 1)[0])
    span = (maxval - minval) & _M32
    mult = (2**16 % span) ** 2 & _M32
    mult %= span
    off = ((hi % span) * mult & _M32) + lo % span
    off = (off & _M32) % span
    v = (minval + off) & _M32
    return v - (1 << 32) if v >= 1 << 31 else v


def random_bits(k: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit words: `n` per key, from the flat counters 0..n-1 (hi word 0),
    xor of the two threefry outputs. Shape: k.shape[:-1] + (n,)."""
    ctr = torch.arange(n, dtype=torch.int64, device=k.device)
    k0 = k[..., 0, None]
    k1 = k[..., 1, None]
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(ctr), ctr)
    return y0 ^ y1


def uniform(k: torch.Tensor, shape) -> torch.Tensor:
    """jax.random.uniform(k, shape) in float32 on [0, 1); `k` may carry
    leading batch dimensions, which lead the result."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    bits = random_bits(k, n)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    u = fbits.view(torch.float32) - 1.0
    return torch.clamp_min(u, 0.0).reshape(k.shape[:-1] + shape)
