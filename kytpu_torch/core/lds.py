"""Hash-based Owen-scrambled Sobol sampling (kytpu/core/lds.py).

A padded (0,2)-sequence sampler in the style of Burley, "Practical
Hash-Based Owen Scrambling" (JCGT 2020): every draw site gets its own
shuffled and scrambled copy of the first two Sobol dimensions, and the
point index is the sample id. The JAX package computes these maps on
uint32 arrays; here the same words are held in int64 tensors and every
step is masked back to 32 bits, so each map is bit-exact with kytpu's.
The frame renderer and the train step draw their "sobol" camera jitter
through `core.rng.uniform(..., sampler="sobol")`; the megakernels draw the
in-kernel sites with the word-parallel variant in kernels/wavefront.py,
which shares `reverse_bits` and `laine_karras` with this module.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """Wrapping 32-bit multiply of uint32 words held in int64 (split so no
    int64 product overflows)."""
    c &= M32
    lo = (x * (c & 0xFFFF)) & M32
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _sobol_dim1_directions() -> list[int]:
    """Direction numbers of the second Sobol dimension: primitive
    polynomial x^2 + x + 1, initial m = (1, 3) (Joe & Kuo)."""
    m = [1, 3]
    for k in range(2, 32):
        m.append(m[k - 2] ^ (m[k - 2] << 2) ^ (m[k - 1] << 1))
    return [int(np.uint32((m[k] << (31 - k)) & M32)) for k in range(32)]


_DIRS1 = _sobol_dim1_directions()


def reverse_bits(x: torch.Tensor) -> torch.Tensor:
    x = ((x >> 16) & 0x0000FFFF) | ((x & 0x0000FFFF) << 16)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    return ((x >> 1) & 0x55555555) | ((x & 0x55555555) << 1)


def laine_karras(x: torch.Tensor, seed) -> torch.Tensor:
    """Random permutation of [0, 2^32) that preserves low-bit blocks: an
    Owen scramble of the reversed-bit representation."""
    x = (x + seed) & M32
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        x = x ^ mul32(x, c)
    return x


def nested_uniform_scramble(x: torch.Tensor, seed) -> torch.Tensor:
    """Owen scramble of x's bit tree (root = MSB)."""
    return reverse_bits(laine_karras(reverse_bits(x), seed))


def sobol_point2(idx: torch.Tensor):
    """First two Sobol dimensions of point `idx` as uint32 fractions."""
    idx = idx.to(torch.int64) & M32
    d1 = torch.zeros_like(idx)
    for k in range(32):
        d1 = d1 ^ (((idx >> k) & 1) * _DIRS1[k])
    return reverse_bits(idx), d1


def to_unit(x: torch.Tensor) -> torch.Tensor:
    """Top 24 bits -> float32 in [0, 1): exact, never 1.0."""
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def owen_sobol2(idx, seed_shuffle, seed0, seed1):
    """Shuffled, Owen-scrambled 2D Sobol draw: idx (N,) sample indices,
    seeds (N,) uint32 words -> two (N,) float32 in [0, 1)."""
    i = nested_uniform_scramble(idx.to(torch.int64) & M32, seed_shuffle)
    d0, d1 = sobol_point2(i)
    return (to_unit(nested_uniform_scramble(d0, seed0)),
            to_unit(nested_uniform_scramble(d1, seed1)))


def owen_sobol1(idx, seed_shuffle, seed0):
    """1D variant (bit-reversal radical inverse only)."""
    i = nested_uniform_scramble(idx.to(torch.int64) & M32, seed_shuffle)
    return to_unit(nested_uniform_scramble(reverse_bits(i), seed0))
