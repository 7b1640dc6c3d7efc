# Frozen copy of kytpu_torch/kernels/v3.py at commit 35fb5ad, imports
# rewritten to this package: the benchmark's plain reference.
"""Component-plane 3-vector algebra on torch tensors (kytpu/kernels/v3.py).

Each component is a float32 tensor of lane shape, or a python float holding
a float32 value: a scene constant that the JAX package bakes into its
kernel. Arithmetic between two constants rounds to float32, as numpy's
float32 scalars do at trace time.

`V3.dot` keeps the trace-time folding of exact 0 / +-1 constant factors
(`_cmul`). It is exact for finite operands, but it decides which inf/NaN
values reach the raw divisions of the ray tests, so the port keeps it; the
CUDA kernel does the same folding at run time on the table values.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from perfbench.reference.frozen.core.math import rsqrt


def _is_const(v) -> bool:
    return not isinstance(v, torch.Tensor)


def _f32(v) -> float:
    return float(np.float32(v))


def _binop(a, b, op):
    if _is_const(a) and _is_const(b):
        return float(op(np.float32(a), np.float32(b)))
    return op(a, b)


def _cmul(a, b):
    """a * b, folding exact 0 / +-1 constant factors (None stands for an
    exactly-zero term that the sum leaves out)."""
    ca = a if _is_const(a) else None
    cb = b if _is_const(b) else None
    c, v = (ca, b) if ca is not None else (cb, a)
    if c is None:
        return a * b
    if c == 0.0:
        return None
    if c == 1.0:
        return v
    if c == -1.0:
        return -v
    return _binop(c, v, lambda x, y: x * y)


@dataclass(frozen=True)
class V3:
    x: object
    y: object
    z: object

    def _map2(self, o, op):
        if isinstance(o, V3):
            return V3(_binop(self.x, o.x, op), _binop(self.y, o.y, op),
                      _binop(self.z, o.z, op))
        return V3(_binop(self.x, o, op), _binop(self.y, o, op),
                  _binop(self.z, o, op))

    def __add__(self, o):
        return self._map2(o, lambda a, b: a + b)

    def __sub__(self, o):
        return self._map2(o, lambda a, b: a - b)

    def __mul__(self, o):
        return self._map2(o, lambda a, b: a * b)

    __rmul__ = __mul__

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    def dot(self, o: "V3"):
        terms = [t for t in (_cmul(self.x, o.x), _cmul(self.y, o.y),
                             _cmul(self.z, o.z)) if t is not None]
        if not terms:
            for v in (self.x, self.y, self.z, o.x, o.y, o.z):
                if not _is_const(v):
                    return torch.zeros_like(v)
            return 0.0
        r = terms[0]
        for t in terms[1:]:
            r = _binop(r, t, lambda a, b: a + b)
        return r

    def cross(self, o: "V3") -> "V3":
        return V3(self.y * o.z - self.z * o.y,
                  self.z * o.x - self.x * o.z,
                  self.x * o.y - self.y * o.x)

    def length_squared(self):
        return self.dot(self)

    def max_component(self):
        """NaN-propagating, as jnp.maximum is."""
        return torch.maximum(self.x, torch.maximum(self.y, self.z))

    def where(self, cond, other: "V3") -> "V3":
        """cond ? self : other (per lane)."""
        return V3(torch.where(cond, self.x, other.x),
                  torch.where(cond, self.y, other.y),
                  torch.where(cond, self.z, other.z))

    def is_black(self):
        return (self.x <= 0.0) & (self.y <= 0.0) & (self.z <= 0.0)


def cv3(v) -> V3:
    """Constant V3 from a triple: each component rounded to float32."""
    return V3(_f32(v[0]), _f32(v[1]), _f32(v[2]))


def v3_full(like: torch.Tensor, x, y, z) -> V3:
    return V3(torch.full_like(like, x), torch.full_like(like, y),
              torch.full_like(like, z))


def v3_zeros(like: torch.Tensor) -> V3:
    z = torch.zeros_like(like)
    return V3(z, z, z)


def make_frame(n: V3) -> tuple[V3, V3, V3]:
    """Orthonormal basis about unit n (kytpu.kernels.v3.make_frame): the
    helper axis is (0,1,0) when |n.x| > 0.99, else (1,0,0)."""
    use_y = torch.abs(n.x) > 0.99
    zero = torch.zeros_like(n.x)
    t = V3(torch.where(use_y, -n.z, zero),
           torch.where(use_y, zero, n.z),
           torch.where(use_y, n.x, -n.y))
    t = t * rsqrt(torch.clamp_min(t.length_squared(), 1e-20))
    s = t.cross(n)
    s = s * rsqrt(torch.clamp_min(s.length_squared(), 1e-20))
    return s, t, n


def to_local(s: V3, t: V3, n: V3, w: V3) -> V3:
    return V3(w.dot(s), w.dot(t), w.dot(n))


def to_world(s: V3, t: V3, n: V3, w: V3) -> V3:
    return s * w.x + t * w.y + n * w.z
