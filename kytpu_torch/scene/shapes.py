"""Structure-of-arrays scene geometry (kytpu/scene/shapes.py).

Two SoA blocks: planar surfaces (triangle / rectangle / disk) in rows
[0, P) and spheres in rows [P, P+S). The builder runs on the host in
numpy, exactly as the JAX package's does, so both packages bake the same
float32 tables. Ray intersection for the render path is in
kernels/wavefront.py.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

# planar sub-kinds
TRI = 0
RECT = 1
DISK = 2


@dataclass(frozen=True)
class Geometry:
    pl_kind: torch.Tensor    # (P,) int32 in {TRI, RECT, DISK}
    pl_p0: torch.Tensor      # (P, 3); triangles store p3 == p0
    pl_p1: torch.Tensor
    pl_p2: torch.Tensor
    pl_p3: torch.Tensor
    pl_normal: torch.Tensor  # (P, 3) unit, canonical orientation
    pl_radius: torch.Tensor  # (P,) disk radius (0 otherwise)
    pl_area: torch.Tensor    # (P,)
    sp_center: torch.Tensor  # (S, 3)
    sp_radius: torch.Tensor  # (S,)
    sp_area: torch.Tensor    # (S,)

    @property
    def n_planar(self) -> int:
        return self.pl_p0.shape[0]

    @property
    def n_sphere(self) -> int:
        return self.sp_center.shape[0]

    @property
    def n_surfaces(self) -> int:
        return self.n_planar + self.n_sphere

    def to(self, device) -> "Geometry":
        return Geometry(**{f.name: getattr(self, f.name).to(device)
                           for f in fields(self)})


class GeometryBuilder:
    """Accumulates shapes on the host; `build()` freezes them into SoA
    tensors and returns the global surface row of each added shape."""

    def __init__(self):
        self._planar = []   # (kind, p0, p1, p2, p3, normal, radius, area)
        self._spheres = []  # (center, radius)
        self._handles = []  # ("pl"|"sp", local_index) in insertion order

    def add_triangle(self, p0, p1, p2, flip_normal=False) -> int:
        p0, p1, p2 = map(np.asarray, (p0, p1, p2))
        n = np.cross(p1 - p0, p2 - p0)
        area = 0.5 * np.linalg.norm(n)
        n = n / np.linalg.norm(n)
        if flip_normal:
            n = -n
        self._planar.append((TRI, p0, p1, p2, p0.copy(), n, 0.0, area))
        self._handles.append(("pl", len(self._planar) - 1))
        return len(self._handles) - 1

    def add_rectangle(self, p0, p1, p2, p3, flip_normal=False) -> int:
        p0, p1, p2, p3 = map(np.asarray, (p0, p1, p2, p3))
        n = np.cross(p1 - p0, p2 - p0)
        n = n / np.linalg.norm(n)
        if flip_normal:
            n = -n
        area = float(np.linalg.norm(np.cross(p0 - p1, p2 - p1)))
        self._planar.append((RECT, p0, p1, p2, p3, n, 0.0, area))
        self._handles.append(("pl", len(self._planar) - 1))
        return len(self._handles) - 1

    def add_disk(self, position, normal, radius) -> int:
        position = np.asarray(position)
        normal = np.asarray(normal, dtype=np.float64)
        normal = normal / np.linalg.norm(normal)
        area = float(np.pi * radius * radius)
        self._planar.append(
            (DISK, position, position.copy(), position.copy(),
             position.copy(), normal, float(radius), area))
        self._handles.append(("pl", len(self._planar) - 1))
        return len(self._handles) - 1

    def add_sphere(self, center, radius) -> int:
        self._spheres.append((np.asarray(center), float(radius)))
        self._handles.append(("sp", len(self._spheres) - 1))
        return len(self._handles) - 1

    def build(self) -> tuple[Geometry, list[int]]:
        P = len(self._planar)
        f32 = np.float32

        def stack3(idx):
            if P == 0:
                return np.zeros((0, 3), f32)
            return np.stack([np.asarray(sh[idx], f32) for sh in self._planar])

        t = torch.from_numpy
        geom = Geometry(
            pl_kind=t(np.array([sh[0] for sh in self._planar], np.int32)),
            pl_p0=t(stack3(1)), pl_p1=t(stack3(2)), pl_p2=t(stack3(3)),
            pl_p3=t(stack3(4)), pl_normal=t(stack3(5)),
            pl_radius=t(np.array([sh[6] for sh in self._planar], f32)),
            pl_area=t(np.array([sh[7] for sh in self._planar], f32)),
            sp_center=t(np.stack([c for c, _ in self._spheres]).astype(f32)
                        if self._spheres else np.zeros((0, 3), f32)),
            sp_radius=t(np.array([r for _, r in self._spheres], f32)),
            sp_area=t(np.array([4.0 * np.pi * r * r
                                for _, r in self._spheres], f32)),
        )
        ids = [local if block == "pl" else P + local
               for block, local in self._handles]
        return geom, ids

    def world_bound(self):
        """Host-side AABB over all shapes (ky.cpp:3209-3219)."""
        lo = np.full(3, np.inf)
        hi = np.full(3, -np.inf)
        for kind, p0, p1, p2, p3, n, radius, _ in self._planar:
            if kind == DISK:
                s, t = _onb_np(n)
                off = np.abs(s) * radius + np.abs(t) * radius
                lo = np.minimum(lo, p0 - off)
                hi = np.maximum(hi, p0 + off)
            else:
                for p in [p0, p1, p2] + ([p3] if kind == RECT else []):
                    lo = np.minimum(lo, p)
                    hi = np.maximum(hi, p)
        for c, r in self._spheres:
            lo = np.minimum(lo, c - r)
            hi = np.maximum(hi, c + r)
        return lo, hi

    def bounding_sphere(self):
        """(center, radius) of the world bound (ky.cpp:506-512)."""
        lo, hi = self.world_bound()
        center = 0.5 * (lo + hi)
        return center, float(np.linalg.norm(hi - center))


def _onb_np(n):
    helper = (np.array([0.0, 1.0, 0.0]) if abs(n[0]) > 0.99
              else np.array([1.0, 0.0, 0.0]))
    t = np.cross(n, helper)
    t = t / np.linalg.norm(t)
    s = np.cross(t, n)
    s = s / np.linalg.norm(s)
    return s, t
