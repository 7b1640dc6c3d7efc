"""Light kinds and the SoA light table (kytpu/light/lights.py).

The kinds and the emitting-surface bindings are host metadata; the shape
parameters and the emitted colour are float32 tensors, row i for light i.
Light sampling itself lives with the kernel in kernels/wavefront.py.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

POINT = 0
DIRECTION = 1
AREA_RECT = 2
AREA_SPHERE = 3
ENV = 4


def is_delta_light(kind: int) -> bool:
    return kind in (POINT, DIRECTION)


@dataclass(frozen=True)
class Lights:
    """Row i is light i; `kinds` and `surface_ids` are host tuples."""

    kinds: tuple
    surface_ids: tuple
    emit: torch.Tensor        # (L,3) intensity I / irradiance E / radiance L
    position: torch.Tensor    # (L,3) point-light position
    direction: torch.Tensor   # (L,3) directional-light direction (unit)
    p0: torch.Tensor          # (L,3) area-rect corners
    p1: torch.Tensor
    p2: torch.Tensor
    p3: torch.Tensor
    normal: torch.Tensor      # (L,3) canonical rect normal
    area: torch.Tensor        # (L,)
    center: torch.Tensor      # (L,3) area-sphere centre
    radius: torch.Tensor      # (L,)

    def to(self, device) -> "Lights":
        return Lights(**{f.name: (getattr(self, f.name).to(device)
                                  if isinstance(getattr(self, f.name),
                                                torch.Tensor)
                                  else getattr(self, f.name))
                         for f in fields(self)})
