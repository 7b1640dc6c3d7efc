"""Film: radiance accumulation buffers and montage grids
(kytpu/film/film.py).

Reference parity: film_t (ky.cpp:1531-1791) and film_grid_t
(ky.cpp:1802-1836). A `Film` holds an (H, W, 3) float32 tensor on one
device; a `FilmGrid` is a host-side numpy montage that takes sub-films
from any device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from kytpu_torch.core.device import check_device


def to_numpy(img) -> np.ndarray:
    """An image as a numpy array: a tensor from any device is detached and
    copied to the host, anything else goes through np.asarray."""
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy()
    return np.asarray(img)


def gamma_encode(x) -> np.ndarray:
    """Linear [0,1] -> sRGB-ish u8 via pow(1/2.2)*255+0.5 in float64
    (ky.cpp:1548)."""
    x = np.clip(np.asarray(to_numpy(x), np.float64), 0.0, 1.0)
    return (np.power(x, 1.0 / 2.2) * 255.0 + 0.5).astype(np.uint8)


def to_srgb_u8(img) -> np.ndarray:
    return gamma_encode(img)


@dataclass
class Film:
    pixels: torch.Tensor  # (H, W, 3) float32

    @classmethod
    def zeros(cls, width: int, height: int, device="cuda") -> "Film":
        """An empty film on `device`: the card unless device="cpu"."""
        return cls(pixels=torch.zeros((height, width, 3), dtype=torch.float32,
                                      device=check_device(device)))

    @property
    def width(self) -> int:
        return self.pixels.shape[1]

    @property
    def height(self) -> int:
        return self.pixels.shape[0]

    def add(self, img) -> "Film":
        return Film(pixels=self.pixels + img)

    def numpy(self) -> np.ndarray:
        return to_numpy(self.pixels)


@dataclass
class FilmGrid:
    """row x column montage of equally-sized sub-films (film_grid_t), on
    the host, for the render programs that tile many renders into one image
    (ky.cpp:4715-4905)."""

    rows: int
    cols: int
    sub_width: int
    sub_height: int
    _cursor: int = 0
    pixels: np.ndarray = field(default=None)

    def __post_init__(self):
        if self.pixels is None:
            self.pixels = np.zeros(
                (self.rows * self.sub_height, self.cols * self.sub_width, 3),
                np.float32)

    def place(self, img) -> None:
        """Write the next sub-film (next_subfilm cursor, ky.cpp:1824-1827);
        img is an array or a tensor on any device."""
        img = to_numpy(img)
        if img.shape[:2] != (self.sub_height, self.sub_width):
            raise ValueError(f"sub-film of shape {img.shape}, expected "
                             f"{(self.sub_height, self.sub_width)}")
        r, c = divmod(self._cursor, self.cols)
        y0, x0 = r * self.sub_height, c * self.sub_width
        self.pixels[y0:y0 + self.sub_height, x0:x0 + self.sub_width] = img
        self._cursor += 1
