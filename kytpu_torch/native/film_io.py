"""ctypes binding to the native film encoder (libkyfilm.so, built by
`python -m kytpu_torch.native.build`)."""

from __future__ import annotations

import ctypes
import pathlib

import numpy as np

from kytpu_torch.native.build import BUILD_DIR, LIB_NAME


class Encoder:
    """The BMP and HDR writers of one built libkyfilm.so."""

    def __init__(self, lib_path: pathlib.Path | str):
        self._lib = ctypes.CDLL(str(lib_path))
        for fn in (self._lib.ky_write_bmp, self._lib.ky_write_hdr):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_char_p,
                           np.ctypeslib.ndpointer(np.float32,
                                                  flags="C_CONTIGUOUS"),
                           ctypes.c_int, ctypes.c_int]

    @staticmethod
    def _as_img(img) -> np.ndarray:
        img = np.ascontiguousarray(np.asarray(img, np.float32))
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"expected an (H, W, 3) image, got {img.shape}")
        return img

    def write_bmp(self, path: str, img) -> None:
        img = self._as_img(img)
        h, w, _ = img.shape
        rc = self._lib.ky_write_bmp(str(path).encode(), img, w, h)
        if rc:
            raise OSError(f"ky_write_bmp failed with code {rc} for {path}")

    def write_hdr(self, path: str, img) -> None:
        img = self._as_img(img)
        h, w, _ = img.shape
        rc = self._lib.ky_write_hdr(str(path).encode(), img, w, h)
        if rc:
            raise OSError(f"ky_write_hdr failed with code {rc} for {path}")


def load(lib_path: pathlib.Path | str = BUILD_DIR / LIB_NAME
         ) -> Encoder | None:
    """The encoder of the library at lib_path, or None where none has
    been built."""
    if not pathlib.Path(lib_path).exists():
        return None
    return Encoder(lib_path)
