"""Pixel-parity check: the port against the COMPILED reference renderer.

1. tools/reference_build/build_reference.sh   -> /tmp/ky_ref
2. cd /tmp && ./ky_ref 256                    -> /tmp/single.bmp (64 spp)
3. python -m kytpu_torch.tools.compare_reference /tmp/single.bmp ours.bmp

Both images are gamma-encoded BMPs of the reference's production config
(cornell both_small_spheres|light_environment, 1024^2, depth 5, iterative
PT, both_mis). Downsampled comparison cancels Monte Carlo noise; the
remaining difference measures estimator parity. The BMPs are read with
numpy alone (`load`), so the check needs no imaging library.
"""

from __future__ import annotations

import struct
import sys

import numpy as np


def load(path) -> np.ndarray:
    """A 24-bit uncompressed BMP (what film/io.py's write_bmp and the
    reference write; rows bottom-up, or top-down under a negative height)
    -> (H, W, 3) float32 RGB in [0, 1]. Raises ValueError on any other
    format."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 54 or data[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    offset, = struct.unpack_from("<I", data, 10)
    info, w, h, planes, bpp, comp = struct.unpack_from("<IiiHHI", data, 14)
    if info < 40 or planes != 1 or bpp != 24 or comp != 0 or w <= 0 \
            or h == 0:
        raise ValueError(f"{path}: a 24-bit uncompressed BMP expected "
                         f"(header {info} B, {bpp} bits, compression {comp},"
                         f" {w}x{h})")
    stride = (w * 3 + 3) & ~3
    rows = abs(h)
    if offset + stride * rows > len(data):
        raise ValueError(f"{path}: truncated pixel data")
    px = np.frombuffer(data, np.uint8, stride * rows, offset).reshape(
        rows, stride)[:, :w * 3].reshape(rows, w, 3)
    if h > 0:
        px = px[::-1]   # bottom-up rows
    return px[:, :, ::-1].astype(np.float32) / 255.0   # BGR -> RGB


def down(img, f=8):
    h, w, _ = img.shape
    return img[:h // f * f, :w // f * f].reshape(
        h // f, f, w // f, f, 3).mean(axis=(1, 3))


def main(ref_path, ours_path, factor=8):
    a = down(load(ref_path), factor)
    b = down(load(ours_path), factor)
    diff = np.abs(a - b)
    print(f"downsample {factor}x: mean abs diff {diff.mean():.4f}, "
          f"p99 {np.percentile(diff, 99):.4f}, max {diff.max():.4f} "
          f"(8-bit gamma space, [0,1])")
    return diff.mean()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2],
         int(sys.argv[3]) if len(sys.argv) > 3 else 8)
