"""Image writers: PPM (P3), BMP (24-bit bottom-up BGR), Radiance HDR (RGBE)
(kytpu/film/io.py).

Reference parity: store_ppm_impl (ky.cpp:1646-1659), store_bmp_impl
(ky.cpp:1661-1737), store_hdr_impl (ky.cpp:1739-1782). Each writer takes an
(H, W, 3) float32 array or a tensor on any device and writes the bytes
kytpu's writer writes for the same image. Encoding is numpy on the host.
Where the optional C++ encoder (kytpu_torch/native, `python -m
kytpu_torch.native.build`) has been built, the HDR writer hands the image
to it, as kytpu's does: host-side code with the same bytes, not a
stand-in for a device kernel. The BMP writer stays on numpy: the
encoder's BMP, the same bytes, was slower (1024x1024 frame, 81.47 and
83.34 ms against numpy's 72.91 and 54.90, PERF.md), where its HDR is
about 4x numpy's speed.
"""

from __future__ import annotations

import struct

import numpy as np

from kytpu_torch.film.film import gamma_encode, to_numpy
from kytpu_torch.native import film_io as _native_io

_native = _native_io.load()   # None unless the encoder has been built


def write_ppm(path: str, img) -> str:
    """ASCII P3 PPM, gamma-encoded, in the reference's element order
    (space-separated decimals, one trailing space). Each u8 becomes its
    decimal digits and a space in an (N, 4) byte grid; a mask drops the
    leading zeros."""
    img = to_numpy(img)
    h, w, _ = img.shape
    d = gamma_encode(img).reshape(-1).astype(np.uint32)
    buf = np.empty((d.shape[0], 4), np.uint8)
    buf[:, 0] = 48 + d // 100
    buf[:, 1] = 48 + (d // 10) % 10
    buf[:, 2] = 48 + d % 10
    buf[:, 3] = 32
    keep = np.ones(buf.shape, bool)
    keep[:, 0] = d >= 100
    keep[:, 1] = d >= 10
    with open(path, "wb") as f:
        f.write(f"P3\n{w} {h}\n255\n".encode())
        f.write(buf[keep].tobytes())
    return path


def write_bmp(path: str, img) -> str:
    """24-bit uncompressed BMP: 54-byte header, bottom-up rows padded to 4
    bytes, BGR order."""
    img = to_numpy(img)
    h, w, _ = img.shape
    bgr = gamma_encode(img)[::-1, :, ::-1]  # bottom-up rows, BGR channels
    pad = (-w * 3) % 4
    body = np.zeros((h, w * 3 + pad), np.uint8)
    body[:, :w * 3] = bgr.reshape(h, w * 3)
    header = b"BM" + struct.pack(
        "<IIIIiiHHIIIIII",
        54 + body.size, 0, 54,   # file size, reserved, data offset
        40,                      # info header size
        w, h, 1, 24,             # dims, planes, bpp
        0, 0, 0, 0, 0, 0)        # compression .. colors important
    with open(path, "wb") as f:
        f.write(header)
        f.write(body.tobytes())
    return path


def write_hdr(path: str, img) -> str:
    """Radiance .hdr, flat (non-RLE) RGBE scanlines."""
    img = np.asarray(to_numpy(img), np.float32)
    h, w, _ = img.shape
    if _native is not None:
        _native.write_hdr(path, img)
        return path
    v = img.max(axis=-1)
    ok = v >= 1e-32
    # v = m * 2^e with m in [0.5, 1); byte = channel * m * 256 / v
    m, e = np.frexp(np.where(ok, v, 1.0))
    scale = np.where(ok, m * 256.0 / np.where(ok, v, 1.0), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(ok, e + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
    return path


def read_hdr(path: str) -> np.ndarray:
    """Read back a flat RGBE .hdr as write_hdr writes it -> an (H, W, 3)
    array (float64, as kytpu's)."""
    with open(path, "rb") as f:
        data = f.read()
    idx = data.index(b"\n\n") + 2
    dims_end = data.index(b"\n", idx)
    dims = data[idx:dims_end].decode().split()
    h, w = int(dims[1]), int(dims[3])
    rgbe = np.frombuffer(data[dims_end + 1:], np.uint8).reshape(h, w, 4)
    e = rgbe[..., 3].astype(np.int32) - 128 - 8
    scale = np.ldexp(1.0, e)
    out = rgbe[..., :3].astype(np.float32) * scale[..., None]
    out[rgbe[..., 3] == 0] = 0.0
    return out


def write_image(path: str, img, fmt: str | None = None) -> str:
    """Dispatch by extension (film_t::store_image, ky.cpp:1606-1644)."""
    fmt = fmt or path.rsplit(".", 1)[-1].lower()
    if fmt == "ppm":
        return write_ppm(path, img)
    if fmt == "bmp":
        return write_bmp(path, img)
    if fmt == "hdr":
        return write_hdr(path, img)
    raise ValueError(f"unsupported image format {fmt!r}")
