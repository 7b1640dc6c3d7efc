"""The camera jitter and primary rays of a kernel call (the train step's
lanes, a frame pass's), from a key whose words stay on the host.

Lane l of n lies at pixel q = l % npix (lanes laid out as `pid.repeat(k)`
over the whole film) and jitters as kytpu draws it with jax.random:
"random" with the words of counters 2l and 2l + 1 of bits(key, 2n),
`uniform(key, (n, 2))`; "hash" with `uniform(fold_in(key, sample_base *
npix + l), (2,))`. Its ray is `generate_rays` of the film point (q % W +
u0, q // W + u1); the origin is the camera's position (an expanded view).

`lane_rays` launches csrc/camera_rays.cu on the card (one launch, counted
as `kernel.rays.launches`) or raises; on the CPU it runs
`lane_rays_plain`, the chain of int64 and float64 torch ops that the
kernel reproduces bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from kytpu_torch.core import rng as krng
from kytpu_torch.kernels.launch import M32, on_card, run
from kytpu_torch.scene import scene as kscene

MODES = ("random", "hash")   # csrc/camera_rays.cu MODE_RANDOM, MODE_HASH


def lane_rays(cam: kscene.Camera, words: tuple[int, int], n: int, npix: int,
              mode: str, sample_base: int = 0):
    """(o, d), each (n, 3) float32 on the camera's device: CUDA launches
    the kernel or raises, the CPU runs `lane_rays_plain`."""
    if mode not in MODES:
        raise ValueError(f"unknown jitter {mode!r}: expected one of {MODES}")
    dev = cam.position.device
    if not on_card(dev):
        return lane_rays_plain(cam, words, n, npix, mode, sample_base)
    return cam.position[None].expand(n, 3), _launch(cam, words, n, npix, mode,
                                                    sample_base)


def lane_rays_plain(cam: kscene.Camera, words: tuple[int, int], n: int,
                    npix: int, mode: str, sample_base: int = 0):
    """`lane_rays` in torch ops on any device: core/rng.py's draws, then
    `generate_rays`."""
    dev = cam.position.device
    key = torch.tensor(words, dtype=torch.int64, device=dev)
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    pid = lane % npix
    if mode == "hash":
        u = krng.uniform(krng.fold_in(key, sample_base * npix + lane), (2,))
    else:
        u = krng.uniform(key, (n, 2))
    px = (pid % cam.width).to(torch.float32) + u[:, 0]
    py = (pid // cam.width).to(torch.float32) + u[:, 1]
    return kscene.generate_rays(cam, torch.stack([px, py], -1))


def _launch(cam: kscene.Camera, words: tuple[int, int], n: int, npix: int,
            mode: str, sample_base: int) -> torch.Tensor:
    """The kernel's d (n, 3) on the card."""
    from kytpu_torch.kernels import build

    if not 0 <= n < 2**31 or npix <= 0:
        raise ValueError(f"{n} lanes over {npix} pixels: the kernel takes "
                         "0 <= n < 2**31 lanes over at least one pixel")
    dev = cam.position.device
    d = torch.empty((n, 3), dtype=torch.float32, device=dev)
    # float32(1/W) and float32(1/H), as generate_rays rounds them
    inv = [float(np.float32(1.0 / s)) for s in (cam.width, cam.height)]
    run(build.load().kytpu_camera_rays, "camera_rays", "rays", dev,
        d.data_ptr(), n, npix, cam.width, MODES.index(mode), words[0] & M32,
        words[1] & M32, sample_base * npix & M32, *inv, *cam.host_basis())
    return d
