"""nanopt on torch: a minimal path tracer in about 100 lines.

The same pedagogy as the JAX package's examples/nanopt.py (after the
reference's 110-line CPU tracer, smallpt2pbrt/nanopt.cpp: 8 spheres,
diffuse and mirror, recursive radiance): one ray per lane, a Python loop
over the bounces with a mask of the live lanes instead of recursion,
counter-based draws (jax.random's threefry bits, core/rng.py) instead of
erand48, and the whole image as one batch of tensor ops. It has no kernel
of its own: it is plain torch code, on the card unless device="cpu".

  python -m kytpu_torch.examples.nanopt [spp]   # writes nanopt.ppm
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from kytpu_torch.core import math as km
from kytpu_torch.core import rng as krng
from kytpu_torch.core.device import check_device

# scene: 8 spheres -- walls / mirror ball / light (nanopt.cpp:26-37 layout,
# scaled by 1/100 for float32). Row: center xyz, radius, albedo rgb,
# emission rgb, is_mirror. Huge spheres approximate the box walls; e.g. the
# left wall is a radius-1000 sphere whose surface sits at x = 0.01.
S = np.array([
    # cx,       cy,       cz,        r,    ar,  ag,  ab,   er, eg, eb, mir
    [-1e3+.01,  .408,     .816,      1e3,  .75, .25, .25,  0,  0,  0,  0],  # left (x=.01)
    [1e3+.99,   .408,     .816,      1e3,  .25, .25, .75,  0,  0,  0,  0],  # right (x=.99)
    [.5,        .408,     -1e3,      1e3,  .75, .75, .75,  0,  0,  0,  0],  # back (z=0)
    [.5,        .408,     1e3+1.70,  1e3,  0,   0,   0,    0,  0,  0,  0],  # front (z=1.70)
    [.5,        -1e3,     .816,      1e3,  .75, .75, .75,  0,  0,  0,  0],  # floor (y=0)
    [.5,        1e3+.816, .816,      1e3,  .75, .75, .75,  0,  0,  0,  0],  # ceiling (y=.816)
    [.27,       .165,     .47,       .165, .999,.999,.999, 0,  0,  0,  1],  # mirror ball
    [.5,        6.8133,   .816,      6.0,  0,   0,   0,   12, 12, 12,  0],  # light
], np.float32)


def _tables(device):
    """(C, R, ALB, EMI, MIR) of S on `device`."""
    s = torch.from_numpy(S).to(device)
    return s[:, :3], s[:, 3], s[:, 4:7], s[:, 7:10], s[:, 10]


def _fma(a, b, c):
    """a * b + c rounded once to float32 (a * b is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _dot(a, b):
    """Dot product over the last axis as a chain of fused multiply-adds, a0
    b0 then + a1 b1 then + a2 b2, the way XLA contracts the JAX package's
    jitted dot products and sums of squares on the CPU."""
    a, b = torch.broadcast_tensors(a, b)
    acc = a[..., 0] * b[..., 0]
    for k in (1, 2):
        acc = _fma(a[..., k], b[..., k], acc)
    return acc


def hit(o, d):
    """Nearest sphere of each ray (N, 3) -> (t, index, hit?)."""
    C, R, _, _, _ = _tables(o.device)
    oc = C[None] - o[:, None]                       # (N, 8, 3)
    b = _dot(oc, d[:, None])
    disc = _fma(b, b, -_dot(oc, oc)) + R[None] ** 2
    sq = km.sqrt(torch.clamp_min(disc, 0.0))
    t1, t2 = b - sq, b + sq
    inf = torch.full_like(t1, math.inf)
    t = torch.where(t1 > 1e-4, t1, torch.where(t2 > 1e-4, t2, inf))
    t = torch.where(disc >= 0, t, inf)
    i = torch.argmin(t, 1)
    tb = torch.gather(t, 1, i[:, None])[:, 0]
    return tb, i, torch.isfinite(tb)


def _normalize(v):
    return v / km.sqrt(_dot(v, v))[:, None]


def radiance(o, d, key, depth: int = 5):
    """Radiance along the rays (N, 3): `depth` bounces of a cosine-weighted
    diffuse or mirror walk, bounce b drawing uniform(fold_in(key, b),
    (N, 2))."""
    C, R, ALB, EMI, MIR = _tables(o.device)
    n_lanes = o.shape[0]
    beta, acc = torch.ones_like(o), torch.zeros_like(o)
    alive = torch.ones(n_lanes, dtype=torch.bool, device=o.device)
    y_axis = o.new_tensor([[0.0, 1.0, 0.0]])
    x_axis = o.new_tensor([[1.0, 0.0, 0.0]])
    for b in range(depth):
        t, i, ok = hit(o, d)
        acc = acc + torch.where((alive & ok)[:, None], beta * EMI[i], 0.0)
        p = o + t[:, None] * d
        n = (p - C[i]) / R[i][:, None]
        n = torch.where(_dot(n, d)[:, None] < 0, n, -n)
        u = krng.uniform(krng.fold_in(key, b), (n_lanes, 2))
        # cosine hemisphere about n
        w = n
        a = torch.where(torch.abs(w[:, :1]) > 0.9, y_axis, x_axis)
        v = _normalize(torch.linalg.cross(w, a))
        uu = torch.linalg.cross(v, w)
        r1 = 2 * math.pi * u[:, 0]
        r2 = u[:, 1]
        r2s = km.sqrt(r2)
        d_diff = (uu * (km.cos(r1) * r2s)[:, None]
                  + v * (km.sin(r1) * r2s)[:, None]
                  + w * km.sqrt(1 - r2)[:, None])
        d_mirr = d - 2 * _dot(n, d)[:, None] * n
        d_new = torch.where(MIR[i][:, None] > 0, d_mirr, d_diff)
        beta = beta * torch.where(alive[:, None], ALB[i], 1.0)
        alive = alive & ok & (ALB[i].amax(-1) > 0)
        o, d = p + 1e-3 * d_new, d_new
    return acc


def main(spp: int = 16, w: int = 256, h: int = 256, device="cuda",
         out: str = "nanopt.ppm") -> np.ndarray:
    """Render the 8-sphere box at spp samples a pixel, write it to `out`
    as a text PPM and return the clamped (h, w, 3) image."""
    dev = check_device(device)
    key = krng.key(0, dev)
    pix = torch.arange(w * h, device=dev)
    ys, xs = (pix // w).to(torch.float32), (pix % w).to(torch.float32)
    cam_o = torch.tensor([0.5, 0.52, 2.956], device=dev)
    cam_d = torch.tensor([0.0, -0.042612, -1.0], device=dev)
    cam_d = cam_d / torch.linalg.norm(cam_d)
    cx = torch.tensor([w * 0.5135 / h, 0.0, 0.0], device=dev)
    cy = torch.linalg.cross(cx, cam_d)
    cy = cy / torch.linalg.norm(cy) * 0.5135
    acc = torch.zeros((w * h, 3), device=dev)
    for s in range(spp):
        u = krng.uniform(krng.fold_in(key, 1000 + s), (w * h, 2))
        px = (xs + u[:, 0]) / w - 0.5
        py = -((ys + u[:, 1]) / h - 0.5)
        d = _normalize(cx[None] * px[:, None] + cy[None] * py[:, None]
                       + cam_d[None])
        # smallpt advances the origin 140 units (1.4 scaled) into the box
        acc = acc + radiance(cam_o[None] + 1.4 * d, d, krng.fold_in(key, s))
    img = torch.clamp(acc / spp, 0, 1).reshape(h, w, 3).cpu().numpy()
    g = (np.clip(img, 0, 1) ** (1 / 2.2) * 255 + 0.5).astype(np.uint8)
    with open(out, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n")
        f.write(" ".join(map(str, g.reshape(-1))))
    print(f"wrote {out}")
    return img


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 16)
