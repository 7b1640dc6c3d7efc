"""The cull geometry of Morton-ordered surface rows that both kernel
families read: the Morton keys, the 8-row block bounds and the padded
spheres around groups of bounds, under which K1, K2 and K4 vote over flat
superblocks (`kwf.cull_tables`) and K5, K6 and K8 walk a tree
(`kbs.tree_bounds`).
"""

from __future__ import annotations

import numpy as np

# rows a block (kytpu's table kernels' unroll), and the shape classes in
# table order
UNROLL = 8
CLASSES = ("tri", "rect", "disk", "sphere")


def morton3(points: np.ndarray, lo: np.ndarray, hi: np.ndarray):
    """30-bit Morton keys of points quantized over [lo, hi]."""
    span = np.maximum(hi - lo, 1e-20)
    q = np.clip(((points - lo) / span * 1023.0), 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    return (spread(q[:, 0]) << np.uint64(2)) | (spread(q[:, 1])
                                                << np.uint64(1)) \
        | spread(q[:, 2])


def block_bounds(centers, radii):
    """Per-UNROLL-block bounding spheres of (already sorted, unpadded)
    per-entry bounds -> (n_blocks, 4) [cx cy cz r]; blocks made entirely of
    padding get r = -1, as kytpu's (its cone cull reads them);
    `padded` pads them for the kernels' per-lane cull."""
    n = len(radii)
    npad = ((n + UNROLL - 1) // UNROLL) * UNROLL if n else 0
    out = np.zeros((npad // UNROLL if npad else 0, 4), np.float32)
    for b in range(out.shape[0]):
        i0, i1 = b * UNROLL, min((b + 1) * UNROLL, n)
        if i0 >= n:
            out[b] = [0, 0, 0, -1.0]
            continue
        cs = np.asarray(centers[i0:i1], np.float64)
        rs = np.asarray(radii[i0:i1], np.float64)
        lo = (cs - rs[:, None]).min(axis=0)
        hi = (cs + rs[:, None]).max(axis=0)
        c = (lo + hi) * 0.5
        r = float(np.max(np.linalg.norm(cs - c, axis=-1) + rs))
        out[b] = [c[0], c[1], c[2], r * 1.0001 + 1e-6]   # conservative pad
    return out


# csrc/bigscene_fwd.cu's cull pad: a block's bounding radius grows by
# CULL_PAD of its centre's and radius's size, and each lane adds CULL_PAD
# of its ray origin's size (`kbs.cull_slack_plain`)
CULL_PAD = 2.0 ** -12


def padded(c, r) -> np.ndarray:
    """(n, 4) float32 [c R] of float64 centres and radii, R = r + CULL_PAD
    * (|cx| + |cy| + |cz| + r) rounded up to a float32."""
    r = r + CULL_PAD * (np.abs(c).sum(-1) + r)
    r32 = r.astype(np.float32)
    r32 = np.where(r32 < r, np.nextafter(r32, np.float32(np.inf)), r32)
    return np.concatenate([c.astype(np.float32), r32[:, None]], -1)


def group(pb, k: int) -> np.ndarray:
    """(ceil(n / k), 4) float32 padded spheres, each around k consecutive
    padded spheres of pb (n, 4) and holding them whole: the centre of their
    float64 box, the radius to the farthest one's far side, then
    `padded`."""
    out = []
    for s0 in range(0, len(pb), k):
        g = pb[s0:s0 + k].astype(np.float64)
        lo = (g[:, :3] - g[:, 3:]).min(0)
        hi = (g[:, :3] + g[:, 3:]).max(0)
        c = (lo + hi) * 0.5
        r = np.max(np.linalg.norm(g[:, :3] - c, axis=-1) + g[:, 3])
        out.append(padded(c[None], np.array([r])))
    return np.concatenate(out + [np.zeros((0, 4), np.float32)])
