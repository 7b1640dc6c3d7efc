"""The least FP32 work of the light transport of a set of lanes, counted
from what the benchmark's plain reference traced on them.

`k1_ops` and `k3_ops` are copies of chip_smoke.py's (commit 35fb5ad), the
per-lane-bounce counts read from csrc/wavefront_fwd.cu and
csrc/wavefront_bwd_res.cu for a scene of fast-path planar rows and sphere
lights. They are fed a `Tally` of the reference's own coefficient cache
(the plain K2 of reference/frozen on the timed lanes), never the port's:
the lanes that reach each bounce (a lane reaches bounce b > 0 iff its
"tu" plane at b - 1 is not 0) and the shadow rays that reached their
light (a nonzero "B" plane). K3 is counted over the lane-bounces that were
traced, not over every bounce of every lane as the kernel walks them, so
both counts are lower bounds of the work, whatever kernels carry it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from perfbench.reference.frozen.kernels import wavefront as wf
from perfbench.reference.frozen.scene import shapes as kshapes


@dataclass
class Tally:
    """Counts over the lanes of one or more reference blocks."""
    lanes: int = 0
    reached: list = field(default_factory=list)   # lanes reaching bounce b
    lit: list = field(default_factory=list)       # [b][i] rays that reached light i
    lit_any: list = field(default_factory=list)   # [b] lane-bounces with such a ray

    def add(self, static, cfg, resf: torch.Tensor) -> None:
        """Count one block of the plain K2's float cache (res_n, n)."""
        ix, _ = wf.residual_layout(static, cfg)
        n_l = 1 if wf.picks_one_light(cfg, len(static["lights"])) else len(
            static["lights"])
        depth = cfg.max_depth
        if not self.reached:
            self.reached = [0] * (depth + 1)
            self.lit = [[0] * n_l for _ in range(depth)]
            self.lit_any = [0] * depth
        n = resf.shape[1]
        self.lanes += n
        self.reached[0] += n
        for b in range(depth):
            self.reached[b + 1] += int((resf[ix[("tu", b)]] != 0).sum())
            if not n_l:
                continue
            lit = torch.stack([resf[ix[("B", b, i)]] != 0
                               for i in range(n_l)])
            for i in range(n_l):
                self.lit[b][i] += int(lit[i].sum())
            self.lit_any[b] += int(lit.any(0).sum())

    def scaled(self, k: float) -> "Tally":
        """This tally times k (a mean over k**-1 calls)."""
        return Tally(self.lanes * k, [r * k for r in self.reached],
                     [[x * k for x in row] for row in self.lit],
                     [x * k for x in self.lit_any])


def k1_ops(static, cfg, t: Tally) -> float:
    """FP32 operations (add, sub, mul, div, sqrt, min/max, one per
    transcendental call) that the forward must do for the tallied lanes:
    per surface in the closest-hit sweep 31 (planar) or 33 (sphere), 32 per
    hit for the normal and the emission MIS; below the horizon 62 for the
    frame and material, 6 for the shared azimuth, 134 per light for its
    sample and BSDF evaluation, 90 for the BSDF sample and the extension.
    Of the nee="all" shadow sweeps only what the data surely needs: each
    shadow ray that reached its light tested every row whose skip bit for
    its light is clear, at 27 (a fast planar row), 34 (any other planar
    row) or 19 (a sphere) a row, and a lane-bounce with such a ray computed
    the shared terms of each row that some light does not skip once (33 a
    fast planar row, 13 a sphere). Blocked rays stop early and are left
    out, and the nee="single" sweep is not counted."""
    planar, n_sp, n_l = static["planar"], len(static["spheres"]), len(
        static["lights"])
    hit = 31 * len(planar) + 33 * n_sp + 32
    shade = 62 + 6 + 134 * n_l + 90
    reached = t.reached
    ops = float(sum(reached[:-1]) * (hit + shade) + reached[-1] * hit)
    if wf.picks_one_light(cfg, n_l) or not n_l:
        return ops
    rows_skip, sph_skip = wf._occl_skips(static, cfg)
    fast = [s["kind"] != kshapes.DISK and bool(s.get("fast"))
            for s in planar]
    ray_row = [sum(27 if fast[r] else 34 for r in range(len(planar))
                   if r not in rows_skip[i]) + 19 * (n_sp - len(sph_skip[i]))
               for i in range(n_l)]
    shared_row = (33 * sum(1 for r in range(len(planar)) if fast[r] and any(
        r not in rows_skip[i] for i in range(n_l)))
        + 13 * sum(1 for j in range(n_sp) if any(
            j not in sph_skip[i] for i in range(n_l))))
    for b in range(cfg.max_depth):
        ops += sum(ray_row[i] * t.lit[b][i] for i in range(n_l))
        ops += shared_row * t.lit_any[b]
    return ops


def k3_ops(static, cfg, t: Tally) -> float:
    """FP32 operations of the cache backward for the tallied lanes: 45 per
    traced bounce below the horizon plus 27 per NEE ("B") plane of the
    cache, 6 a lane at the horizon."""
    ix, _ = wf.residual_layout(static, cfg)
    n_b = sum(1 for tag in ix if tag[0] == "B" and tag[1] == 0)
    traced = sum(t.reached[:cfg.max_depth])
    return float(traced * (45 + 27 * n_b) + 6 * t.lanes)
