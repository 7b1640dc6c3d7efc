"""The least work of a train step past 64 surfaces (the table kernels K6
and K7), counted from what the benchmark's plain reference traced on the
step's lanes (reference/tables.py: the plain K6's cache), never from the
port.

The forward (K6): for each lane-bounce traced, one row test (a sphere's,
33 FP32 operations, transport.k1_ops' count); for each lane-bounce below
the horizon that hit a row (a nonzero row tag), the hit record and the
emission MIS (32), the frame and material (62), the shared azimuth (6),
each light's sample and BSDF evaluation (134) and the extension (90); and
one row test for each shadow ray that reached its light (a nonzero "B"
plane: a sphere's, 19). No sweep over rows is counted: a better search
shortens the sweeps, and this count stays a lower bound whatever search a
kernel runs. Or K6's bytes: the rays in (24 B a lane), the radiance out
(12 B) and the cache written once ((planes + max_depth + 1) x 4 B a lane),
whichever takes longer at the peaks of peaks.json.

The backward (K7 with its sort of the row tags and its sums by row): the
cache read once, the upstream gradient and the radiance read once (24 B a
lane), the row tags written once ((max_depth + 1) x 4 B a lane) and the
per-row gradients written once (M rows x the planes a bounce x 4 B).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from perfbench.reference.frozen.kernels import bigscene as bs
from perfbench.reference.frozen.kernels import wavefront as wf

HIT_TEST, SHADOW_TEST = 33, 19
HIT_RECORD, FRAME, AZIMUTH, PER_LIGHT, EXTENSION = 32, 62, 6, 134, 90


@dataclass
class TableTally:
    """Counts over the lanes of one or more reference blocks."""
    lanes: int = 0
    traced: list = field(default_factory=list)   # lanes reaching bounce b
    hits: list = field(default_factory=list)     # of them, those that hit
    lit: list = field(default_factory=list)      # shadow rays that reached
    planes: int = 0                              # K6's float cache planes

    def add(self, static, cfg, resf, resi) -> None:
        """Count one block of the plain K6's cache (resf (planes, n), resi
        (max_depth + 1, n))."""
        ix, self.planes = bs.layout_of(static, cfg)
        depth, n_l = cfg.max_depth, len(static["lights"])
        if not self.traced:
            self.traced = [0] * (depth + 1)
            self.hits = [0] * (depth + 1)
            self.lit = [0] * depth
        n = resf.shape[1]
        self.lanes += n
        self.traced[0] += n
        for b in range(depth + 1):
            self.hits[b] += int(((resi[b] & bs.RESI_ROW_MASK) != 0).sum())
            if b == depth:
                continue
            self.traced[b + 1] += int((resf[ix[("tu", b)]] != 0).sum())
            self.lit[b] += sum(int((resf[ix[("B", b, i)]] != 0).sum())
                               for i in range(n_l))

    def scaled(self, k: float) -> "TableTally":
        """This tally times k (a mean over 1 / k calls)."""
        return TableTally(self.lanes * k, [x * k for x in self.traced],
                          [x * k for x in self.hits],
                          [x * k for x in self.lit], self.planes)


def fwd_ops(static, cfg, t: TableTally) -> float:
    """K6's least FP32 operations on the tallied lanes."""
    n_l = len(static["lights"])
    shade = HIT_RECORD + FRAME + AZIMUTH + PER_LIGHT * n_l + EXTENSION
    return float(HIT_TEST * sum(t.traced) + shade * sum(t.hits[:-1])
                 + SHADOW_TEST * sum(t.lit))


def fwd_bytes(cfg, t: TableTally) -> float:
    """K6's least bytes: rays in, radiance out, the cache written once."""
    return float(t.lanes * (24 + 12 + 4 * (t.planes + cfg.max_depth + 1)))


def bwd_bytes(static, cfg, t: TableTally) -> float:
    """K7's and its sums' least bytes: the cache, g and L read once, the
    row tags and the per-row gradients written once."""
    rows = len(static["mats"]["kind"])
    return float(t.lanes * (4 * (t.planes + cfg.max_depth + 1) + 24
                            + 4 * (cfg.max_depth + 1))
                 + 4 * rows * wf.per_bounce(cfg))
