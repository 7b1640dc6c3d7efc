"""The least work of a train step past 64 surfaces on a scene of matte
triangles (the table kernels K6 and K7 on SPD's tetrahedral pyramid),
counted from what the benchmark's plain reference traced on the step's
lanes (reference/tetra.py: the plain K6's cache), never from the port.
counts/tables.py's tally and bytes, with a triangle's row test in place of
a sphere's and the Lambertian path's shading in place of the plastic's.

Each constant is the FP32 operations (add, sub, mul, div, sqrt, min/max,
one per transcendental call; a sign flip, a compare and a select none)
that the plain code (frozen/kernels/bigscene.py `_trace_plain` and the
functions it calls) does for a lane:

- HIT_TEST 39, one triangle row of the closest-hit sweep
  (`_closest_class`): t = (c - n.o) / n.d, 12; a = (f1.o - k1) + t f1.d,
  13; b likewise, 13; a + b, 1;
- SHADOW_TEST 27, one shadow ray against one triangle row beside the
  row's shared terms (`_occluded_class`): t = (num_h - se num_n) / n.wi,
  8; a = (a_h + se a_n) + t f1.wi, 9; b, 9; a + b, 1;
- HIT_RECORD 20, a hit: hp = o + d t, 6; the facing test n.wo, 5; the
  emission term le wb, 3, and its sum into L, 6 (the triangle's normal is
  its row's, read; the emission MIS weight, 2 from bounce 1 on, is left
  out, as the first bounce takes none);
- FRAME 44, the frame about the normal (`make_frame`: |t|^2, a clamp, a
  rsqrt and the scaling, 10; s = t x n, 9, normalised likewise, 10) and
  wo in it (`to_local`, three dots, 15);
- AZIMUTH 6, the shared azimuth of the sky's sample: cos(2 pi u2), 2, and
  its sine from it, 4;
- PER_LIGHT 36, a light's NEE at a vertex, the point light's and the
  sky's alike: the point light's sample (its vector, |v|^2, a clamp, a
  sqrt, two reciprocals and the direction, 15) and weight 1 / pdf (1),
  or the sky's (the direction from the azimuth and its angle-space pdf,
  14) and weight 1 / (pdf_l + pdf_b) (2); n.wi, 5; the Lambertian pdf and
  same-side test, 2; the cosine term, 1; the shadow ray's tmax, 1; the
  term's product, 2; its colour into the vertex's sum, 9;
- NEE_SUM 9, the vertex's NEE into L (beta ld, 6) and into its emission
  term, 3;
- EXTENSION 62, the Lambertian sample (the concentric disk, 13; its z,
  6; the same-side test, 1; f and pdf, 4), the direction to world (15),
  the throughput (4), beta (3) and its largest component (2), the cache's
  unit throughput (3) and the next origin offset along the normal (11);
  Russian roulette, from bounce rr_start + 1 only, is left out.

As in counts/tables.py: a row test a traced lane-bounce, the shading of
each hit below the horizon, a row test a shadow ray that reached its
light; no sweep over rows, so this stays a lower bound whatever search a
kernel runs.
"""

from __future__ import annotations

from perfbench.counts.tables import TableTally, bwd_bytes, fwd_bytes  # noqa: F401

HIT_TEST, SHADOW_TEST = 39, 27
HIT_RECORD, FRAME, AZIMUTH, PER_LIGHT, NEE_SUM, EXTENSION = (
    20, 44, 6, 36, 9, 62)


def fwd_ops(static, cfg, t: TableTally) -> float:
    """K6's least FP32 operations on the tallied lanes."""
    n_l = len(static["lights"])
    shade = (HIT_RECORD + FRAME + AZIMUTH + PER_LIGHT * n_l + NEE_SUM
             + EXTENSION)
    return float(HIT_TEST * sum(t.traced) + shade * sum(t.hits[:-1])
                 + SHADOW_TEST * sum(t.lit))
