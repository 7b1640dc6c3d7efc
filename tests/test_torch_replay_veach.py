"""The plain path-replay backward (K4) against kytpu's on Veach MIS, under
hash/all with shadow="robust" (see test_torch_replay.py for the inputs).

Tolerance: the reference's K3-vs-K4 bound, rtol=2e-3 plus 2e-5 of the
table's largest entry, not test_torch_replay.py's 1e-4: the tail peel
R_1 = (L - E_0) / T_0 cancels where a lane's NEE term from the 800-radiance sphere lights is
most of its radiance, so a last-bit difference in E_0 between XLA's fused
CPU arithmetic and the port's IEEE steps comes out at up to 1.7e-3 of the
diffuse adjoints (10 of 33 entries past 1e-4).

Depth 1, not 2: kytpu's replay kernel unrolls 11 surface rows and 5 sphere
lights per bounce, and interpret mode traces it in 43 s at depth 1 and
120 s at depth 2 (on this suite's CPU runners), more than a file of the
tier may take.
"""

import numpy as np

from tests.test_torch_wavefront_res import grads_agree, trace_grads


def test_replay_matches_kytpu_veach():
    got, ref, static = trace_grads("veach", "hash", "all", shadow="robust",
                                   backward="replay", max_depth=1)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-3, atol=1e-4)
    grads_agree(got[1], ref[1], static, rtol=2e-3, atol=2e-5)
