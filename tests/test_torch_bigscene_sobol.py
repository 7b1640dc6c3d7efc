"""The plain big-scene forward K5 against kytpu's under the sobol sampler,
and once against kytpu's default sweep past 64 surfaces (the matmul form,
about an ulp from the scalar sweep the port transcribes): kytpu's own bound
for that pair, 99% of lanes within 1e-5 (tests/test_bigscene.py:163).
Setup and the lane bound as in test_torch_bigscene.py."""

import numpy as np

from tests.test_torch_bigscene import lanes_agree, trace_both
import tests.torch_threads  # noqa: F401  (one torch thread a process)


def test_k5_sobol_lanes_match_kytpu():
    got, ref = trace_both("sobol", "parity", depth=1)
    lanes_agree(got, ref)


def test_k5_matches_kytpus_matmul_sweep():
    got, ref = trace_both("random", "parity", depth=1, sweep="auto")
    lanes_agree(got, ref)
    assert (np.abs(got - ref) < 1e-5).all(-1).mean() > 0.99
