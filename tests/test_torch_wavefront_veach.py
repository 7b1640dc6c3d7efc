"""`trace_lanes_plain` against kytpu's interpreted K1 on Veach MIS (see
test_torch_wavefront.py for the tolerance).

Veach under shadow="parity" takes a wider share of diverging lanes. The
reference's self-occlusion quirk keeps each sphere light's own shape in its
shadow sweep, so the shadow test of a sampled light point is a near-tie, and
a 1-ulp difference between XLA's CPU cos/rsqrt and the IEEE ones in the
light sample flips it on about 0.1% of lanes per light and bounce. Given the
same light samples the two sweeps agree exactly
(test_torch_wavefront.py::test_shadow_masks); under shadow="robust" the
share is within the 0.5% bound.
"""

import pytest

from tests.test_torch_wavefront import lanes_agree, trace_both
import tests.torch_threads  # noqa: F401  (one torch thread a process)

PARITY_SHARE = 0.015


@pytest.mark.parametrize("sampler, nee, shadow, max_share", [
    ("random", "all", "parity", PARITY_SHARE),
    ("hash", "single", "robust", 0.005),
])
def test_trace_lanes_plain_matches_interpreted_kernel_veach(
        sampler, nee, shadow, max_share):
    got, ref = trace_both("veach", sampler, nee, shadow)
    share = lanes_agree(got, ref, max_share)
    print(f"veach {sampler}/{nee}/{shadow}: {share:.4f} of lanes outside")
