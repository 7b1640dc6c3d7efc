"""The textured big-scene replay backward K8 against kytpu's, on the lanes
of test_torch_bigscene_texture_grad.py (kytpu's tests/test_bigscene.py:442
scene and lanes, at depth 2: kytpu's interpreted replay kernel takes
about 100 s at depth 3 here): every leaf within rtol=1e-4 plus 1e-5 of the
leaf's largest entry; and against the port's own K7 on the same lanes
within rtol=2e-3 plus 2e-5 of the largest entry (the reference's bound
between its two backwards)."""

import numpy as np

from tests.test_torch_bigscene_texture_grad import close, grads_both, port_grads


def test_textured_k8_matches_kytpu_and_k7():
    got, ref, tsc, lanes, g = grads_both("replay", depth=2)
    close(got, ref, 1e-4, 1e-5)
    close(got, port_grads(tsc, "residual", lanes, g, depth=2), 2e-3, 2e-5)
    assert np.abs(got[3]).sum() > 0 and np.abs(got[5]).sum() > 0
