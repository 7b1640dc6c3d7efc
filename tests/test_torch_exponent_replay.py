"""The plain K4's exponent adjoint against kytpu's interpreted replay
backward under trainable_exponent, on the default Cornell box (its glossy
floor) under hash/single, where the reference's replay, unlike its K3,
picks the forward's light. Inputs and tolerance as in
test_torch_exponent.py."""

import numpy as np

from tests.test_torch_wavefront_res import grads_agree, trace_grads


def test_replay_gradients_match_kytpu():
    got, ref, static = trace_grads("cornell", "hash", "single", texp=True,
                                   backward="replay")
    assert len(got[1]) == 5 and np.abs(got[1][4]).max() > 0
    grads_agree(got[1], ref[1], static)
