"""The plain path-replay backward (K4) against kytpu's on the all-lights
Cornell box (large glass sphere, point, directional and environment
lights) under random/all and random/single: the environment adjoints, the
delta lights, a real single-light pick. Inputs and tolerance as in
test_torch_replay.py."""

import pytest

from tests.test_torch_replay import replay_radiance_agrees
from tests.test_torch_wavefront_res import grads_agree, trace_grads
import tests.torch_threads  # noqa: F401  (one torch thread a process)

CASES = [("random", "all"), ("random", "single")]


@pytest.fixture(scope="module", params=CASES, ids=["-".join(c) for c in CASES])
def replay(request):
    return trace_grads("cornell_lights", *request.param, backward="replay")


def test_replay_radiance_matches_kytpu(replay):
    replay_radiance_agrees(replay)


def test_replay_gradients_match_kytpu(replay):
    got, ref, static = replay
    grads_agree(got[1], ref[1], static)
    assert abs(got[1][3]).max() > 1e-3   # the environment's adjoint
