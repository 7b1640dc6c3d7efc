"""The plain K2 and K3 against kytpu's on the all-lights Cornell box (large
glass sphere, point, directional and environment lights): the environment
adjoints, the delta lights that get no emission adjoint, and a real
nee="single" pick over three lights. Inputs and tolerances as in
test_torch_wavefront_res.py."""

import pytest

from tests.test_torch_wavefront_res import CASES, cache_agrees, grads_agree, \
    trace_grads
import tests.torch_threads  # noqa: F401  (one torch thread a process)


@pytest.fixture(scope="module", params=CASES, ids=["-".join(c) for c in CASES])
def cornell_lights(request):
    return trace_grads("cornell_lights", *request.param)


def test_gradients_match_kytpu(cornell_lights):
    got, ref, static = cornell_lights
    grads_agree(got[1], ref[1], static)
    assert abs(got[1][3]).max() > 1e-3   # the environment's adjoint


def test_cache_matches_kytpu(cornell_lights):
    got, ref, _ = cornell_lights
    cache_agrees(got[2:], ref[2:])
