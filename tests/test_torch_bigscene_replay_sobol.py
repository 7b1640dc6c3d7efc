"""The plain big-scene K8 against kytpu's under the "sobol" sampler, parity
shadows, no trainable exponent. Setup and tolerances as in
test_torch_bigscene_replay.py."""

from tests.test_torch_bigscene_replay import check_against_kytpu


def test_k8_matches_kytpu_sobol():
    check_against_kytpu("sobol", "parity", texp=False)
