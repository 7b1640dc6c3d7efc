"""The plain big-scene K6 and K7 against kytpu's under the "random" sampler
and robust shadows, no trainable exponent. Setup and tolerances as in
test_torch_bigscene_res.py."""

from tests.test_torch_bigscene_res import check_against_kytpu
import tests.torch_threads  # noqa: F401  (one torch thread a process)


def test_k6_k7_match_kytpu_random_robust():
    check_against_kytpu("random", "robust", texp=False)
