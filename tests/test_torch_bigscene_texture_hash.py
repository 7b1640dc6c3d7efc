"""The plain textured K5 against kytpu's table kernel under the hash
sampler, lane by lane, on the scene and lanes of
test_torch_bigscene_texture.py (the random sampler is there), with its
bound."""

from tests.test_torch_bigscene_texture import check_k5_against_kytpu
import tests.torch_threads  # noqa: F401  (one torch thread a process)


def test_textured_k5_matches_kytpu_hash():
    check_k5_against_kytpu("hash")
