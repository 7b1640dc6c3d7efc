"""The plain textured K1 against kytpu's on the 8x8 atlas, which kytpu
fetches through its select chain over every texel; setup and bound as in
test_torch_texture.py."""

from tests.test_torch_texture import trace_both
from tests.test_torch_wavefront import lanes_agree
import tests.torch_threads  # noqa: F401  (one torch thread a process)


def test_textured_k1_matches_kytpu_select_chain():
    got, ref = trace_both("img8")
    lanes_agree(got, ref)
