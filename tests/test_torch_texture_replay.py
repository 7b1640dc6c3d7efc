"""The plain textured K4 (the path-replay backward) against kytpu's, on the
checker floor (test_torch_texture_replay_sep.py: the 16x16 atlas,
test_torch_texture_replay_select.py: the 4x4 atlas at depth 1, where
kytpu's interpreted replay of its select chain is slowest), and against
the port's own K3 on the same lanes.

Setup and the bound against kytpu as in test_torch_texture_res.py, through
make_cuda_diff_tracer(backward="replay") and kytpu's
make_pallas_diff_tracer(backward="replay"). Against the port's K3: the
reference's own bound between its two backwards, rtol=2e-3 plus 2e-5 of
the table's largest entry (tests/test_kernel.py:630; the replay peels T_b =
f |cos| / pdf, the cache backward colour * tu)."""

import numpy as np

from tests.test_torch_texture_res import grads_agree, tex_grads


def check_replay(name, depth=2):
    got, ref, static = tex_grads(name, "replay", depth)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-3, atol=1e-4)
    grads_agree(got[1], ref[1], static)
    res, _, _ = tex_grads(name, "residual", depth, kytpu=False)
    for a, b in zip(got[1], res[1]):
        np.testing.assert_allclose(a, b, rtol=2e-3,
                                   atol=2e-5 * max(1.0, np.abs(b).max()))


def test_textured_k4_matches_kytpu_checker():
    check_replay("checker")
