"""The plain textured K2 and K3 against kytpu's on a 4x4 atlas, which kytpu
fetches through its select chain (setup and tolerances as in
test_torch_texture_res.py; a 4x4 atlas keeps kytpu's interpreted chain,
one select a texel and tap, within the test's time), and the port's texel
and checker gradients against central differences of its own plain K1
(step 1e-2, |ad - fd| <= 3e-3 max(|fd|, 1e-2), the bound of
tests/test_texture.py's finite-difference checks)."""

import numpy as np
import torch

from kytpu_torch.kernels import wavefront as twf
from kytpu_torch.scene import builders as tb
from tests.test_torch_texture import IMG4
from tests.test_torch_texture_res import check
from tests.test_torch_bigscene_tables import _lanes


def test_textured_k2_k3_match_kytpu_select_chain():
    check("img4")


def test_texture_gradients_match_finite_differences():
    sc = tb.cornell_box(width=8, height=8, floor_checker=True,
                        back_image=IMG4)
    n = 512
    o, d, si, pix = _lanes(sc, n, 5)
    wts = torch.tensor(np.random.default_rng(6).random((n, 3)),
                       dtype=torch.float32)
    tx = sc.textures
    p0 = [tx.color_a, tx.color_b, tx.image]
    env = torch.zeros(3)
    for backward in ("residual", "replay"):
        tracer = twf.make_cuda_diff_tracer(
            sc, twf.KernelConfig(max_depth=3, rows=8, sampler="hash"),
            backward)

        def loss(*p):
            return (tracer(sc.mat_diffuse, sc.mat_specular, sc.emission,
                           *p, env, o, d, 9, si, pix) * wts).sum() / n

        leaves = [t.clone().requires_grad_() for t in p0]
        loss(*leaves).backward()
        gi = leaves[2].grad
        texel = np.unravel_index(int(gi.sum(-1).argmax()), gi.shape[:3])
        probes = [(0, (0, 1)), (1, (0, 0)), (2, (*texel, 0)),
                  (2, (*texel, 2))]
        eps = 1e-2
        for argi, idx in probes:
            fd = []
            for sgn in (1.0, -1.0):
                p = [t.clone() for t in p0]
                p[argi][idx] += sgn * eps
                with torch.no_grad():
                    fd.append(float(loss(*p)))
            fd = (fd[0] - fd[1]) / (2 * eps)
            ad = float(leaves[argi].grad[idx])
            assert abs(ad - fd) <= 3e-3 * max(abs(fd), 1e-2), \
                (backward, argi, idx, ad, fd)
            assert abs(fd) > 1e-4, (backward, argi, idx, fd)
