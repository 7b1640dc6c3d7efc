"""render(engine="cuda", device="cpu") (the plain version) against kytpu's
render_pallas in interpret mode: same scene, seed, passes and camera jitter
(bit-exact threefry and rays), compared pixel by pixel.

Tolerance as in test_torch_wavefront.py, per pixel. Veach under the default
shadow="parity" allows 4% of pixels (each the mean of 2 lanes) outside the
bound, for the reason given in test_torch_wavefront_veach.py: the
reference's sphere-light self-occlusion is a near-tie that 1-ulp
differences in XLA's CPU transcendentals flip.
"""

import numpy as np
import pytest

from kytpu.kernels import wavefront as jwf
from kytpu.scene import builders as jb
from kytpu_torch.integrator.render import render
from kytpu_torch.kernels import wavefront as twf
from kytpu_torch.scene import builders as tb
from tests.test_torch_wavefront import lanes_agree


@pytest.mark.parametrize("scene, sampler, max_share", [
    ("veach", "random", 0.04),
    ("veach", "hash", 0.04),
    ("cornell", "hash", 0.005),
])
def test_render_matches_render_pallas(scene, sampler, max_share):
    make = {"veach": lambda b: b.veach_mis(24, 16),
            "cornell": lambda b: b.cornell_box(width=16, height=16)}[scene]
    kw = dict(max_depth=2, rows=8, sampler=sampler)
    ref = np.asarray(jwf.render_pallas(
        make(jb), spp=2, seed=5, cfg=jwf.KernelConfig(**kw), clamp=False,
        rays_per_pass=1 << 10, interpret=True))
    got = render(make(tb), spp=2, seed=5, cfg=twf.KernelConfig(**kw),
                 clamp=False, rays_per_pass=1 << 10, engine="cuda",
                 device="cpu").numpy()
    assert got.shape == ref.shape
    share = lanes_agree(got.reshape(-1, 3), ref.reshape(-1, 3), max_share)
    print(f"{scene} {sampler}: {share:.4f} of pixels outside the bound")
