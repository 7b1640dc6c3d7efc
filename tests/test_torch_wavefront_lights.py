"""`trace_lanes_plain` against kytpu's interpreted K1 (tolerance as in
test_torch_wavefront.py) in the sampler/NEE/shadow pairs that file leaves
out, and on a scene with 9 lights; and the packed tables at the kernel's
light limit.

The 9-light scene runs nee="all" at depth 1, which is enough to reach both
per-light stores the kernel sizes by its light limit: bounce 0 samples
every light (skip bits, hit pdfs) and bounce 1 weighs the emission it hits
with the stored hit pdf. It runs under shadow="robust": under "parity" its
sphere lights show the self-occlusion near-tie that
test_torch_wavefront_veach.py describes.
"""

import numpy as np
import pytest

from kytpu_torch.kernels import wavefront as twf
from kytpu_torch.scene import builders as tb
from tests.test_torch_cuda import many_lights
from tests.test_torch_wavefront import lanes_agree, trace_both


@pytest.mark.parametrize("name, sampler, nee, shadow, max_depth", [
    ("cornell_lights", "random", "single", "parity", 2),
    ("cornell_lights", "hash", "all", "robust", 2),
    ("many_lights", "hash", "all", "robust", 1),
])
def test_trace_lanes_plain_matches_interpreted_kernel_more(
        name, sampler, nee, shadow, max_depth):
    got, ref = trace_both(name, sampler, nee, shadow, max_depth=max_depth)
    share = lanes_agree(got, ref)
    print(f"{name} {sampler}/{nee}/{shadow}: {share:.4f} of lanes outside")


def test_pack_tables_at_the_light_limit():
    """32 lights pack: under shadow="robust" the last sphere light's own
    sphere carries bit 31, stored as the int32 sign bit the kernel reads
    as uint32; and every light reuses its sampled hit pdf (a phits slot)."""
    scene = many_lights(tb, twf.MAX_LIGHTS, 8, 8)
    t = twf.pack_tables(scene, twf.KernelConfig(shadow="robust"))
    i = t.i.numpy()
    n_pl, n_sp, _, L = (int(v) for v in i[:4])
    assert L == twf.MAX_LIGHTS and i[11] == 1
    masks = i[twf.HDR_I + twf.PL_I * n_pl:][:n_sp].view(np.uint32)
    np.testing.assert_array_equal(masks, [1 << k for k in range(1, L)])


def test_pack_tables_past_the_light_limit_names_its_item():
    scene = many_lights(tb, twf.MAX_LIGHTS + 1, 8, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP item M12"):
        twf.pack_tables(scene, twf.KernelConfig())
