"""The CUDA forward megakernel against its plain PyTorch version, on the
card. Needs a CUDA device and nvcc; skipped elsewhere. Run on the card with

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py -q

(the suite's conftest imports jax, which the card's machine does not need)."""

import numpy as np
import pytest
import torch

from kytpu_torch.kernels import wavefront as kwf
from kytpu_torch.scene import builders
from kytpu_torch.scene.scene import generate_rays

ALL_LIGHTS = {builders.LARGE_GLASS_SPHERE, builders.LIGHT_POINT,
              builders.LIGHT_DIRECTION, builders.LIGHT_ENVIRONMENT}


def many_lights(b, n_lights: int, width: int = 24, height: int = 16):
    """A matte floor and a glossy back wall lit by a point light and
    n_lights - 1 small sphere lights in a row, built with the builders
    module `b` (kytpu's or the port's, which share the assembler's API).
    The last sphere is light n_lights - 1, so at 32 lights its skip bit is
    the table's sign bit."""
    A = b._SceneAssembler
    a = A()
    g = a.geo
    a.surface(g.add_rectangle((-10, -2, 10), (-10, -2, -10), (10, -2, -10),
                              (10, -2, 10), flip_normal=True),
              A.matte(np.full(3, 0.5, np.float32)))
    a.surface(g.add_rectangle((-10, -10, 3), (-10, 10, 3), (10, 10, 3),
                              (10, -10, 3), flip_normal=True),
              A.plastic(np.float32([0.1, 0.1, 0.15]), np.ones(3, np.float32),
                        100.0))
    a.add_light(kind=b.klights.POINT, emit=np.full(3, 5.0, np.float32),
                position=np.float32([0.0, 3.0, -2.0]))
    n_sph = n_lights - 1
    for k in range(n_sph):
        c = (-4.5 + 9.0 * k / max(n_sph - 1, 1), 1.0 + 0.25 * (k % 3), 0.0)
        r = 0.05 + 0.03 * (k % 5)
        emit = np.full(3, 40.0 / (1 + k % 4), np.float32)
        slot = a.add_light(kind=b.klights.AREA_SPHERE, emit=emit,
                           center=np.asarray(c), radius=r)
        a._lights[slot]["surface_handle"] = a.surface(
            g.add_sphere(c, r), A.matte(np.zeros(3, np.float32)),
            emission=emit, light_slot=slot)
    cam = b.kscene.make_camera(position=(0.0, 1.0, -8.0),
                               front=(0.0, -0.2, 1.0), up=(0.0, 1.0, 0.0),
                               fov_degrees=50.0, width=width, height=height)
    return a.build(cam)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("scene, sampler, nee, shadow", [
    ("veach", "random", "all", "parity"),
    ("veach", "hash", "single", "robust"),
    ("cornell", "hash", "all", "robust"),
    ("cornell_lights", "random", "single", "parity"),
    ("cornell_lights", "hash", "all", "parity"),
    ("many_lights_11", "random", "all", "parity"),
    ("many_lights_32", "hash", "all", "robust"),
    ("many_lights_32", "random", "single", "parity"),
])
def test_kernel_matches_plain_on_card(cuda, scene, sampler, nee, shadow):
    sc = {"veach": lambda: builders.veach_mis(64, 40),
          "cornell": lambda: builders.cornell_box(width=64, height=64),
          "cornell_lights": lambda: builders.cornell_box(ALL_LIGHTS, 64, 64),
          "many_lights_11": lambda: many_lights(builders, 11, 64, 40),
          "many_lights_32": lambda: many_lights(builders, 32, 64, 40),
          }[scene]().to(cuda)
    n = 16384
    npix = sc.camera.width * sc.camera.height
    rng = np.random.default_rng(0)
    pix = np.arange(n) % npix
    pf = np.stack([pix % sc.camera.width + rng.random(n),
                   pix // sc.camera.width + rng.random(n)], -1)
    o, d = generate_rays(sc.camera, torch.tensor(pf, dtype=torch.float32,
                                                 device=cuda))
    si = torch.tensor(np.arange(n) // npix, dtype=torch.int32, device=cuda)
    pix = torch.tensor(pix, dtype=torch.int32, device=cuda)
    cfg = kwf.KernelConfig(max_depth=5, sampler=sampler, nee=nee,
                           shadow=shadow)
    before = kwf.launches
    got = kwf.render_lanes_cuda(sc, o, d, 3, cfg, si, pix)
    torch.cuda.synchronize()
    assert kwf.launches == before + 1
    ref = kwf.trace_lanes_plain(kwf.pack_tables(sc, cfg), cfg, o, d, 3, si,
                                pix)
    g, r = got.cpu().numpy(), ref.cpu().numpy()
    assert np.isfinite(g).all()
    bad = (~np.isclose(g, r, rtol=1e-3, atol=1e-4)).any(-1).mean()
    assert bad <= 0.005, bad
