"""The CUDA lane body of the camera-rays kernel (csrc/camera_rays.cu
`camera_ray`) compiled with g++ and run on the CPU against its plain
version, kernels/camera.py `lane_rays_plain`, bit for bit.

The source compiles on the host with tests/csrc_stub/cuda_runtime.h in
place of the CUDA runtime header (the <<<...>>> launch configuration
stripped) and -ffp-contract=off, so the host rounds the arithmetic as the
card does: 32-bit Threefry words, float adds, multiply-adds taken in double
and one IEEE division. A small harness runs lane 0 .. n - 1 in turn.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from kytpu_torch.core import rng as krng
from kytpu_torch.kernels import camera as kcam
from kytpu_torch.scene import builders
import tests.torch_threads  # noqa: F401  (one torch thread a process)

CSRC = Path(kcam.__file__).resolve().parent / "csrc"
STUB = Path(__file__).resolve().parent / "csrc_stub"

HARNESS = r"""
#include "camera_rays.cu"

extern "C" void host_rays(float* d, int n, int npix, int w, int mode, unsigned k0,
                          unsigned k1, unsigned base, float inv_w, float inv_h,
                          const float* b) {
  const RayArgs a{d,     n,     npix,               w,
                  mode,  k0,    k1,                 base,
                  inv_w, inv_h, {b[0], b[1], b[2]}, {b[3], b[4], b[5]},
                  {b[6], b[7], b[8]}};
  for (int l = 0; l < n; ++l) camera_ray(a, (uint32_t)l, d + 3 * (size_t)l);
}
"""


@pytest.fixture(scope="module")
def host_rays(tmp_path_factory):
    """The harness built from csrc/camera_rays.cu; skips without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA lane body on the host")
    build = tmp_path_factory.mktemp("csrc_rays")
    text = (CSRC / "camera_rays.cu").read_text()
    (build / "camera_rays.cu").write_text(re.sub(r"<<<[^>]*>>>", "", text))
    (build / "harness.cpp").write_text(HARNESS)
    lib = build / "librays.so"
    res = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-w", "-shared",
         "-fPIC", "-I", str(STUB), "-I", str(build), "-o", str(lib),
         str(build / "harness.cpp")], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-4000:]
    fn = ctypes.CDLL(str(lib)).host_rays
    i, u, f, p = ctypes.c_int, ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p
    fn.argtypes = [p] + [i] * 4 + [u] * 3 + [f, f, p]
    fn.restype = None
    return fn


@pytest.mark.parametrize("mode, seed, sample_base", [
    ("random", 0, 0), ("random", 2**31 + 7, 0), ("random", -5, 0),
    ("hash", 1234, 0), ("hash", 2**32 - 1, 6), ("hash", 77, 2_800_000)])
def test_camera_ray_lanes_match_plain(host_rays, mode, seed, sample_base):
    """Each lane's direction the same bits as the plain chain's, on an odd
    film (51 x 31) over 3 samples and 100 lanes more; the largest sample
    base wraps base * npix past 2**32."""
    cam = builders.veach_mis(51, 31).camera
    npix = 51 * 31
    n = 3 * npix + 100
    words = krng.words(krng.fold_in(krng.key(seed), 4))
    _, want = kcam.lane_rays_plain(cam, words, n, npix, mode, sample_base)
    got = np.empty((n, 3), np.float32)
    basis = np.asarray(cam.host_basis(), np.float32)
    host_rays(got.ctypes.data, n, npix, cam.width, kcam.MODES.index(mode),
              words[0], words[1], sample_base * npix & 0xFFFFFFFF,
              float(np.float32(1 / cam.width)),
              float(np.float32(1 / cam.height)), basis.ctypes.data)
    np.testing.assert_array_equal(got.view(np.int32),
                                  want.numpy().view(np.int32))
