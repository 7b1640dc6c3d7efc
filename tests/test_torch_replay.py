"""The plain path-replay backward (K4) against kytpu's, against the port's
coefficient-cache backward (K3), and against finite differences.

kytpu: `make_pallas_diff_tracer(backward="replay")` with its kernels in
interpret mode, and the port's `make_cuda_diff_tracer(backward="replay")` on
CPU tensors (its plain versions), on the same numpy-seeded 2048 lanes at
depth 2 (test_torch_wavefront_res.trace_grads). Tolerance: that file's,
|port - kytpu| <= 1e-4 |kytpu| + 1e-6 max(1, max|kytpu|) per table, with
the structural zeros exactly 0 in both. The tail peel R_{b+1} =
(R_b - E_b) / T_b divides by a throughput that the two packages round in
the last bit; at depth 2 it has not needed a wider bound.

K3 against K4: both of the port's plain backwards on the same lanes, at
the reference's own bound for this cross-check (tests/test_kernel.py:630),
rtol=2e-3 plus 2e-5 of the table's largest entry; the same forward
radiance, bit for bit. The hash/single case is in: the reference's K3 picks
the wrong light there (ROADMAP section 4), the port's two backwards agree.

Finite differences: central differences of the plain forward on the
env-lit Cornell box, as tests/test_kernel.py:353-387 (step 1e-2,
|ad - fd| <= 5e-3 max(|fd|, 1e-2)).
"""

import numpy as np
import pytest
import torch

from kytpu.scene import builders as jb
from kytpu_torch.kernels import wavefront as twf
from kytpu_torch.scene import builders as tb
from kytpu_torch.scene.scene import generate_rays
from tests.test_torch_wavefront import SCENES, camera_rays
from tests.test_torch_wavefront_res import grads_agree, trace_grads
import tests.torch_threads  # noqa: F401  (one torch thread a process)

# the all-lights box is in test_torch_replay_lights.py, Veach under
# hash/all/robust in test_torch_replay_veach.py (one file each, so that the
# interpret-mode traces spread over the test workers)
CASES = [("cornell", "random", "all", "parity")]


@pytest.fixture(scope="module", params=CASES, ids=["-".join(c) for c in CASES])
def replay(request):
    name, sampler, nee, shadow = request.param
    return trace_grads(name, sampler, nee, shadow=shadow, backward="replay")


def test_replay_radiance_matches_kytpu(replay):
    replay_radiance_agrees(replay)


def test_replay_gradients_match_kytpu(replay):
    got, ref, static = replay
    grads_agree(got[1], ref[1], static)


def replay_radiance_agrees(case):
    (big_l, *_), (ref_l, *_), _ = case
    np.testing.assert_allclose(big_l, ref_l, rtol=1e-3, atol=1e-4)


def _lanes(name, n=2048):
    o, d, si, pix = camera_rays(SCENES[name](jb), n)
    return [torch.from_numpy(np.array(a)) for a in (o, d, si, pix)]


PORT_CASES = [("cornell", "random", "all", "parity", 2),
              ("cornell_lights", "hash", "single", "parity", 3),
              ("cornell_lights", "sobol", "all", "robust", 3),
              ("veach", "random", "single", "robust", 3),
              ("veach", "hash", "all", "parity", 2)]


@pytest.mark.parametrize("name, sampler, nee, shadow, depth", PORT_CASES)
def test_port_k3_matches_port_k4(name, sampler, nee, shadow, depth):
    sc = SCENES[name](tb)
    cfg = twf.KernelConfig(max_depth=depth, rr_start=1, rows=8,
                           sampler=sampler, nee=nee, shadow=shadow)
    o, d, si, pix = _lanes(name)
    g = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (len(o), 3)).astype(np.float32))
    p0 = [sc.mat_diffuse, sc.mat_specular, sc.emission,
          sc.env_radiance_ if sc.has_env else torch.zeros(3)]
    outs, grads = [], []
    for backward in ("residual", "replay"):
        leaves = [t.clone().requires_grad_() for t in p0]
        out = twf.make_cuda_diff_tracer(sc, cfg, backward)(*leaves, o, d, 5,
                                                           si, pix)
        out.backward(g)
        outs.append(out.detach())
        grads.append([t.grad for t in leaves])
    assert torch.equal(outs[0], outs[1])
    for k3, k4 in zip(*grads):
        scale = max(1.0, float(k3.abs().max()))
        np.testing.assert_allclose(k4.numpy(), k3.numpy(), rtol=2e-3,
                                   atol=2e-5 * scale)
    assert max(float(t.abs().max()) for t in grads[1]) > 1e-3


def test_replay_matches_finite_differences():
    sc = SCENES["cornell_lights"](tb)
    cfg = twf.KernelConfig(max_depth=2, rows=8)
    n = 2048
    rng = np.random.default_rng(2)
    w, h = sc.camera.width, sc.camera.height
    pid = np.arange(n) % (w * h)
    pf = np.stack([pid % w + rng.random(n), pid // w + rng.random(n)], -1)
    o, d = generate_rays(sc.camera, torch.tensor(pf, dtype=torch.float32))
    tracer = twf.make_cuda_diff_tracer(sc, cfg, backward="replay")
    p0 = [sc.mat_diffuse, sc.mat_specular, sc.emission, sc.env_radiance_]

    def loss(*p):
        return tracer(*p, o, d, 9).mean()

    leaves = [t.clone().requires_grad_() for t in p0]
    loss(*leaves).backward()
    kinds = sc.mat_kind.tolist()
    plastic = kinds.index(3)
    eps = 1e-2
    for argi, idx in [(0, (0, 0)), (0, (4, 2)), (1, (plastic, 1)), (3, (0,)),
                      (3, (2,))]:
        fd = []
        for sgn in (1.0, -1.0):
            p = [t.clone() for t in p0]
            p[argi][idx] += sgn * eps
            with torch.no_grad():
                fd.append(float(loss(*p)))
        fd = (fd[0] - fd[1]) / (2 * eps)
        ad = float(leaves[argi].grad[idx])
        assert np.isfinite(ad) and np.isfinite(fd)
        assert abs(ad - fd) <= 5e-3 * max(abs(fd), 1e-2), (argi, idx, ad, fd)
    # the environment radiance gets a gradient in an env-lit scene
    assert abs(float(leaves[3].grad[0])) > 1e-5


def test_replay_tracer_runs_k1_then_k4():
    """The replay tracer's forward is K1 (bit for bit) and keeps no cache;
    its backward is `bwd_replay` on the saved lanes; without a table that
    needs a gradient nothing is saved."""
    sc = tb.cornell_box(width=8, height=8)
    cfg = twf.KernelConfig(max_depth=2, rows=1, sampler="hash")
    o, d, si, pix = _lanes("cornell", 256)
    tracer = twf.make_cuda_diff_tracer(sc, cfg, backward="replay")
    p0 = [sc.mat_diffuse, sc.mat_specular, sc.emission, torch.zeros(3)]
    tables = twf._DiffTables(sc, cfg)(*p0)
    k1 = twf.trace_lanes_plain(tables, cfg, o, d, 4, si, pix)
    out = tracer(*p0, o, d, 4, si, pix)
    assert out.grad_fn is None
    np.testing.assert_array_equal(out.numpy(), k1.numpy())
    leaves = [t.clone().requires_grad_() for t in p0]
    out = tracer(*leaves, o, d, 4, si, pix)
    np.testing.assert_array_equal(out.detach().numpy(), k1.numpy())
    g = torch.ones_like(out) / 256
    out.backward(g)
    ref = twf.bwd_replay_plain(tables, cfg, o, d, 4, si, pix, g, k1)
    for leaf, r in zip(leaves, ref):
        np.testing.assert_array_equal(leaf.grad.numpy(), r.numpy())
    with pytest.raises(ValueError, match="backward"):
        twf.make_cuda_diff_tracer(sc, cfg, backward="other")
