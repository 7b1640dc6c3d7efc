"""K1-K4 past 64 surfaces (kernels/wavefront.py): the row-tagged route of
the backwards K3 and K4, the wide row field of K2's int cache, and the two
kernel families against each other where both run.

- Forced on scenes of at most 64 surfaces (DENSE_MAX_ROWS monkeypatched to
  0), the row-tagged K3 and K4 equal the dense ones, which the other files
  hold to kytpu: within rtol=1e-5 plus 1e-6 of each table's largest entry
  (the same per-lane terms, summed by row in another fixed order); and on
  the Cornell box against kytpu's K3 run interpreted on the same lanes
  (test_torch_wavefront_res.trace_grads): the tagged K3 at that file's
  bound, rtol=1e-4 plus 1e-6 of the largest entry, the tagged K4 at the
  K4/K3 cross-check bound, rtol=2e-3 plus 2e-5 of the largest entry;
- past 64 surfaces, on random_spheres(n=80) (82 surfaces, which both
  families take), through `kwf.make_cuda_diff_tracer` and
  `kbs.make_bigscene_diff_tracer` on the same lanes: the plain K1 against
  the plain K5 (at most 0.5% of lanes off by more than 1e-3), the tagged K3
  against K7 and the tagged K4 against the tagged K3 within rtol=2e-3 plus
  2e-5 of the largest entry, d_emission compared on the emissive rows only
  (the baked kernels leave the other rows' emission gradient 0, kytpu's
  convention, tests/test_bigscene.py:484-496);
- past 255 surfaces, on random_spheres(n=300) (302 surfaces) at depth 2:
  K2's int plane carries rows above 255 whole (`kwf.unpack_row`), and the
  gradients of those rows are live and equal K7's.
"""

import numpy as np
import pytest
import torch

from kytpu.scene import builders as jb
from kytpu_torch.kernels import bigscene as kbs
from kytpu_torch.kernels import wavefront as kwf
from kytpu_torch.scene import builders as tb
from tests.test_torch_bigscene_tables import _lanes
from tests.test_torch_wavefront import SCENES, camera_rays
from tests.test_torch_wavefront_res import N, grads_agree, trace_grads
import tests.torch_threads  # noqa: F401  (one torch thread a process)

IMG8 = np.random.default_rng(4).uniform(0.1, 0.9, (8, 8, 3)).astype(
    np.float32)
SMALL = {
    "cornell": lambda: tb.cornell_box(width=16, height=16),
    "veach": lambda: tb.veach_mis(16, 12),
    "textured": lambda: tb.cornell_box(width=16, height=16,
                                       floor_checker=True, back_image=IMG8),
}


def close(got, ref, rtol, atol, emissive=None):
    assert len(got) == len(ref)
    for k, (a, b) in enumerate(zip(got, ref)):
        if k == 2 and emissive is not None:
            a, b = a[emissive], b[emissive]
        scale = max(1.0, float(b.abs().max()))
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol,
                                   atol=atol * scale, err_msg=f"table {k}")


def backwards(sc, cfg, n, seed=0):
    """K3's and K4's gradients of a seeded upstream gradient on n lanes."""
    o, d, si, pix = _lanes(sc, n, seed)
    tabs = kwf.pack_tables(sc, cfg)
    big_l, resf, resi = kwf.trace_lanes_plain(tabs, cfg, o, d, 3, si, pix,
                                              residual=True)
    g = torch.tensor(np.random.default_rng(1).standard_normal((n, 3)),
                     dtype=torch.float32)
    return (kwf.bwd_res(tabs, cfg, g, big_l, resf, resi),
            kwf.bwd_replay(tabs, cfg, o, d, 3, si, pix, g, big_l))


@pytest.mark.parametrize("name", sorted(SMALL))
def test_tagged_route_equals_dense(name, monkeypatch):
    sc = SMALL[name]()
    for texp in (False, True):
        cfg = kwf.KernelConfig(max_depth=2, rows=8, sampler="hash",
                               trainable_exponent=texp)
        dense = backwards(sc, cfg, 512)
        monkeypatch.setattr(kwf, "DENSE_MAX_ROWS", 0)
        assert kwf.row_tagged(kwf.extract_static(sc, occl_skip=False))
        tagged = backwards(sc, cfg, 512)
        monkeypatch.setattr(kwf, "DENSE_MAX_ROWS", 64)
        for t, d in zip(tagged, dense):
            close(t, d, 1e-5, 1e-6)


def test_tagged_route_matches_kytpu(monkeypatch):
    monkeypatch.setattr(kwf, "DENSE_MAX_ROWS", 0)
    got, ref, static = trace_grads("cornell", "hash", "all")
    tsc = SCENES["cornell"](tb)
    assert kwf.row_tagged(kwf.extract_static(tsc, occl_skip=False))
    grads_agree(got[1], ref[1], static)
    # the tagged K4 on trace_grads' lanes, seed and upstream gradient
    cfg = kwf.KernelConfig(max_depth=2, rr_start=0, rows=8, sampler="hash",
                           nee="all")
    o, d, si, pix = [torch.from_numpy(np.array(a))
                     for a in camera_rays(SCENES["cornell"](jb), N)]
    g = np.random.default_rng(3).standard_normal((N, 3)).astype(np.float32)
    leaves = [t.clone().requires_grad_() for t in (
        tsc.mat_diffuse, tsc.mat_specular, tsc.emission, torch.zeros(3))]
    out = kwf.make_cuda_diff_tracer(tsc, cfg, backward="replay")(
        *leaves, o, d, 7, si, pix)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(), got[0])
    close([t.grad for t in leaves], [torch.tensor(r) for r in ref[1]],
          2e-3, 2e-5)


def both_families(sc, cfg, n):
    """(K1, K5 radiance, the K3, K4 and K7 gradients of the same loss) on
    the same lanes, through the two diff tracers."""
    o, d, si, pix = _lanes(sc, n, 5)
    w = torch.tensor(np.random.default_rng(6).random((n, 3)),
                     dtype=torch.float32)
    p0 = [sc.mat_diffuse, sc.mat_specular, sc.emission, sc.env_radiance_]
    outs, grads = {}, {}
    for nm, tracer in (
            ("K3", kwf.make_cuda_diff_tracer(sc, cfg)),
            ("K4", kwf.make_cuda_diff_tracer(sc, cfg, backward="replay")),
            ("K7", kbs.make_bigscene_diff_tracer(sc, cfg))):
        leaves = [t.clone().requires_grad_() for t in p0]
        out = tracer(*leaves, o, d, 9, si, pix)
        (out * w).sum().backward()
        outs[nm], grads[nm] = out.detach(), [t.grad for t in leaves]
    return outs["K3"], outs["K7"], grads


def test_families_agree_past_64_surfaces():
    sc = tb.random_spheres(n=80, width=16, height=16, seed=1)
    assert kwf.row_tagged(kwf.extract_static(sc, occl_skip=False))
    cfg = kwf.KernelConfig(max_depth=2, rows=8, sampler="hash")
    k1, k5, grads = both_families(sc, cfg, 1024)
    assert (np.abs(k5 - k1).numpy() > 1e-3).any(-1).mean() <= 0.005
    emissive = sc.emission.sum(-1) > 0
    close(grads["K3"], grads["K7"], 2e-3, 2e-5, emissive)
    close(grads["K4"], grads["K3"], 2e-3, 2e-5)
    assert all(float(t.abs().max()) > 1e-3 for t in grads["K3"])


def test_rows_past_255():
    sc = tb.random_spheres(n=300, width=16, height=16, seed=1)
    M = int(sc.mat_kind.shape[0])
    assert M == 302
    cfg = kwf.KernelConfig(max_depth=2, rows=8, sampler="hash")
    o, d, si, pix = _lanes(sc, 384, 5)
    _, _, resi = kwf.trace_lanes_plain(kwf.pack_tables(sc, cfg), cfg, o, d, 9,
                                       si, pix, residual=True)
    rows = kwf.unpack_row(resi) - 1
    assert int(rows.max()) > 255 and int(rows.min()) == -1
    assert (resi[0] & 255).max() <= 255 and int((resi >> 16).max()) == 1
    _, _, grads = both_families(sc, cfg, 384)
    emissive = sc.emission.sum(-1) > 0
    close(grads["K3"], grads["K7"], 2e-3, 2e-5, emissive)
    close(grads["K4"], grads["K3"], 2e-3, 2e-5)
    high = torch.arange(M) > 255
    live = (grads["K3"][0][high].abs().sum(-1) > 0).sum()
    assert live >= 3, live
    np.testing.assert_array_equal(grads["K3"][0][high] != 0,
                                  grads["K7"][0][high] != 0)
