"""The plain big-scene K8 against kytpu's under the "random" sampler and
robust shadows, no trainable exponent, and against central differences of
the port's own K5. Setup and tolerances of the kytpu check as in
test_torch_bigscene_replay.py; the finite differences as
test_torch_bigscene_tables.py's K7 check (step 1e-2, |ad - fd| <= 3e-3
max(|fd|, 1e-2), the bound of tests/test_kernel.py's replay check)."""

import numpy as np
import torch

from kytpu_torch.kernels import bigscene as kbs
from kytpu_torch.kernels import wavefront as kwf
from kytpu_torch.scene import builders as tb
from tests.test_torch_bigscene_replay import check_against_kytpu
from tests.test_torch_bigscene_tables import _lanes


def test_k8_matches_kytpu_random_robust():
    check_against_kytpu("random", "robust", texp=False)


def test_k8_matches_finite_differences():
    sc = tb.random_spheres(n=80, width=16, height=16, seed=1)
    cfg = kwf.KernelConfig(max_depth=2, rows=8, sampler="sobol",
                           trainable_exponent=True)
    n = 1024
    o, d, si, pix = _lanes(sc, n, 5)
    wts = torch.tensor(np.random.default_rng(6).random((n, 3)),
                       dtype=torch.float32)
    tracer = kbs.make_bigscene_diff_tracer(sc, cfg, backward="replay")
    p0 = [sc.mat_diffuse, sc.mat_specular, sc.emission, sc.mat_exponent,
          sc.env_radiance_]

    def loss(*p):
        return (tracer(*p, o, d, 9, si, pix) * wts).sum() / n

    leaves = [t.clone().requires_grad_() for t in p0]
    loss(*leaves).backward()
    light = sc.lights.surface_ids[0]
    kinds = sc.mat_kind.tolist()
    hits = np.bincount(kbs.trace_lanes(kbs.pack_big_tables(sc, cfg), cfg, o,
                                       d, 9, si, pix, residual=True)[2][0]
                       .numpy() & kbs.RESI_ROW_MASK,
                       minlength=len(kinds) + 1)[1:]
    matte = max((r for r in range(1, len(kinds)) if kinds[r] == 0),
                key=lambda r: hits[r])
    mirror = max((r for r in range(len(kinds)) if kinds[r] == 1),
                 key=lambda r: hits[r])
    probes = [(0, (0, 0)), (0, (0, 2)), (0, (matte, 1)), (1, (mirror, 0)),
              (2, (light, 0)), (4, (2,))]
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
        assert abs(ad - fd) <= 3e-3 * max(abs(fd), 1e-2), (argi, idx, ad, fd)
        assert abs(fd) > 1e-4, (argi, idx, fd)
    # the plastic spheres get an exponent gradient, and nothing else does
    dexp = leaves[3].grad.numpy()
    plastic = np.asarray(kinds) == 3
    assert np.abs(dexp[plastic]).max() > 0 and (dexp[~plastic] == 0).all()
