"""The port's profiling, checks and finite-difference modules
(kytpu_torch/utils/profiling.py, utils/checks.py, diff/fd_check.py)
against kytpu's: the timer's report, the checks' exceptions and messages,
and autodiff against central differences on a jnp render.

Tolerance: the report and messages equal as strings; autodiff within
kytpu's bound of tests/test_grad.py (2e-2 of |fd|, at least 2e-5).
"""

import os

import numpy as np
import pytest
import torch

from kytpu.utils import checks as jchecks
from kytpu.utils.profiling import RenderTimer as JTimer
from kytpu_torch.core import rng as trng
from kytpu_torch.diff import check_gradients, fd_gradient, get_params
from kytpu_torch.diff.inverse import render_once
from kytpu_torch.integrator.path import PathConfig
from kytpu_torch.scene import builders as tb
from kytpu_torch.utils import checks as tchecks
from kytpu_torch.utils import profiling as tprof
import tests.torch_threads  # noqa: F401  (one torch thread a process)


def test_timer_report_matches_kytpu():
    phases = {"target": 0.1234567, "optimize": 12.5, "x" * 20: 0.0}
    ref = JTimer(phases=dict(phases), rays=3_000_000)
    got = tprof.RenderTimer(phases=dict(phases), rays=3_000_000)
    assert got.report() == ref.report()
    assert got.rays_per_second() == ref.rays_per_second()
    empty = tprof.RenderTimer()
    assert empty.report() == JTimer().report()
    with empty.phase("a", rays=10):
        pass
    with empty.phase("a", rays=5):
        pass
    assert list(empty.phases) == ["a"] and empty.rays == 15
    assert empty.total > 0


def test_trace_to_writes_a_chrome_trace(tmp_path):
    with tprof.trace_to(str(tmp_path / "tr")) as prof:
        torch.ones(8).sum()
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".json")
    assert prof.key_averages() is not None


def _bad(kind):
    a = np.ones((4, 5, 3), np.float32)
    if kind == "nan":
        a[1, 2, 0] = np.nan
    elif kind == "inf":
        a[0, 0, 1] = np.inf
        a[3, 4, 2] = -np.inf
    elif kind == "neg":
        a[2, 1, 1] = -0.5
    elif kind == "nan_and_neg":
        a[0, 0, 0] = np.nan
        a[0, 0, 1] = -1.0
    return a


@pytest.mark.parametrize("kind", ["fine", "nan", "inf", "neg",
                                  "nan_and_neg"])
def test_validate_radiance_matches_kytpu(kind):
    a = _bad(kind)
    outcomes = []
    for fn, arg in ((jchecks.validate_radiance, a),
                    (tchecks.validate_radiance, a),
                    (tchecks.validate_radiance, torch.from_numpy(a))):
        try:
            fn(arg, name="img")
            outcomes.append(None)
        except (FloatingPointError, ValueError) as e:
            outcomes.append((type(e), str(e)))
    assert outcomes[0] == outcomes[1] == outcomes[2]
    assert (outcomes[0] is None) == (kind == "fine")


def test_checked_raises_only_when_enabled():
    x = torch.tensor([1.0, float("nan"), 2.0, float("inf")])
    was = tchecks.enabled()
    try:
        tchecks.enable(False)
        assert tchecks.checked(x, "lane") is x
        tchecks.enable(True)
        with pytest.raises(FloatingPointError,
                           match="kytpu check failed: lane has 2 non-finite"):
            tchecks.checked(x, "lane")
        y = torch.ones(3)
        assert tchecks.checked(y) is y
    finally:
        tchecks.enable(was)


def test_fd_gradient_shifts_a_copy():
    p = {"a": torch.tensor([1.0, 2.0, 3.0]), "b": torch.tensor([5.0])}
    before = {k: v.clone() for k, v in p.items()}
    g = fd_gradient(lambda q: (q["a"] ** 2).sum() * q["b"][0], p, "a", (1,),
                    eps=1e-2)
    assert abs(float(g) - 20.0) < 1e-2
    assert all(torch.equal(p[k], before[k]) for k in p)


def test_check_gradients_on_a_jnp_render():
    scene = tb.cornell_box(width=8, height=8)
    cfg = PathConfig(max_depth=1, variant="iteration", strategy="both_mis")
    key = trng.key(3)

    def loss_of_scene(sc):
        return render_once(sc, key, spp=1, cfg=cfg, device="cpu").mean()

    em = get_params(scene)["emission"].numpy()
    row = int(np.argmax(em.sum(axis=1)))
    probes = [("mat_diffuse", (2, 0)), ("mat_diffuse", (0, 1)),
              ("emission", (row, 0))]
    results = check_gradients(scene, loss_of_scene, probes, eps=5e-3)
    assert [(n, i) for n, i, _, _ in results] == probes
    for name, idx, ad, fd in results:
        assert np.isfinite(ad) and np.isfinite(fd), (name, idx, ad, fd)
        assert abs(ad - fd) <= 2e-2 * max(abs(fd), 1e-3), (name, idx, ad, fd)
    assert any(abs(fd) > 1e-4 for _, _, _, fd in results)
