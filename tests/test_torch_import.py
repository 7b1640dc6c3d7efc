"""kytpu_torch imports without jax, and its entry points refuse what is not
ported instead of re-routing."""

import os
import subprocess
import sys

import pytest
import torch

from kytpu_torch.core import rng
from kytpu_torch.diff import inverse
from kytpu_torch.integrator import path
from kytpu_torch.integrator.render import render
from kytpu_torch.kernels import wavefront as kwf
from kytpu_torch.scene import builders

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_package_never_imports_jax():
    # conftest has imported jax in this process, so check in a fresh one
    code = (
        "import pkgutil, importlib, sys\n"
        "import kytpu_torch\n"
        "for m in pkgutil.walk_packages(kytpu_torch.__path__, 'kytpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'kytpu' or k.startswith('kytpu.'))\n"
        "print(len([k for k in sys.modules if k.startswith('kytpu_torch')]))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15   # every module was imported


def test_render_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        render(builders.veach_mis(8, 6), spp=1, device="cuda")


def test_render_defaults_to_the_card():
    """Without device= render runs on the card; with no card it raises, it
    never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        render(builders.veach_mis(8, 6), spp=1)


def test_tracer_runs_the_plain_version_only_on_cpu_tensors():
    scene = builders.cornell_box(width=4, height=4)
    tracer = kwf.make_cuda_tracer(scene, kwf.KernelConfig(max_depth=1))
    o = torch.zeros(8, 3)
    d = torch.tensor([[0.0, -1.0, 0.0]]).repeat(8, 1)
    assert tracer(scene, o, d, 1).shape == (8, 3)
    with pytest.raises(ValueError, match="no kernel"):
        tracer(scene, o.to("meta"), d.to("meta"), 1)


@pytest.mark.parametrize("engine", ["jnp", "fast", "path"])
def test_jnp_engines_run_on_the_cpu(engine):
    img = render(builders.cornell_box(width=4, height=4), spp=2,
                 engine=engine, device="cpu")
    assert img.shape == (4, 4, 3) and img.device.type == "cpu"
    assert torch.isfinite(img).all() and img.mean() > 0


@pytest.mark.parametrize("kwargs", [dict(engine="pallas"),
                                    dict(engine="jnp", mode="volume")])
def test_unknown_engine_or_mode_raises(kwargs):
    with pytest.raises(ValueError, match="unknown"):
        render(builders.cornell_box(width=4, height=4), spp=1, device="cpu",
               **kwargs)


@pytest.mark.parametrize("call", ["render", "render_aov", "render_region",
                                  "debug_pixel", "render_once",
                                  "make_train_step"])
def test_jnp_entry_points_default_to_the_card(call):
    """The jnp engines' entry points run on the card unless device="cpu";
    with no card they raise, they never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import importlib
    r = importlib.import_module("kytpu_torch.integrator.render")
    sc = builders.cornell_box(width=4, height=4)
    calls = {
        "render": lambda: r.render(sc, spp=1, engine="jnp"),
        "render_aov": lambda: r.render_aov(sc, "normal", spp=1),
        "render_region": lambda: r.render_region(sc, 0, 0, 2, 2, spp=1),
        "debug_pixel": lambda: r.debug_pixel(sc, 1, 1, spp=1),
        "render_once": lambda: inverse.render_once(
            sc, rng.key(0), 1, path.PathConfig()),
        "make_train_step": lambda: inverse.make_train_step(
            sc, torch.zeros(4, 4, 3), engine="jnp"),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[call]()
