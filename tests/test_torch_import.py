"""kytpu_torch imports without jax, and its entry points refuse what is not
ported instead of re-routing."""

import os
import subprocess
import sys

import pytest
import torch

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


@pytest.mark.parametrize("kwargs, item", [
    (dict(engine="jnp"), "M7"),
    (dict(engine="fast"), "M7"),
    (dict(engine="path"), "M7"),
])
def test_unported_paths_raise(kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        render(builders.cornell_box(width=4, height=4), spp=1, **kwargs)
