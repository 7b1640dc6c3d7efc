"""The benchmark's import rules: top-level module names compared whole
(kytpu_torch is not kytpu), and a reference that loads nothing of the
port, JAX or the JAX package."""

import subprocess
import sys
import types

from perfbench import harness
from perfbench.tests.conftest import ROOT


def test_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "kytpu_torch_extra", types.ModuleType(
        "kytpu_torch_extra"))
    monkeypatch.setitem(sys.modules, "jaxlike", types.ModuleType("jaxlike"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType(
        "jax.numpy"))
    monkeypatch.setitem(sys.modules, "kytpu.core", types.ModuleType(
        "kytpu.core"))
    assert harness.forbidden_modules() == ["jax", "kytpu"]


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import perfbench.reference.oracle, "
            "perfbench.counts.transport, perfbench.compare; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'kytpu', 'kytpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_loads_no_jax():
    """The harness and both entry modules with the port: no JAX, no kytpu."""
    code = ("import sys; from perfbench import harness; "
            "import perfbench.entries.train, perfbench.entries.frame, "
            "perfbench.devtrace; import kytpu_torch.diff.inverse, "
            "kytpu_torch.integrator.render; print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
