"""The seams of the port's kernel layer (kytpu_torch/kernels/), read from
the source: the kernel families' modules, kernels/wavefront.py (K1-K4) and
kernels/bigscene.py (K5-K8), keep their private names to themselves, no
module of kernels/ imports a family inside a function, and the shared
modules (launch, shading, autodiff, tag_sums, cull, tables, camera)
import neither family.
"""

import ast
from pathlib import Path

import pytest

PACKAGE = Path(__file__).resolve().parents[1] / "kytpu_torch"
FAMILIES = {"kytpu_torch.kernels.wavefront": "wavefront.py",
            "kytpu_torch.kernels.bigscene": "bigscene.py"}
SHARED = ("launch", "shading", "autodiff", "tag_sums", "cull", "tables",
          "camera")


def _imports(tree):
    """(family module, alias or imported name, the import node, whether it
    sits inside a function) of each import of a family."""
    out = []

    def visit(node, in_fn):
        for child in ast.iter_child_nodes(node):
            fn = in_fn or isinstance(child, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))
            if isinstance(child, ast.Import):
                for a in child.names:
                    if a.name in FAMILIES:
                        out.append((a.name, a.asname or a.name, child,
                                    in_fn))
            elif isinstance(child, ast.ImportFrom) and child.module:
                for a in child.names:
                    full = f"{child.module}.{a.name}"
                    if full in FAMILIES:
                        out.append((full, a.asname or a.name, child, in_fn))
                    elif child.module in FAMILIES:
                        out.append((child.module, a.name, child, in_fn))
            visit(child, fn)

    visit(tree, False)
    return out


def _sources():
    return sorted(PACKAGE.rglob("*.py"))


def test_no_module_reads_a_familys_private_names():
    bad = []
    for path in _sources():
        tree = ast.parse(path.read_text())
        aliases = {}
        for mod, name, node, _ in _imports(tree):
            if path.name == FAMILIES[mod]:
                continue
            if isinstance(node, ast.ImportFrom) and node.module == mod:
                if name.startswith("_"):
                    bad.append(f"{path}: from {mod} import {name}")
            else:
                aliases[name] = mod
        for node in ast.walk(tree):
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id in aliases
                    and node.attr.startswith("_")
                    and not node.attr.startswith("__")):
                bad.append(f"{path}:{node.lineno}: {node.value.id}."
                           f"{node.attr}")
    assert not bad, bad


@pytest.mark.parametrize("path", sorted(
    (PACKAGE / "kernels").glob("*.py")), ids=lambda p: p.name)
def test_kernel_modules_import_families_at_the_top(path):
    """No function of kernels/ imports a family (kernels/build's lazy
    loading of the library stays), and the shared modules import no
    family at all."""
    found = _imports(ast.parse(path.read_text()))
    assert not [f"{node.lineno}: {mod}" for mod, _, node, in_fn in found
                if in_fn]
    if path.stem in SHARED:
        assert not found, [mod for mod, *_ in found]
