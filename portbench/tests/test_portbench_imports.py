"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program.  Top-level module names are
compared whole: ``repro_torch`` is not ``repro``."""
import ast
import os
import sys

import pytest

from conftest import ROOT
from portbench import harness

PKG = os.path.join(ROOT, "portbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _modules():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".", 1)[0])
    return tops


def _files():
    files = sorted(_modules())
    assert len(files) > 20
    return files


@pytest.mark.parametrize("path", _files(),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not (_top_level_imports(path) & FORBIDDEN)


@pytest.mark.parametrize("path", [p for p in _files()
                                  if os.sep + "reference" + os.sep in p],
                         ids=lambda p: os.path.relpath(p, PKG))
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in _top_level_imports(path)


def test_the_run_time_check_compares_whole_names(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "repro_torch_lookalike",
                        types.ModuleType("repro_torch_lookalike"))
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "repro.models",
                        types.ModuleType("repro.models"))
    assert harness.forbidden_loaded() == ["repro"]
