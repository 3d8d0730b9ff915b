"""No module of the benchmark imports JAX or the JAX package, and the
yardstick (reference, codes, traffic, work, trace, and every configuration's
own family and reference files) imports nothing of the program.  Each
import's top-level name is compared whole: the port's name begins with the
JAX package's."""

import ast
import os

import pytest

from benchmark import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "bp_osd_tpu"}
YARDSTICK = {"reference.py", "codes.py", "traffic.py", "work.py", "trace.py", "spec.py"}
PLUGINS = ("families", "references")  # a configuration's own code and reference


def _modules():
    for d, _, files in os.walk(spec.HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(d, f), spec.HERE)


def _imports(path):
    with open(os.path.join(spec.HERE, path)) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(_modules()))
def test_no_jax(path):
    assert not _imports(path) & FORBIDDEN


def _yardstick():
    files = set(YARDSTICK)
    for d in PLUGINS:
        if os.path.isdir(os.path.join(spec.HERE, d)):
            files |= {os.path.join(d, f) for f in os.listdir(os.path.join(spec.HERE, d))
                      if f.endswith(".py")}
    return sorted(files)


@pytest.mark.parametrize("path", _yardstick())
def test_yardstick_imports_nothing_of_the_program(path):
    assert "bp_osd_tpu_torch" not in _imports(path)


def test_the_run_check_compares_names_whole(monkeypatch):
    import sys
    import types

    from benchmark import cell

    for name in list(sys.modules):
        if name.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "bp_osd_tpu_torch_like", types.ModuleType("x"))
    assert cell.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "bp_osd_tpu.decoder", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert cell.forbidden_modules() == ["bp_osd_tpu", "jax"]
