"""What the benchmark may import: no module under ``benchmark/`` imports JAX,
its libraries or the JAX package, and the reference imports nothing of the
program either. Names are compared whole by their top-level part, since the
port's package name begins with the JAX package's."""

from __future__ import annotations

import ast
import os

import pytest

from benchmark.tests.support import ROOT

BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "csts_tpu"}


def _sources(sub: str = ""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path: str):
    """The top-level names of the absolute imports of a file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", list(_sources()), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_anywhere(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", list(_sources("reference")), ids=lambda p: os.path.relpath(p, ROOT))
def test_reference_imports_nothing_of_the_program(path):
    names = set(_imports(path))
    assert not names & (FORBIDDEN | {"csts_torch", "benchmark"}), names
    assert names <= {"__future__", "dataclasses", "math", "typing", "numpy", "torch"}


def test_whole_names_are_compared():
    from benchmark import harness

    assert "csts_torch" not in harness.FORBIDDEN and "csts_tpu" in harness.FORBIDDEN
