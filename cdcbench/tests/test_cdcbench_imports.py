"""The import guard: nothing under cdcbench/ imports JAX, flax, optax,
orbax or the JAX package (top-level names compared whole, so the port's
``tpucdc_torch`` is not ``tpucdc``); the reference imports nothing of the
port either; and no file reads the JAX package's old benchmark."""

from __future__ import annotations

import ast

import pytest

from cdcbench import core
from cdcbench.tests.helpers import ROOT

FILES = sorted((ROOT / "cdcbench").rglob("*.py"))


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_a_pure_reference(path):
    names = set(_imports(path))
    assert not names & set(core.FORBIDDEN), path
    if "reference" in path.relative_to(ROOT).parts:
        assert "tpucdc_torch" not in names, path


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_nothing_reads_the_old_benchmark(path):
    text = path.read_text()
    if path.name == "test_cdcbench_imports.py":
        return
    assert "bench.py" not in text and "BENCH_" not in text, path


def test_the_guard_compares_whole_names():
    assert "tpucdc" in core.FORBIDDEN and "tpucdc_torch" not in core.FORBIDDEN
