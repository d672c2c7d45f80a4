"""No module of the benchmark imports JAX, flax or the reference package
``repro`` (top-level names compared whole: the port's ``repro_torch`` is
allowed), and none reads the JAX package's benchmark files."""

from __future__ import annotations

import ast

import pytest

from portbench import harness

#: the JAX package's benchmark files, which nothing here reads
JAX_PACKAGE_FILES = ("BENCH" + "_", "benchmarks" + "/", "TRACE" + "_serving")
SOURCES = sorted(p for p in harness.HERE.rglob("*.py")
                 if "__pycache__" not in p.parts)


def _imported_tops(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(harness.HERE))
                              for p in SOURCES])
def test_module_imports_nothing_forbidden(path):
    tops = set(_imported_tops(path))
    assert not tops & set(harness.FORBIDDEN_MODULES), tops
    text = path.read_text()
    for name in JAX_PACKAGE_FILES:
        assert name not in text


def test_forbidden_names_are_compared_whole():
    assert "repro_torch".split(".", 1)[0] not in harness.FORBIDDEN_MODULES
    assert "repro" in harness.FORBIDDEN_MODULES
