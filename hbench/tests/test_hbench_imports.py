"""No module under hbench/ imports JAX or the JAX package, and the reference
imports nothing of the package it judges. Top-level names are compared
whole: `hades252_tpu_torch` begins with `hades252_tpu`."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

HBENCH = Path(__file__).resolve().parents[1]
SOURCES = sorted(HBENCH.rglob("*.py"))


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HBENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "hades252_tpu"}


@pytest.mark.parametrize("path", sorted((HBENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_package(path):
    assert "hades252_tpu_torch" not in top_level_imports(path)


def test_whole_names():
    assert "hades252_tpu_torch".split(".")[0] != "hades252_tpu"


def test_harness_reads_no_old_benchmark():
    for path in SOURCES:
        text = path.read_text()
        for name in ("bench.py", "chip_smoke", "BENCH_r0"):
            assert name not in text or path.name.startswith("test_hbench_imports"), path
