"""The import guard: JAX and the JAX package stay out of the benchmark,
and the reference stays out of the program."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from conftest import ROOT
from portbench.harness.cells import FORBIDDEN_MODULES, forbidden_loaded

SOURCES = sorted(p for p in (ROOT / "portbench").rglob("*.py")
                 if "_dev" not in p.parts and "_cache" not in p.parts)


def _imported_tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_guard_compares_whole_top_level_names():
    assert forbidden_loaded(["ucnerf_torch", "ucnerf_torch.models",
                             "jaxtyping", "flaxen", "optax_like"]) == []
    assert forbidden_loaded(["jax.numpy", "ucnerf_tpu.ops", "optax"]) == [
        "jax", "optax", "ucnerf_tpu"]
    assert set(FORBIDDEN_MODULES) == {"jax", "jaxlib", "flax", "optax",
                                      "ucnerf_tpu"}


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not set(_imported_tops(path)) & set(FORBIDDEN_MODULES)
    if "tests" not in path.parts:     # reads none of the JAX-era benches
        text = path.read_text()
        for name in ("bench_baseline", "BENCH_r", "scripts/bench"):
            assert name not in text


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").rglob("*.py"):
        assert "ucnerf_torch" not in set(_imported_tops(path)), path


def test_harness_import_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import portbench.run, "
            "portbench.calibrate, portbench.harness.drivers; "
            "from portbench.harness.cells import forbidden_loaded; "
            "import ucnerf_torch.train.loop, ucnerf_torch.render.serving; "
            "print(forbidden_loaded())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.strip() == "[]"
