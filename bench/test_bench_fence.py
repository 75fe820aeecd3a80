"""The benchmark imports neither JAX nor the JAX package, and its plain
reference imports nothing of the program either.  Top-level module names
are compared whole: ``repro_torch`` (the port) is not ``repro`` (the JAX
package)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
BANNED = {"jax", "jaxlib", "flax", "repro"}
# the reference may use the standard library, torch, numpy and itself
REFERENCE_BANNED = BANNED | {"repro_torch", "benchlib"}


def _imports(path: Path):
    """Top-level names of every import in ``path`` (relative imports as '.')."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            yield "." if node.level else (node.module or "").split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_bench_module_imports_no_jax(path):
    found = set(_imports(path)) & BANNED
    assert not found, f"{path} imports {sorted(found)}"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_program(path):
    found = set(_imports(path)) & REFERENCE_BANNED
    assert not found, f"{path} imports {sorted(found)}"


def test_fence_sees_a_banned_import(tmp_path):
    """The walk catches each form, and tells the port from the JAX package."""
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom repro.core import api\n"
                   "import repro_torch\nimportlib.import_module('flax.linen')\n")
    assert set(_imports(src)) & BANNED == {"jax", "repro", "flax"}


def test_bench_reads_nothing_of_the_jax_benchmarks():
    """No file under bench/ names the JAX package's benchmark folder as a module."""
    for path in SOURCES:
        assert "benchmarks" not in set(_imports(path)), path
