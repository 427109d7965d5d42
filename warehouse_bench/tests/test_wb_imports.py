"""What the benchmark may import: no module under ``warehouse_bench/``
imports JAX or the JAX package (``repro``; top-level names compared whole,
so ``repro_torch`` is not ``repro``), none reads the JAX package's
``benchmarks/`` folder, and the plain reference imports nothing of the
program."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
MODULES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(BENCH)) for p in MODULES])
def test_no_jax_and_no_benchmarks_folder(path):
    assert not top_level_imports(path) & FORBIDDEN
    if path.parent.name != "tests":
        assert "benchmarks" not in path.read_text().replace(
            "warehouse_bench", "")


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)
    assert "repro_torch" not in path.read_text()


def test_the_scan_sees_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom repro.core import x\n"
                   "import repro_torch\nimportlib.import_module('flax')\n")
    assert top_level_imports(bad) & FORBIDDEN == {"jax", "repro", "flax"}
