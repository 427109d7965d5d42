"""The port's examples (``repro_torch.examples``) against the JAX package's
(``examples/quickstart.py``, ``examples/federated_warehouse.py``).

Each reference example runs in this process with its stdout captured (its
engine is the reference's default, ``auto``), then the port's copy under
``auto`` and under ``ref``. The printed result rows must be equal; lines
that carry timings, query ids, trace paths or the host's scheduling (the
streamed batches, whether a cancel landed) are left out.
"""
import ast
import contextlib
import importlib.util
import io
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the lines that print query results, both examples
RESULT = re.compile(
    r"^(   \(|  qty>=\d+: first page|updated rows:|deleted rows:|row count:|"
    r"h2 result:|partitioned result:|rewritten against MV:|"
    r"validated plan executed:|literal filters push down:|"
    r"pushed vs residual:|pushed:|JDBC pushdown SQL:|druid JSON:|"
    r"wrote rollup into Druid:|schema inferred from Druid:|"
    r"mounted catalogs:|partitions on disk:)")


def _reference(name: str):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(main, *args, **kwargs) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(*args, **kwargs)
    return out.getvalue()


def _results(text: str) -> list:
    """The result lines, with an unordered result list sorted (its rows
    arrive in lane order)."""
    lines = []
    for line in text.splitlines():
        if not RESULT.match(line):
            continue
        if line.startswith("partitioned result:"):
            head, rows = line.split(":", 1)
            line = f"{head}: {sorted(ast.literal_eval(rows.strip()))}"
        lines.append(line)
    return lines


@pytest.fixture(scope="module")
def reference_output():
    return {name: _results(_printed(_reference(name).main))
            for name in ("quickstart", "federated_warehouse")}


@pytest.mark.parametrize("engine", ["auto", "ref"])
@pytest.mark.parametrize("name", ["quickstart", "federated_warehouse"])
def test_example_prints_the_references_rows(reference_output, tmp_path,
                                            name, engine):
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    got = _results(_printed(mod.main, engine,
                            warehouse_dir=str(tmp_path / "wh")))
    exp = reference_output[name]
    assert len(exp) > 5
    assert got == exp


def test_examples_default_to_the_card(tmp_path):
    """No fallback: the examples' default engine is ``cuda``; without a
    card the first kernel-shaped query raises, naming the CPU engines."""
    from repro_torch.examples import quickstart
    from repro_torch.kernels import registry

    if registry.on_gpu():
        pytest.skip("a card is present: the examples run under cuda")
    with pytest.raises(Exception, match="engine='ref'.*engine='auto'"):
        _printed(quickstart.main, warehouse_dir=str(tmp_path / "wh"))
