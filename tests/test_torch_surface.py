"""The four-axes scenario (``repro_torch/workloads/surface.py``) in both
packages: the JAX package's client API against the port's, step by step.

Each package loads SSB at 60,000 lineorder rows from seed 42 (the
reference's ``benchmarks/ssb.py`` and the port's copy) into a warehouse of
its own, one pair of warehouses per engine, and runs the scenario's steps
in order (runtime, federation, materialized view, writes) under that
engine. After each step both packages must return the same rows and the
same ``cursor.info`` fields (``cache_hit`` and the resource plan's pools,
``federated_pushdown``, ``mv_used`` / ``mv_mode``, the DML row counts,
``rebuild_mode`` and the delta directories around compaction):

* ``auto`` against ``auto`` (both take their numpy host paths): equal rows;
* ``ref`` against ``ref`` (the kernels' plain versions: jnp in the JAX
  package, torch in the port): floats within ``np.allclose``'s defaults,
  the float32 bound of ``tests/test_torch_sql.py``; every other value
  equal.

Within each package every step also holds itself to its own invariants
(client rows against serial ones, federated against local, view against
base tables, the snapshot handle and compaction); under ``ref`` the port's
kernel dispatches rise in every step. The same scenario on the card under
``cuda`` against ``auto`` is ``tests/test_torch_cuda.py::
test_cuda_surface_small`` and chip_smoke's ``surface_phase``.
"""
import importlib.util
import math
import os

import numpy as np
import pytest

import repro.api as rdb
from benchmarks.ssb import load_ssb as ref_load_ssb
from repro.core.session import Warehouse as RefWarehouse

import repro_torch.api as tdb
from repro_torch.core.session import Warehouse
from repro_torch.kernels import registry
from repro_torch.workloads import surface
from repro_torch.workloads.ssb import load_ssb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 60_000
SEED = 42
CFG = {"result_cache": False, "shuffle.partitions": 4}
# the runtime step's clients: 16 as the scenario has them under auto; 4
# under ref, where the JAX package's plain kernels (jnp, dispatched op by
# op) make a query about ten times slower than the numpy paths
CLIENTS = {"auto": 16, "ref": 4}
STEPS = [name for name, _ in surface.STEPS]
SQL_KERNELS = ("filter_eval", "key_lookup", "hash_group",
               "hash_group_minmax", "hash_partition", "bloom_probe")
# kernels a step must reach under a kernel engine (the grouped count over
# the federated dimension; the view's COUNT)
STEP_KERNELS = {"federation": ("key_lookup", "hash_group"),
                "mv": ("hash_group",)}


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    """``get(engine, step)``: both packages' results of ``step`` under
    ``engine``, running the steps before it first, once per module."""
    runs = {}

    def get(engine: str, step: str):
        if engine not in runs:
            ref = RefWarehouse(str(tmp_path_factory.mktemp(f"jax_{engine}")))
            ref_load_ssb(ref, scale_rows=ROWS, seed=SEED)
            port = Warehouse(str(tmp_path_factory.mktemp(f"torch_{engine}")))
            load_ssb(port, scale_rows=ROWS, seed=SEED)
            runs[engine] = {"wh": (ref, port), "done": {}}
        run = runs[engine]
        for name, fn in surface.STEPS:
            if name in run["done"]:
                if name == step:
                    break
                continue
            ref, port = run["wh"]
            opts = {"clients": CLIENTS[engine]} if name == "runtime" else {}
            got_ref = fn(rdb, ref, engine, CFG, **opts)
            before = registry.dispatch_counts()
            got_port = fn(tdb, port, engine, CFG, **opts)
            after = registry.dispatch_counts()
            run["done"][name] = (got_ref, got_port, {
                k: after.get(f"{k}[ref]", 0) - before.get(f"{k}[ref]", 0)
                for k in SQL_KERNELS})
            if name == step:
                break
        return run["done"][step]

    yield get
    for run in runs.values():
        for wh in run["wh"]:
            wh.close()


def _close(a, b) -> bool:
    """``ref``'s bound: floats within np.allclose's defaults (NaN equal to
    NaN), every other value equal."""
    if isinstance(a, float) or isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or bool(np.isclose(a, b))
    return a == b


def _rows_match(got, exp, exact: bool) -> bool:
    if exact:
        return got == exp
    return len(got) == len(exp) and all(
        len(g) == len(e) and all(_close(gv, ev) for gv, ev in zip(g, e))
        for g, e in zip(got, exp))


@pytest.mark.parametrize("engine", ["auto", "ref"])
@pytest.mark.parametrize("step", STEPS)
def test_surface_step_matches_jax(scenario, engine, step):
    ref, port, dispatched = scenario(engine, step)
    assert sorted(port["rows"]) == sorted(ref["rows"])
    for label, exp in ref["rows"].items():
        assert _rows_match(port["rows"][label], exp, engine == "auto"), (
            step, label, port["rows"][label][:4], exp[:4])
    assert port["info"] == ref["info"]
    if engine == "ref":
        assert sum(dispatched.values()) > 0, (step, dispatched)
        for k in STEP_KERNELS.get(step, ()):
            assert dispatched[k] > 0, (step, k, dispatched)


def test_surface_step_facts(scenario):
    """What the steps found, the same in both packages (checked above):
    the view is taken for flight 1, skipped while stale and taken again
    after a full rebuild; a result-cache hit on the repeat; compaction
    leaves one base and no delta."""
    runtime = scenario("auto", "runtime")[1]
    assert runtime["info"]["cache_hit"] == [False, True]
    assert runtime["measured"]["queries"] == 16 * 6
    mv = scenario("auto", "mv")[1]["info"]
    assert {mv[q]["mv_used"] for q in surface.FLIGHT1} == {surface.MV_NAME}
    writes = scenario("auto", "writes")[1]["info"]
    assert writes["stale_mv_used"] is None
    assert writes["rebuild_mode"] == "full"
    assert writes["rowcount"]["insert"] == 4000
    assert writes["delta_dirs"][0] > 0 and writes["delta_dirs"][1] == 0
    fed = scenario("auto", "federation")[1]["info"]
    assert set(fed["q3.1"]["federated_pushdown"]) == {
        "ext.default.customer", "ext.default.supplier"}


def test_surface_under_cuda_raises_without_card(tmp_path):
    """No fallback: without a card the scenario under ``cuda`` raises at
    its first kernel-shaped query, naming the CPU engines."""
    if registry.on_gpu():
        pytest.skip("a card is present: the scenario runs under cuda")
    wh = Warehouse(str(tmp_path / "wh"))
    try:
        load_ssb(wh, scale_rows=2000, seed=SEED)
        with pytest.raises(Exception, match="engine='ref'.*engine='auto'"):
            surface.runtime_step(tdb, wh, "cuda", CFG, clients=2,
                                 per_client=1)
    finally:
        wh.close()


def test_surface_phase_raises_without_card(tmp_path):
    """chip_smoke.py's surface_phase without a card: its first statement
    under cuda raises, naming the CPU engines; nothing falls back."""
    if registry.on_gpu():
        pytest.skip("a card is present: chip_smoke runs the phase")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    wh = Warehouse(str(tmp_path / "wh"))
    try:
        load_ssb(wh, scale_rows=2000, seed=SEED)
        with pytest.raises(Exception, match="engine='ref'.*engine='auto'"):
            chip_smoke.surface_phase(tdb, wh, dict(chip_smoke.CONFIG),
                                     str(tmp_path / "work"))
    finally:
        wh.close()
