"""The port's SQL path (repro_torch.api) against the JAX package's.

Both packages load SSB from one seed; the port must read the same tables,
open a warehouse directory the JAX package wrote, and answer the 13 SSB
queries plus KERNEL_QUERIES with the reference's rows under the first
slice's configuration (no semijoin reduction, one shuffle lane) and under
the default SQL configuration (semijoin reduction on, four shuffle lanes),
with broadcast joins and with every join shuffled; the result cache is off.
Float columns compare with np.allclose at its defaults, because routed
grouped sums accumulate in float32; every other column must match exactly.
"""
import math
import shutil

import numpy as np
import pytest

import repro.api as rdb
from benchmarks.ssb import SSB_QUERIES as REF_SSB_QUERIES
from benchmarks.ssb import load_ssb as ref_load_ssb
from repro.core.acid import AcidTable as RefAcidTable
from repro.core.session import Warehouse as RefWarehouse
from repro.kernels.registry import dispatch_counts as ref_dispatch_counts

import repro_torch.api as tdb
from repro_torch.core.acid import AcidTable
from repro_torch.core.session import Warehouse
from repro_torch.kernels import registry
from repro_torch.workloads.ssb import KERNEL_QUERIES, SSB_QUERIES, load_ssb

SCALE = 4000
SLICE = {"semijoin_reduction": False, "result_cache": False,
         "shuffle.partitions": 1}
TABLES = ("date_dim", "customer", "supplier", "part", "lineorder")
PATH_KERNELS = ("filter_eval", "key_lookup", "hash_group",
                "hash_group_minmax")
SHUFFLE_KERNELS = ("hash_partition", "bloom_probe")
# the default SQL configuration with the lane count pinned ("auto" follows
# the host's core count); "shuffle_joins" also shuffles every join (1-3 keys)
DEFAULT = {"result_cache": False, "shuffle.partitions": 4}
CONFIGS = {"default": DEFAULT,
           "shuffle_joins": {**DEFAULT, "broadcast_threshold_rows": 0.0}}
QUERIES = {**SSB_QUERIES, **KERNEL_QUERIES}


@pytest.fixture(scope="module")
def warehouses(tmp_path_factory):
    """(reference-written dir, port-written dir), loaded from one seed."""
    ref_dir = str(tmp_path_factory.mktemp("ref_wh"))
    port_dir = str(tmp_path_factory.mktemp("port_wh"))
    wh = RefWarehouse(ref_dir)
    ref_load_ssb(wh, scale_rows=SCALE)
    wh.close()
    wh = Warehouse(port_dir)
    load_ssb(wh, scale_rows=SCALE)
    wh.close()
    return ref_dir, port_dir


def _read_table(wh, acid_cls, name):
    hms = wh.hms
    desc = hms.get_table(name)
    batch = acid_cls(desc, hms).read_all(
        hms.writeid_list(name, hms.get_snapshot()))
    return {c: batch.cols[c] for c, _ in desc.schema}


def _run(conn, sql):
    cur = conn.execute(sql)
    return [d[0] for d in cur.description], cur.fetchall()


def _assert_rows_equal(got, exp, what):
    gcols, grows = got
    ecols, erows = exp
    assert gcols == ecols, what
    assert len(grows) == len(erows), what
    key = lambda r: tuple((v is None, str(v) if isinstance(v, str) else  # noqa: E731
                           (round(v, 6) if isinstance(v, float) else v))
                          for v in r)
    for g, e in zip(sorted(grows, key=key), sorted(erows, key=key)):
        for gv, ev in zip(g, e):
            if isinstance(ev, float) or isinstance(gv, float):
                if ev is None or gv is None:
                    assert gv is None and ev is None, what
                elif math.isnan(ev):
                    assert math.isnan(gv), what
                else:
                    assert np.allclose(gv, ev), (what, gv, ev)
            else:
                assert gv == ev, (what, gv, ev)


def test_loaders_write_identical_tables(warehouses):
    ref_dir, port_dir = warehouses
    rwh, twh = RefWarehouse(ref_dir), Warehouse(port_dir)
    try:
        assert SSB_QUERIES == REF_SSB_QUERIES
        for name in TABLES:
            exp = _read_table(rwh, RefAcidTable, name)
            got = _read_table(twh, AcidTable, name)
            assert list(got) == list(exp), name
            for col in exp:
                assert got[col].dtype == exp[col].dtype, (name, col)
                assert np.array_equal(got[col], exp[col]), (name, col)
    finally:
        rwh.close()
        twh.close()


def test_port_opens_reference_warehouse(warehouses, tmp_path):
    ref_dir, _ = warehouses
    copy = str(tmp_path / "carried")
    shutil.copytree(ref_dir, copy)
    sqls = [f"SELECT * FROM {t}" for t in TABLES]
    sqls.append(SSB_QUERIES["q2.1"])
    with rdb.connect(ref_dir, engine="auto", **SLICE) as rc, \
            tdb.connect(copy, engine="auto", **SLICE) as tc:
        for sql in sqls:
            _assert_rows_equal(_run(tc, sql), _run(rc, sql), sql)


@pytest.fixture(scope="module")
def reference_rows(warehouses):
    ref_dir, _ = warehouses
    with rdb.connect(ref_dir, engine="ref", **SLICE) as conn:
        return {name: _run(conn, sql) for name, sql in QUERIES.items()}


@pytest.mark.parametrize("engine", ["ref", "auto"])
def test_slice_queries_match_reference(warehouses, reference_rows, engine):
    _, port_dir = warehouses
    before = registry.dispatch_counts()
    with tdb.connect(port_dir, engine=engine, **SLICE) as conn:
        for name, sql in QUERIES.items():
            _assert_rows_equal(_run(conn, sql), reference_rows[name], name)
    after = registry.dispatch_counts()
    for k in PATH_KERNELS:
        moved = after.get(f"{k}[ref]", 0) - before.get(f"{k}[ref]", 0)
        if engine == "ref":
            assert moved > 0, k
        else:
            assert moved == 0, k  # auto takes the numpy host paths
    for k in SHUFFLE_KERNELS:  # off this configuration's path
        assert after.get(f"{k}[ref]", 0) == before.get(f"{k}[ref]", 0), k
    assert registry.launch_counts() == {} or registry.on_gpu()


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("engine", ["ref", "auto"])
def test_default_config_queries_match_reference(warehouses, reference_rows,
                                                config, engine):
    """Semijoin reducers probe runtime bloom filters on every lineorder
    stripe and shuffles assign lanes; under ``ref`` all six path kernels
    dispatch, under ``auto`` none does, and the rows are the reference's."""
    _, port_dir = warehouses
    before = registry.dispatch_counts()
    with tdb.connect(port_dir, engine=engine, **CONFIGS[config]) as conn:
        for name, sql in QUERIES.items():
            _assert_rows_equal(_run(conn, sql), reference_rows[name], name)
    after = registry.dispatch_counts()
    for k in PATH_KERNELS + SHUFFLE_KERNELS:
        moved = after.get(f"{k}[ref]", 0) - before.get(f"{k}[ref]", 0)
        if engine == "ref":
            assert moved > 0, k
        else:
            assert moved == 0, k


def test_bloom_probes_are_traced(warehouses):
    """Each stripe probe of a runtime filter is one traced dispatch."""
    _, port_dir = warehouses
    with tdb.connect(port_dir, engine="ref", **DEFAULT,
                     **{"obs.tracing": True}) as conn:
        h = conn.execute_async(SSB_QUERIES["q2.1"])
        h.result(timeout=120).fetchall()
        dispatched = h._task.trace.summary()["kernel_dispatches"]
    assert dispatched.get("bloom_probe[ref]", 0) > 0
    assert dispatched.get("key_lookup[ref]", 0) > 0


def test_reference_and_port_route_the_same_kernels(warehouses):
    """The slice's kernel set is the reference's: under ``ref`` both
    dispatch all four path kernels and neither partition nor bloom."""
    ref_dir, port_dir = warehouses
    rb, tb = ref_dispatch_counts(), registry.dispatch_counts()
    with rdb.connect(ref_dir, engine="ref", **SLICE) as rc, \
            tdb.connect(port_dir, engine="ref", **SLICE) as tc:
        for name in ("q2.1", "k.int_agg", "scan_agg"):
            _run(rc, QUERIES[name])
            _run(tc, QUERIES[name])
    ra, ta = ref_dispatch_counts(), registry.dispatch_counts()
    for k in PATH_KERNELS:
        key = f"{k}[ref]"
        assert ra.get(key, 0) - rb.get(key, 0) == ta.get(key, 0) - tb.get(key, 0), k
    for k in ("hash_partition[ref]", "bloom_probe[ref]"):
        assert ra.get(k, 0) == rb.get(k, 0)


def test_metrics_report_dispatches(warehouses):
    _, port_dir = warehouses
    with tdb.connect(port_dir, engine="ref", **SLICE) as conn:
        _run(conn, KERNEL_QUERIES["k.int_agg"])
        counters = conn.metrics()["counters"]
    for k in PATH_KERNELS:
        assert counters[f"kernels.dispatch.{k}[ref]"] > 0, k


def _tiny(api, path):
    conn = api.connect(path, engine="auto")
    conn.execute("CREATE TABLE t (x INT)")
    conn.execute("INSERT INTO t VALUES (1), (2), (3), (50)")
    conn.close()
    return path


@pytest.fixture()
def tiny(tmp_path):
    return _tiny(tdb, str(tmp_path / "wh"))


def test_empty_global_sum_is_null_under_ref(tiny, tmp_path):
    """ROADMAP C3: the empty global aggregate reaches the grouped-sum
    kernel with n = 0; the port answers NULL (NaN, the executor's float
    NULL), as the reference does under its ref engine."""
    ref = _tiny(rdb, str(tmp_path / "ref_wh"))
    for sql in ("SELECT SUM(x) FROM t WHERE x > 100",
                "SELECT SUM(x), MIN(x), COUNT(x) FROM t WHERE x > 100",
                "SELECT SUM(x), MIN(x) FROM t WHERE x > 1"):
        with tdb.connect(tiny, engine="ref", result_cache=False) as tc, \
                rdb.connect(ref, engine="ref", result_cache=False) as rc:
            _assert_rows_equal(_run(tc, sql), _run(rc, sql), sql)
    with tdb.connect(tiny, engine="ref", result_cache=False) as conn:
        (total,), = conn.execute(
            "SELECT SUM(x) FROM t WHERE x > 100").fetchall()
        assert math.isnan(total)


def test_default_engine_is_cuda_and_never_falls_back(tiny):
    """Under the default engine a kernel-shaped query runs on the GPU; with
    no GPU it raises a clear error instead of running on the CPU."""
    with tdb.connect(tiny, result_cache=False) as conn:
        assert conn.session.config["engine"] == "cuda"
        sql = "SELECT SUM(x), COUNT(x) FROM t WHERE x > 1"
        if registry.on_gpu():
            assert conn.execute(sql).fetchall() == [(55, 3)]
            return
        with pytest.raises(tdb.DatabaseError, match="needs an NVIDIA GPU"):
            conn.execute(sql).fetchall()


# ROADMAP C6, closed by the port's device rule: the reference's default
# engine is "auto" (numpy on the host); the port's is "cuda", because its
# entry points run on the card unless the caller asks for the CPU.  With no
# card a default connection raises and names the CPU engines; asked for,
# they answer as the reference's default connection does.
C6_SQL = "SELECT g, SUM(x) FROM t WHERE x > 1 GROUP BY g"


def _c6_warehouse(api, path):
    conn = api.connect(path, engine="auto")
    conn.execute("CREATE TABLE t (x INT, g INT)")
    conn.execute("INSERT INTO t VALUES (1, 1), (2, 1), (3, 2), (50, 2)")
    conn.close()
    return path


def test_default_engine_is_cuda_and_names_the_cpu_engines(tmp_path):
    if registry.on_gpu():
        pytest.skip("the default engine runs on the card here")
    from repro_torch.core.config_keys import CONFIG_KEYS
    from repro_torch.core.runtime.exec import ExecContext

    assert CONFIG_KEYS["engine"].default == "cuda"
    assert ExecContext(None, None).engine == "cuda"
    ref = _c6_warehouse(rdb, str(tmp_path / "ref_wh"))
    port = _c6_warehouse(tdb, str(tmp_path / "port_wh"))
    with rdb.connect(ref, result_cache=False) as rc:
        exp = _run(rc, C6_SQL)
    assert sorted(exp[1]) == [(1, 2), (2, 53)]
    with tdb.connect(port, result_cache=False) as conn:
        assert conn.session.config["engine"] == "cuda"
        with pytest.raises(tdb.DatabaseError, match="engine='ref'"):
            conn.execute(C6_SQL).fetchall()
    for engine in ("auto", "ref"):
        with tdb.connect(port, engine=engine, result_cache=False) as conn:
            _assert_rows_equal(_run(conn, C6_SQL), exp, engine)
