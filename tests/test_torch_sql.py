"""The port's SQL path (repro_torch.api) against the JAX package's.

Both packages load SSB from one seed; the port must read the same tables,
open a warehouse directory the JAX package wrote, and answer the 13 SSB
queries plus KERNEL_QUERIES with the reference's rows under the slice
configuration (no semijoin reduction, one shuffle lane, no result cache).
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
    assert not any(k.startswith(("hash_partition", "bloom_probe"))
                   for k in after)
    assert registry.launch_counts() == {} or registry.on_gpu()


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


@pytest.mark.parametrize("option,item", [({"semijoin_reduction": True,
                                           "shuffle.partitions": 1}, "B6"),
                                          ({"semijoin_reduction": False,
                                            "shuffle.partitions": 4,
                                            "broadcast_threshold_rows": 0.0},
                                           "B5")])
def test_unported_kernels_raise_under_ref(warehouses, option, item):
    """Bloom probes and partitioned shuffles are off the slice: under a
    kernel engine they raise naming their ROADMAP item."""
    _, port_dir = warehouses
    with tdb.connect(port_dir, engine="ref", result_cache=False,
                     **option) as conn:
        with pytest.raises(tdb.DatabaseError, match=item):
            conn.execute(SSB_QUERIES["q2.1"]).fetchall()
