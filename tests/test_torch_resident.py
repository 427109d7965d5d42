"""Build-side state kept on the query's device, against the JAX package.

A join's dictionary (``_BuildTable``) and a runtime filter's bitset
(``_KernelBloomProbe``) go to the query's device once, through
``registry.upload``, and every probe morsel or stripe reads them there.  On
the CPU (``engine="ref"``) they are CPU tensors and the same code runs.
These tests hold the rows to the reference's with many small morsels per
join (``exchange.batch_rows`` 64) over four shuffle lanes, count the
uploads against the probes, keep the numpy path for key columns that
float32 does not hold, and hold the bloom adapter to
``BloomFilter.might_contain``.  Float columns compare with np.allclose at
its defaults (grouped sums accumulate in float32); every other column
exactly.
"""
import numpy as np
import pytest

import repro.api as rdb
from benchmarks.ssb import load_ssb as ref_load_ssb
from repro.core.session import Warehouse as RefWarehouse

import repro_torch.api as tdb
from repro_torch.core.bloomfilter import BloomFilter
from repro_torch.core.runtime import exec as ex
from repro_torch.core.session import Warehouse
from repro_torch.kernels import registry
from repro_torch.workloads.ssb import KERNEL_QUERIES, SSB_QUERIES, load_ssb
from test_torch_sql import _assert_rows_equal, _run

SCALE = 4000
# three lineorder stripes (storage.DEFAULT_STRIPE_ROWS is 8,192), so each
# runtime filter is probed three times a scan
STRIPED = 3 * 8192
# the default SQL configuration with four lanes, the result cache off, and
# morsels of 64 rows, so each join is probed many times
SMALL_MORSELS = {"result_cache": False, "shuffle.partitions": 4,
                 "exchange.batch_rows": 64}
QUERIES = {**SSB_QUERIES, **KERNEL_QUERIES}


@pytest.fixture(scope="module")
def warehouses(tmp_path_factory):
    ref_dir = str(tmp_path_factory.mktemp("ref_wh"))
    port_dir = str(tmp_path_factory.mktemp("port_wh"))
    wh = RefWarehouse(ref_dir)
    ref_load_ssb(wh, scale_rows=SCALE)
    wh.close()
    wh = Warehouse(port_dir)
    load_ssb(wh, scale_rows=SCALE)
    wh.close()
    return ref_dir, port_dir


@pytest.fixture()
def built(monkeypatch):
    """Counts what the executor builds while a test runs: the numeric key
    columns whose dictionary the kernel takes, and the bloom adapters."""
    seen = {"dictionaries": 0, "filters": 0}
    init_table, init_probe = ex._BuildTable.__init__, \
        ex._KernelBloomProbe.__init__

    def table(self, *a, **kw):
        init_table(self, *a, **kw)
        seen["dictionaries"] += sum(d is not None for *_, d in self.keys)

    def probe(self, *a, **kw):
        init_probe(self, *a, **kw)
        seen["filters"] += 1

    monkeypatch.setattr(ex._BuildTable, "__init__", table)
    monkeypatch.setattr(ex._KernelBloomProbe, "__init__", probe)
    return seen


@pytest.fixture(scope="module")
def striped(tmp_path_factory):
    """A port warehouse whose lineorder spans three stripes."""
    port_dir = str(tmp_path_factory.mktemp("striped_wh"))
    wh = Warehouse(port_dir)
    load_ssb(wh, scale_rows=STRIPED)
    wh.close()
    return port_dir


def _moved(before, after, key):
    return after.get(key, 0) - before.get(key, 0)


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_small_morsels_match_reference(warehouses, name):
    ref_dir, port_dir = warehouses
    sql = QUERIES[name]
    with rdb.connect(ref_dir, engine="ref", **SMALL_MORSELS) as rc:
        exp = _run(rc, sql)
    with tdb.connect(port_dir, engine="ref", **SMALL_MORSELS) as tc:
        _assert_rows_equal(_run(tc, sql), exp, name)


@pytest.mark.parametrize("name", ["q2.1", "q3.1", "q4.1", "k.int_agg"])
def test_one_upload_per_dictionary_and_filter(striped, built, name):
    """Every numeric join key column's dictionary and every runtime
    filter's bitset is uploaded once, however many morsels probe it: the
    uploads equal what the executor built and stay the same when the
    morsels are 16 times larger, while the probes fall."""
    port_dir = striped
    probes, uploads = [], []
    for rows in (64, 1024):
        cfg = {**SMALL_MORSELS, "exchange.batch_rows": rows}
        d0, u0 = registry.dispatch_counts(), registry.upload_counts()
        seen0 = dict(built)
        with tdb.connect(port_dir, engine="ref", **cfg) as conn:
            _run(conn, QUERIES[name])
        d1, u1 = registry.dispatch_counts(), registry.upload_counts()
        up = {k: _moved(u0, u1, k) for k in ("key_lookup", "bloom_probe")}
        assert up["key_lookup"] == built["dictionaries"] - \
            seen0["dictionaries"]
        assert up["bloom_probe"] == built["filters"] - seen0["filters"]
        uploads.append(up)
        probes.append(_moved(d0, d1, "key_lookup[ref]"))
    assert uploads[0] == uploads[1]
    assert uploads[0]["key_lookup"] > 0
    assert probes[0] > probes[1] > 0


@pytest.mark.parametrize("name", ["q2.1", "q3.1", "q4.1"])
def test_bloom_filters_upload_once_per_filter(striped, built, name):
    """Each runtime filter's bitset goes up once, and the probe of every
    lineorder stripe that min/max skipping leaves reads it: up to three
    probes an upload."""
    d0, u0 = registry.dispatch_counts(), registry.upload_counts()
    with tdb.connect(striped, engine="ref", **SMALL_MORSELS) as conn:
        _run(conn, SSB_QUERIES[name])
    d1, u1 = registry.dispatch_counts(), registry.upload_counts()
    filters = _moved(u0, u1, "bloom_probe")
    assert filters == built["filters"] > 0
    assert filters < _moved(d0, d1, "bloom_probe[ref]") <= 3 * filters


# keys above 2**24 that float32 cannot hold, beside small ones it can
WIDE = 2**40


def _wide_keys(api, path):
    """dim's keys are all wide; dim_small's fit float32, and so do fact.m's
    but on every 500th row, so some probe morsels hold a wide value."""
    conn = api.connect(path, engine="auto")
    conn.execute("CREATE TABLE dim (k BIGINT, name STRING)")
    conn.execute("CREATE TABLE dim_small (k BIGINT, name STRING)")
    conn.execute("CREATE TABLE fact (k BIGINT, m BIGINT, v INT)")
    conn.execute("INSERT INTO dim VALUES " + ", ".join(
        f"({WIDE + i}, 'd{i % 7}')" for i in range(300)))
    conn.execute("INSERT INTO dim_small VALUES " + ", ".join(
        f"({i}, 's{i % 5}')" for i in range(300)))
    conn.execute("INSERT INTO fact VALUES " + ", ".join(
        f"({WIDE + (i * 37) % 400}, "
        f"{WIDE + i if i % 500 == 0 else i % 300}, {i})"
        for i in range(3000)))
    conn.close()
    return path


WIDE_SQL = {
    # the dictionary does not survive float32: the numpy path throughout
    "wide_dictionary": "SELECT d.name, SUM(f.v), COUNT(*) FROM fact f "
                       "JOIN dim d ON f.k = d.k GROUP BY d.name",
    # the dictionary survives; morsels holding a wide probe value take the
    # numpy path, the others the kernel
    "wide_probes": "SELECT d.name, SUM(f.v), COUNT(*) FROM fact f "
                   "JOIN dim_small d ON f.m = d.k GROUP BY d.name",
}


@pytest.mark.parametrize("case", sorted(WIDE_SQL))
def test_wide_keys_take_the_numpy_path(tmp_path, built, case):
    sql = WIDE_SQL[case]
    ref = _wide_keys(rdb, str(tmp_path / "ref"))
    port = _wide_keys(tdb, str(tmp_path / "port"))
    cfg = {"result_cache": False, "shuffle.partitions": 4,
           "exchange.batch_rows": 64}
    with rdb.connect(ref, engine="ref", **cfg) as rc:
        exp = _run(rc, sql)
    d0, u0 = registry.dispatch_counts(), registry.upload_counts()
    with tdb.connect(port, engine="ref", **cfg) as tc:
        got = _run(tc, sql)
    d1, u1 = registry.dispatch_counts(), registry.upload_counts()
    _assert_rows_equal(got, exp, case)
    assert len(got[1]) > 0
    assert _moved(u0, u1, "key_lookup") == built["dictionaries"]
    probes = _moved(d0, d1, "key_lookup[ref]")
    if case == "wide_dictionary":
        assert built["dictionaries"] == 0 and probes == 0
    else:
        assert built["dictionaries"] > 0 and probes > 0


@pytest.mark.parametrize("num_bits,k,members", [(64, 6, 5), (512, 6, 60),
                                                (32768, 6, 4000),
                                                (1 << 20, 6, 20_000)])
def test_bloom_adapter_matches_might_contain(num_bits, k, members):
    """One adapter, one upload, many probes of fresh values, each equal to
    the host filter's answer."""
    rng = np.random.default_rng(num_bits)
    bf = BloomFilter(num_bits, k)
    keys = rng.integers(0, 4 * members + 1000, members)
    bf.add(keys)
    ctx = ex.ExecContext(None, None, {"engine": "ref"})
    u0 = registry.upload_counts()
    probe = ex._KernelBloomProbe(bf, ctx)
    assert _moved(u0, registry.upload_counts(), "bloom_probe") == 1
    for rep in range(4):
        values = np.concatenate([keys[rep::4],
                                 rng.integers(0, 4 * members + 1000, 3000)])
        got = probe.might_contain(values)
        assert got.dtype == np.bool_
        assert np.array_equal(got, bf.might_contain(values)), rep
        assert got[:len(keys[rep::4])].all()
    assert _moved(u0, registry.upload_counts(), "bloom_probe") == 1


def test_upload_on_the_cpu_shares_the_array():
    """Under ``ref`` the state is a CPU tensor over the array, counted."""
    import torch

    a = np.arange(5, dtype=np.float32)
    u0 = registry.upload_counts()
    t = registry.upload(a, torch.device("cpu"), "key_lookup")
    assert t.device.type == "cpu" and np.array_equal(t.numpy(), a)
    assert _moved(u0, registry.upload_counts(), "key_lookup") == 1
