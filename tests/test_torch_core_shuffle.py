"""Partitioned shuffle service.

Covers: hash_partition kernel parity (pallas/ref/host), the partition-parity
suite (identical results for ``shuffle.partitions`` 1 vs N across SSB
Q1-Q4, ACID merge-on-read reads, federated multi-split scans, and
DISTINCT/grouping-set aggregates), per-partition build/probe and
aggregation state observed through ``poll()`` per-lane telemetry,
skewed-key spill-and-replay identity, barrier-mode lane filtering,
EXPLAIN exchange-boundary rendering, connector statistics feeding the CBO,
and Druid sorted-scan limit pushdown.
"""
import tempfile

import numpy as np
import pytest

import torch

import repro_torch.api as db
from repro_torch.core.runtime.vector import VectorBatch
from repro_torch.kernels.registry import engine_device, on_gpu

PART4 = {"shuffle.partitions": 4, "result_cache": False}
PART1 = {"shuffle.partitions": 1, "result_cache": False}
SHUFFLY = {"broadcast_threshold_rows": 0.0}  # force shuffle joins


def _engine_device(engine):
    """The device of the port's kernel engine ``ref`` (the CPU) or ``cuda``
    (the JAX package's ``pallas``; skips without an H100)."""
    if engine == "cuda" and not on_gpu():
        pytest.skip("engine 'cuda' needs an NVIDIA GPU of compute "
                    "capability >= 9.0")
    return engine_device(engine)


def rounded(rows):
    def norm(x):
        if isinstance(x, float):
            return "NULL" if np.isnan(x) else round(x, 6)
        return x

    # stringify so NULL-filled grouping-set rows sort against typed rows
    return sorted(tuple(str(norm(x)) for x in r) for r in rows)


def assert_parity(wh, sql, extra=None, params=None):
    extra = extra or {}
    # the reference's default engine unless ``extra`` names one
    one = db.connect(warehouse=wh, **{"engine": "auto", **PART1, **extra})
    four = db.connect(warehouse=wh, **{"engine": "auto", **PART4, **extra})
    try:
        a = one.execute(sql, params).fetchall()
        b = four.execute(sql, params).fetchall()
        assert rounded(a) == rounded(b), sql
        return a
    finally:
        one.close()
        four.close()


# ---------------------------------------------------------------------------
# kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("engine", ["ref", "cuda"])
def test_hash_partition_kernel_parity(engine):
    """cuda / ref / numpy-host paths assign identical buckets."""
    from repro_torch.core.runtime.shuffle import partition_codes
    from repro_torch.kernels.hash_partition.ops import hash_partition

    device = _engine_device(engine)
    rng = np.random.default_rng(3)
    a = rng.integers(-5000, 5000, 8192).astype(np.int64)
    b = rng.uniform(-10, 10, 8192)
    batch = VectorBatch({"a": a, "b": b})
    cols = (torch.from_numpy(a.astype(np.float32)),
            torch.from_numpy(b.astype(np.float32)))
    for n in (2, 3, 4, 7, 8):
        kernel = hash_partition(tuple(c.to(device) for c in cols), n,
                                engine=engine).cpu().numpy()
        ref = hash_partition(cols, n, engine="ref").numpy()
        host = partition_codes(batch, ["a", "b"], n, engine="auto")
        kern = partition_codes(batch, ["a", "b"], n, engine=engine)
        assert np.array_equal(kernel, ref)
        assert np.array_equal(host, kernel.astype(np.int64))
        assert np.array_equal(kern, host)
        # reasonable balance: no empty bucket on 8k uniform keys
        assert np.bincount(host, minlength=n).min() > 0


def test_hash_partition_equal_values_same_lane_across_dtypes():
    """int and float sides of a join key agree on the lane (and -0.0 == 0.0)."""
    from repro_torch.core.runtime.shuffle import partition_codes

    ints = VectorBatch({"k": np.arange(-50, 50, dtype=np.int64)})
    floats = VectorBatch({"k": np.arange(-50, 50, dtype=np.float64)})
    ci = partition_codes(ints, ["k"], 5)
    cf = partition_codes(floats, ["k"], 5)
    assert np.array_equal(ci, cf)
    zeros = VectorBatch({"k": np.array([0.0, -0.0])})
    cz = partition_codes(zeros, ["k"], 7)
    assert cz[0] == cz[1]


def test_partition_codes_strings_stable():
    from repro_torch.core.runtime.shuffle import partition_codes

    b = VectorBatch({"s": np.array(["x", "y", "x", "zz", "y"])})
    c1 = partition_codes(b, ["s"], 4)
    c2 = partition_codes(b, ["s"], 4)
    assert np.array_equal(c1, c2)
    assert c1[0] == c1[2] and c1[1] == c1[4]


# ---------------------------------------------------------------------------
# partition parity: SSB Q1-Q4
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ssb_wh():
    from repro_torch.workloads.ssb import load_ssb
    from repro_torch.core.session import Warehouse

    wh = Warehouse(tempfile.mkdtemp(prefix="shuffle_ssb_"))
    load_ssb(wh, scale_rows=12_000)
    yield wh
    wh.close()


@pytest.mark.parametrize("name", ["q1.1", "q2.1", "q3.1", "q4.1"])
def test_ssb_partition_parity(ssb_wh, name):
    from repro_torch.workloads.ssb import SSB_QUERIES

    assert_parity(ssb_wh, SSB_QUERIES[name], extra=SHUFFLY)


@pytest.mark.parametrize("engine", ["ref", "cuda"])
def test_ssb_parity_under_forced_engines(ssb_wh, engine):
    """The kernel-dispatched bucket path (engine: ref, or cuda on a card)
    and the numpy host path produce identical lanes, hence identical
    results."""
    from repro_torch.workloads.ssb import SSB_QUERIES

    _engine_device(engine)
    base = assert_parity(ssb_wh, SSB_QUERIES["q2.1"], extra=SHUFFLY)
    eng = assert_parity(ssb_wh, SSB_QUERIES["q2.1"],
                        extra={**SHUFFLY, "engine": engine})
    assert rounded(base) == rounded(eng)


# ---------------------------------------------------------------------------
# partition parity: ACID merge-on-read, federated splits, DISTINCT
# ---------------------------------------------------------------------------
@pytest.fixture()
def conn(tmp_path):
    c = db.connect(str(tmp_path / "wh"), engine="auto")
    cur = c.cursor()
    cur.execute("CREATE TABLE fact (fk INT, grp INT, v DOUBLE, s STRING)")
    cur.execute("CREATE TABLE dim (dk INT, cat STRING, weight DOUBLE)")
    rng = np.random.default_rng(11)
    fk = rng.integers(0, 60, 4000)
    grp = rng.integers(0, 17, 4000)
    v = rng.uniform(-40, 40, 4000)
    rows = ", ".join(
        f"({int(a)}, {int(g)}, {float(x):.4f}, 's{int(a) % 7}')"
        for a, g, x in zip(fk, grp, v))
    cur.execute(f"INSERT INTO fact VALUES {rows}")
    cur.execute("INSERT INTO dim VALUES " + ", ".join(
        f"({i}, 'c{i % 5}', {i * 0.5})" for i in range(55)))
    yield c
    c.close()


def test_acid_merge_on_read_partition_parity(conn):
    """Partitioned reads over a table with live delete/update deltas
    (merge-on-read) match the single-lane result."""
    cur = conn.cursor()
    cur.execute("DELETE FROM fact WHERE fk < 5")
    cur.execute("UPDATE fact SET v = v * 2 WHERE grp = 3")
    for sql in [
        "SELECT grp, COUNT(*) AS n, SUM(v) AS sv FROM fact"
        " GROUP BY grp ORDER BY grp",
        "SELECT cat, SUM(v) AS sv, MAX(v) AS mx FROM fact JOIN dim"
        " ON fk = dk GROUP BY cat ORDER BY cat",
    ]:
        assert_parity(conn.warehouse, sql, extra=SHUFFLY)


def test_federated_multisplit_partition_parity(conn):
    cur = conn.cursor()
    cur.execute("CREATE CATALOG mem USING memtable")
    mem = conn.warehouse.catalogs.get("mem").handler
    rng = np.random.default_rng(2)
    mem.load("clicks", VectorBatch({
        "item": rng.integers(0, 60, 6000),
        "n": rng.integers(1, 5, 6000),
    }))
    for sql in [
        "SELECT item, SUM(n) AS c FROM mem.default.clicks"
        " GROUP BY item ORDER BY c DESC, item",
        "SELECT cat, SUM(n) AS c FROM mem.default.clicks"
        " JOIN dim ON item = dk GROUP BY cat ORDER BY cat",
    ]:
        assert_parity(conn.warehouse, sql, extra=SHUFFLY)


def test_distinct_and_grouping_sets_partition_parity(conn):
    for sql in [
        "SELECT s, COUNT(DISTINCT grp) AS d FROM fact GROUP BY s ORDER BY s",
        "SELECT grp, COUNT(DISTINCT fk) AS d, SUM(v) AS sv FROM fact"
        " GROUP BY grp ORDER BY grp",
        "SELECT COUNT(DISTINCT fk) FROM fact",
        "SELECT DISTINCT s FROM fact ORDER BY s",
        "SELECT grp, s, SUM(v) AS sv FROM fact"
        " GROUP BY GROUPING SETS ((grp, s), (grp), ())"
        " ORDER BY grp, s, sv",
    ]:
        assert_parity(conn.warehouse, sql)


def test_global_distinct_uses_merging_fold(conn):
    """Global COUNT(DISTINCT x) partitions on x: per-lane partial counts
    fold through a merging Aggregate vertex."""
    s = conn.warehouse.session(**PART4, engine="auto")
    text = s.explain("SELECT COUNT(DISTINCT fk) FROM fact")
    assert "SHUFFLE partitions=4" in text
    # EXPLAIN ANALYZE captures the expanded plan: lane reads are visible
    r = db.connect(warehouse=conn.warehouse, **PART4, engine="auto").execute(
        "EXPLAIN ANALYZE SELECT COUNT(DISTINCT fk) FROM fact")
    analyzed = "\n".join(x[0] for x in r.fetchall())
    assert "ShuffleRead" in analyzed
    base = conn.execute("SELECT COUNT(DISTINCT fk) FROM fact").fetchone()
    four = db.connect(warehouse=conn.warehouse, **PART4, engine="auto")
    assert four.execute("SELECT COUNT(DISTINCT fk) FROM fact").fetchone() \
        == base
    four.close()


def test_sum_avg_distinct_deduplicate(conn):
    """SUM/AVG(DISTINCT x) really deduplicate (the pre-streaming fallback
    silently computed the plain SUM), at 1 and N partitions."""
    cur = conn.cursor()
    cur.execute("CREATE TABLE dd (g INT, x INT)")
    cur.execute("INSERT INTO dd VALUES (1, 10), (1, 10), (1, 20),"
                " (2, 5), (2, 5), (2, 5)")
    sql = ("SELECT g, SUM(DISTINCT x), AVG(DISTINCT x), COUNT(DISTINCT x)"
           " FROM dd GROUP BY g ORDER BY g")
    for parts in (1, 4):
        c = db.connect(warehouse=conn.warehouse, result_cache=False,
                       **{"shuffle.partitions": parts}, engine="auto")
        assert c.execute(sql).fetchall() == [
            (1, 30, 15.0, 2), (2, 5, 5.0, 1)], parts
        assert c.execute("SELECT SUM(DISTINCT x) FROM dd").fetchone()[0] \
            == 35
        c.close()


def test_streaming_distinct_empty_and_null_inputs(conn):
    """The incremental distinct state handles empty inputs (0, not a crash)
    and skips NULL values like the materialized path did."""
    four = db.connect(warehouse=conn.warehouse, **PART4, engine="auto")
    assert four.execute(
        "SELECT COUNT(DISTINCT fk) FROM fact WHERE v > 9999").fetchone()[0] == 0
    assert four.execute(
        "SELECT s, COUNT(DISTINCT grp) FROM fact WHERE v > 9999"
        " GROUP BY s").fetchall() == []
    four.close()


# ---------------------------------------------------------------------------
# per-partition state, skew, spill
# ---------------------------------------------------------------------------
def test_poll_reports_per_lane_state(conn):
    """Build/probe and aggregation state is per-partition: every partitioned
    edge reports 4 lanes whose row counts sum to the edge total."""
    four = db.connect(warehouse=conn.warehouse, **PART4, **SHUFFLY, engine="auto")
    h = four.execute_async(
        "SELECT cat, SUM(v) AS sv FROM fact JOIN dim ON fk = dk"
        " GROUP BY cat ORDER BY cat")
    h.result(60)
    lanes = h.poll()["lanes"]
    # join build + probe edges and the aggregation input edge all partitioned
    assert len(lanes) >= 3
    for vid, per_lane in lanes.items():
        assert len(per_lane) == 4
        assert sum(l["rows"] for l in per_lane) > 0
    four.close()


def test_skewed_keys_spill_and_replay_identity(conn):
    """A heavily skewed key under a tiny per-lane budget spills on the hot
    lane and still returns results identical to the unconstrained run —
    and the skew is visible in the per-lane telemetry."""
    cur = conn.cursor()
    cur.execute("CREATE TABLE skew (k INT, v DOUBLE)")
    rng = np.random.default_rng(5)
    keys = np.where(rng.uniform(size=6000) < 0.9, 7,
                    rng.integers(0, 64, 6000))  # ~90% of rows share key 7
    rows = ", ".join(f"({int(k)}, {float(x):.4f})"
                     for k, x in zip(keys, rng.uniform(0, 1, 6000)))
    cur.execute(f"INSERT INTO skew VALUES {rows}")
    sql = "SELECT k, COUNT(*) AS n, SUM(v) AS sv FROM skew GROUP BY k ORDER BY k"
    free = db.connect(warehouse=conn.warehouse, **PART1, engine="auto")
    expect = free.execute(sql).fetchall()
    tight = db.connect(warehouse=conn.warehouse, **PART4,
                       **{"exchange.batch_rows": 64,
                          "exchange.buffer_rows": 512,
                          "exchange.buffer_bytes": 1 << 30}, engine="auto")
    h = tight.execute_async(sql)
    got = h.result(60).fetchall()
    assert rounded(got) == rounded(expect)
    p = h.poll()
    lane_rows = [l["rows"] for lanes in p["lanes"].values() for l in lanes]
    assert max(lane_rows) > 10 * max(1, min(lane_rows))  # skew observable
    spilled = [l for lanes in p["lanes"].values() for l in lanes
               if l["spilled_rows"] > 0]
    assert spilled, "hot lane exceeded its budget slice but never spilled"
    for c in (free, tight):
        c.close()


def test_barrier_mode_partition_parity(conn):
    """exchange.pipeline=False (and reopt re-execution) filters lanes from
    materialized batches instead of lane exchanges — same results."""
    sql = ("SELECT cat, COUNT(*) AS n FROM fact JOIN dim ON fk = dk"
           " GROUP BY cat ORDER BY cat")
    assert_parity(conn.warehouse, sql,
                  extra={**SHUFFLY, "exchange.pipeline": False})


def test_explain_shows_partitioned_exchanges(conn):
    s = conn.warehouse.session(**PART4, **SHUFFLY, engine="auto")
    text = s.explain("SELECT cat, SUM(v) FROM fact JOIN dim ON fk = dk"
                     " GROUP BY cat")
    assert "exchanges:" in text
    assert "SHUFFLE partitions=4" in text
    assert "FORWARD" in text
    # single-lane sessions show plain edges, no partition annotations
    s1 = conn.warehouse.session(**PART1, engine="auto")
    t1 = s1.explain("SELECT grp, SUM(v) FROM fact GROUP BY grp")
    assert "partitions=" not in t1


def test_shuffle_partitions_in_plan_cache_key(conn):
    wh = conn.warehouse
    sql = "SELECT grp, SUM(v) FROM fact GROUP BY grp"
    one = db.connect(warehouse=wh, **PART1, engine="auto")
    four = db.connect(warehouse=wh, **PART4, engine="auto")
    one.execute(sql)
    r = four.execute(sql)
    # different shuffle.partitions never share a cached plan entry
    assert not r.info.get("plan_cache_hit")
    r2 = four.execute(sql)
    assert r2.info.get("plan_cache_hit") or r2.info.get("cache_hit")
    for c in (one, four):
        c.close()


def test_auto_partitions_small_input_stays_single_lane(conn):
    s = conn.warehouse.session(result_cache=False,
                               **{"shuffle.partitions": "auto"}, engine="auto")
    text = s.explain("SELECT grp, SUM(v) FROM fact GROUP BY grp")
    assert "partitions=" not in text  # 4k rows < auto threshold


def test_auto_scan_fed_aggregate_demands_larger_payoff(conn):
    """BENCH_PR5 regression: ``auto`` declines fan-out for scan-fed
    aggregates below the lane-payoff threshold (the exchange hop costs more
    than the parallelism buys), while join-fed consumers at the same row
    estimate still expand."""
    from repro_torch.core.optimizer import plan as P
    from repro_torch.core.optimizer.rules import Optimizer
    from repro_torch.core.runtime.shuffle import expand_shuffle_partitions
    from repro_torch.core.sql.binder import Binder
    from repro_torch.core.sql.parser import parse

    hms = conn.warehouse.hms

    class FakeEst:
        def __init__(self, rows):
            self.rows = rows

    class FakeCM:
        def __init__(self, rows):
            self._rows = rows

        def estimate(self, node):
            return FakeEst(self._rows)

    def plan_for(sql):
        return Optimizer(hms).optimize(Binder(hms).bind(parse(sql)))

    def lanes(sql, est_rows):
        out = expand_shuffle_partitions(
            plan_for(sql), {"shuffle.partitions": "auto"},
            cost_model=FakeCM(est_rows))
        return any(isinstance(n, P.ShuffleRead) for n in P.walk_plan(out))

    scan_fed = "SELECT grp, SUM(v) FROM fact GROUP BY grp"
    join_fed = ("SELECT cat, SUM(v) AS s FROM fact JOIN dim ON fk = dk"
                " GROUP BY cat")
    # 240k rows: several multiples of the generic per-lane share, but below
    # the scan-fed payoff threshold -> the plain aggregate stays single-lane
    assert not lanes(scan_fed, 240_000)
    assert lanes(join_fed, 240_000)
    # far past the payoff threshold the scan-fed aggregate fans out too
    assert lanes(scan_fed, 2_000_000)


def test_auto_partitions_derive_from_cbo_estimates():
    from repro_torch.core.runtime.shuffle import (auto_partition_cap,
                                            resolve_partition_count)

    cap = auto_partition_cap()
    assert resolve_partition_count("auto", None) == 1
    assert resolve_partition_count("auto", 1000) == 1
    assert resolve_partition_count("auto", 100_000) == min(4, cap)
    assert resolve_partition_count("auto", 10**9) == cap
    assert resolve_partition_count(6, None) == 6
    assert resolve_partition_count(1, 10**9) == 1


# ---------------------------------------------------------------------------
# connector statistics -> CBO (ROADMAP satellite)
# ---------------------------------------------------------------------------
def test_connector_stats_feed_cost_model(conn):
    from repro_torch.core.optimizer.cost import CostModel

    jd = conn.warehouse.handlers.get("jdbc")
    rng = np.random.default_rng(0)
    jd.load_table("orders", VectorBatch({
        "uid": rng.integers(0, 500, 20_000),
        "price": rng.uniform(0, 50, 20_000).round(4),
    }))
    cur = conn.cursor()
    cur.execute("CREATE EXTERNAL TABLE orders (uid INT, price DOUBLE)"
                " STORED BY 'jdbc' TBLPROPERTIES ('jdbc.table'='orders')")
    desc = conn.warehouse.hms.get_table("orders")
    stats = jd.scan_builder(desc).estimate_stats()
    assert stats.row_count == 20_000
    assert stats.columns["uid"].ndv == 500
    assert stats.columns["uid"].min_value == 0

    from repro_torch.core.optimizer import plan as P

    cm = CostModel(conn.warehouse.hms,
                   handler_resolver=conn.warehouse.resolve_handler)
    est = cm.estimate(P.FederatedScan(desc, "o", ["uid", "price"]))
    assert est.rows == 20_000
    assert est.col("o.uid").ndv == 500
    # without the resolver the old empty-stats default applies
    cm0 = CostModel(conn.warehouse.hms)
    assert cm0.estimate(P.FederatedScan(desc, "o", ["uid", "price"])).rows <= 1


def test_memtable_catalog_stats(conn):
    cur = conn.cursor()
    cur.execute("CREATE CATALOG evc USING memtable")
    mem = conn.warehouse.catalogs.get("evc").handler
    rng = np.random.default_rng(1)
    mem.load("ev", VectorBatch({"k": rng.integers(0, 64, 5000),
                                "x": rng.uniform(0, 1, 5000)}))
    # resolve through the binder so the TableDesc carries the catalog handler
    r = conn.execute("SELECT COUNT(*) FROM evc.default.ev")
    assert r.fetchone()[0] == 5000
    desc = conn.warehouse.catalogs.get("evc").table_desc("default", "ev")
    st = mem.scan_builder(desc).estimate_stats()
    assert st.row_count == 5000 and st.columns["k"].ndv == 64


def test_federated_join_order_uses_remote_stats(conn):
    """With remote stats, the small external side broadcasts; the big side
    stays the probe side (previously both were empty-stats defaults)."""
    jd = conn.warehouse.handlers.get("jdbc")
    rng = np.random.default_rng(4)
    jd.load_table("big", VectorBatch({
        "k": rng.integers(0, 300, 50_000),
        "x": rng.uniform(0, 1, 50_000).round(4)}))
    jd.load_table("small", VectorBatch({
        "k": np.arange(300), "lbl": np.array([f"l{i % 9}" for i in range(300)])}))
    cur = conn.cursor()
    cur.execute("CREATE EXTERNAL TABLE big (k INT, x DOUBLE) STORED BY 'jdbc'"
                " TBLPROPERTIES ('jdbc.table'='big')")
    cur.execute("CREATE EXTERNAL TABLE small (k INT, lbl STRING)"
                " STORED BY 'jdbc' TBLPROPERTIES ('jdbc.table'='small')")
    r = conn.execute("SELECT lbl, SUM(x) AS sx FROM big JOIN small"
                     " ON big.k = small.k GROUP BY lbl ORDER BY lbl")
    assert r.info["dag_edges"]["BROADCAST"] >= 1
    assert len(r.fetchall()) == 9


# ---------------------------------------------------------------------------
# druid sorted-scan pushdown (ROADMAP satellite)
# ---------------------------------------------------------------------------
def test_druid_sorted_scan_limit_pushdown(conn):
    dr = conn.warehouse.handlers.get("druid")
    dr.store.segment_rows = 2500
    rng = np.random.default_rng(6)
    dr.store.create_datasource("events", VectorBatch({
        "ts": rng.permutation(9000),
        "val": rng.uniform(0, 1, 9000).round(5),
    }))
    cur = conn.cursor()
    cur.execute("CREATE EXTERNAL TABLE dev STORED BY 'druid'"
                " TBLPROPERTIES ('druid.datasource'='events')")
    dr.store.queries_served.clear()
    sql = "SELECT ts, val FROM dev ORDER BY ts DESC LIMIT 9"
    got = conn.execute(sql).fetchall()
    off = conn.warehouse.session(result_cache=False,
                                 **{"federation.push_limit": False}, engine="auto")
    expect = off.execute(sql).rows
    assert [r[0] for r in got] == [r[0] for r in expect]
    assert [r[0] for r in got] == sorted(
        [r[0] for r in got], reverse=True)
    pushed = [q for q in dr.store.queries_served
              if q["queryType"] == "scan" and q.get("limitSpec")]
    assert pushed, "sorted scan query did not carry a limitSpec"
    assert pushed[0]["limitSpec"]["columns"][0]["dimension"] == "ts"
    # multi-segment: per-split top-n merges locally (PARTIAL, not FULL)
    desc = conn.warehouse.hms.get_table("dev")
    b = dr.scan_builder(desc)
    mode = b.push_limit(9, [(0, True)])
    assert mode == "partial"
    assert len(b.to_splits()) > 1
