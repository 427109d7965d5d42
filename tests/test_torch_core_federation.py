"""Federation: capability-negotiated DataSource/catalog API (paper §6).

Covers the redesigned surface: ``CREATE CATALOG`` + three-part names with
lazy remote-schema discovery, piecewise pushdown negotiation (each kind
toggleable, residuals evaluated locally), split-parallel streaming scans
through the exchange layer, the batched Writer path, and the SerDe
union-of-keys fix.
"""
from _torch_core import warehouse  # noqa: F401
import time

import numpy as np
import pytest

from repro_torch.core.runtime.vector import VectorBatch

PUSH_OFF = {
    "federation.push_filters": False,
    "federation.push_projection": False,
    "federation.push_aggregate": False,
    "federation.push_limit": False,
}


def _rounded(rows):
    return sorted(
        tuple(round(x, 6) if isinstance(x, float) else x for x in r)
        for r in rows
    )


@pytest.fixture()
def druid_source(warehouse):
    rng = np.random.default_rng(3)
    dr = warehouse.handlers.get("druid")
    dr.store.create_datasource("my_druid_source", VectorBatch({
        "__time": np.array([f"2017-{1 + i % 12:02d}-01" for i in range(3000)]),
        "d1": np.array([f"u{i % 7}" for i in range(3000)]),
        "m1": rng.uniform(0, 10, 3000),
    }))
    s = warehouse.session(engine="auto")
    s.execute(
        "CREATE EXTERNAL TABLE druid_table_1 STORED BY"
        " 'org.apache.hadoop.hive.druid.DruidStorageHandler'"
        " TBLPROPERTIES ('druid.datasource' = 'my_druid_source')")
    return warehouse


@pytest.fixture()
def mem_catalog(warehouse):
    """A mounted memtable catalog with one table of 3 columns."""
    s = warehouse.session(engine="auto")
    s.execute("CREATE CATALOG mem USING memtable")
    h = warehouse.catalogs.get("mem").handler
    rng = np.random.default_rng(11)
    h.load("t", VectorBatch({
        "a": np.arange(2000),
        "b": rng.uniform(0, 1, 2000).round(6),
        "c": np.array([f"g{i % 5}" for i in range(2000)]),
    }))
    return warehouse


# ===========================================================================
# STORED BY handlers, rebuilt on the new API (back-compat surface)
# ===========================================================================
def test_schema_inference_from_druid(druid_source):
    desc = druid_source.hms.get_table("druid_table_1")
    assert dict(desc.schema)["m1"] == "DOUBLE"
    assert dict(desc.schema)["d1"] == "STRING"


def test_groupby_pushdown_figure6(druid_source):
    """The Figure-6 query: groupBy JSON with limitSpec pushed to Druid."""
    s = druid_source.session(engine="auto")
    r = s.execute("SELECT d1, SUM(m1) AS sm FROM druid_table_1"
                  " GROUP BY d1 ORDER BY sm DESC LIMIT 3")
    pushed = r.info["federated_pushdown"]["druid_table_1"]["pushed"]
    assert pushed["aggregate"] == "full"  # single segment -> fully absorbed
    assert pushed["limit"] == "full"
    dr = druid_source.handlers.get("druid")
    q = dr.store.queries_served[-1]
    assert q["queryType"] == "groupBy"
    assert q["limitSpec"]["limit"] == 3
    assert q["limitSpec"]["columns"][0]["direction"] == "descending"
    # correctness vs local compute
    seg = VectorBatch.concat([x.batch for x in dr.store.datasources["my_druid_source"]])
    import collections

    agg = collections.defaultdict(float)
    for d, m in zip(seg.cols["d1"], seg.cols["m1"]):
        agg[d] += m
    exp = sorted(agg.items(), key=lambda kv: -kv[1])[:3]
    assert [(a, round(b, 6)) for a, b in r.rows] == \
        [(a, round(b, 6)) for a, b in exp]


def test_druid_partial_aggregate_multi_segment(warehouse):
    """Multiple segments: per-segment partial aggregates stream in parallel
    and the local Aggregate merges them (partial pushdown, not a bypass)."""
    rng = np.random.default_rng(5)
    dr = warehouse.handlers.get("druid")
    dr.store.segment_rows = 500
    dr.store.create_datasource("seg_src", VectorBatch({
        "d1": np.array([f"u{i % 7}" for i in range(3000)]),
        "m1": rng.uniform(0, 10, 3000),
    }))
    s = warehouse.session(result_cache=False, engine="auto")
    s.execute("CREATE EXTERNAL TABLE segt STORED BY 'druid'"
              " TBLPROPERTIES ('druid.datasource' = 'seg_src')")
    r = s.execute("SELECT d1, SUM(m1) sm, COUNT(*) c FROM segt GROUP BY d1"
                  " ORDER BY d1")
    report = r.info["federated_pushdown"]["segt"]
    assert report["pushed"]["aggregate"] == "partial"
    assert report["residual"]["aggregate"] == "merge"
    off = warehouse.session(result_cache=False, **PUSH_OFF, engine="auto")
    r_off = off.execute("SELECT d1, SUM(m1) sm, COUNT(*) c FROM segt"
                        " GROUP BY d1 ORDER BY d1")
    assert _rounded(r.rows) == _rounded(r_off.rows)


def test_filter_pushdown_to_druid(druid_source):
    s = druid_source.session(engine="auto")
    r = s.execute("SELECT d1, m1 FROM druid_table_1 WHERE d1 = 'u3'")
    report = r.info["federated_pushdown"]["druid_table_1"]
    assert report["pushed"]["filters"] == 1
    assert report["residual"] == {}
    assert all(d == "u3" for d, _ in r.rows)


def test_druid_join_with_native_table(druid_source):
    s = druid_source.session(engine="auto")
    s.execute("CREATE TABLE users (uid STRING, region STRING)")
    s.execute("INSERT INTO users VALUES ('u1', 'emea'), ('u3', 'apac')")
    r = s.execute("""SELECT region, SUM(m1) s FROM druid_table_1, users
                     WHERE d1 = uid GROUP BY region ORDER BY region""")
    assert [row[0] for row in r.rows] == ["apac", "emea"]


def test_jdbc_sql_generation_pushdown(warehouse):
    jd = warehouse.handlers.get("jdbc")
    rng = np.random.default_rng(4)
    jd.load_table("remote_t", VectorBatch({
        "a": np.arange(500), "b": rng.uniform(0, 1, 500)}))
    s = warehouse.session(engine="auto")
    s.execute("CREATE EXTERNAL TABLE jt (a INT, b DOUBLE) STORED BY 'jdbc'"
              " TBLPROPERTIES ('jdbc.table'='remote_t')")
    r = s.execute("SELECT SUM(b) sb, COUNT(*) c FROM jt WHERE a BETWEEN 10 AND 99")
    report = r.info["federated_pushdown"]["jt"]
    assert report["pushed"] == {"filters": 1, "aggregate": "full"}
    sql = jd.queries_served[-1]
    assert "GROUP BY" not in sql and "WHERE" in sql and "SUM" in sql
    assert r.rows[0][1] == 90


def test_jdbc_schema_inference(warehouse):
    jd = warehouse.handlers.get("jdbc")
    jd.load_table("inferme", VectorBatch({"x": np.arange(3),
                                          "y": np.array(["a", "b", "c"])}))
    s = warehouse.session(engine="auto")
    s.execute("CREATE EXTERNAL TABLE it STORED BY 'jdbc'"
              " TBLPROPERTIES ('jdbc.table'='inferme')")
    desc = warehouse.hms.get_table("it")
    assert dict(desc.schema) == {"x": "BIGINT", "y": "STRING"}


def test_insert_into_druid_table(druid_source):
    """Output format: the batched Writer path (write_batch/commit)."""
    s = druid_source.session(engine="auto")
    s.execute("CREATE EXTERNAL TABLE druid_table_2 (__time STRING,"
              " dim1 VARCHAR(20), m1 DOUBLE) STORED BY 'druid'")
    s.execute("INSERT INTO druid_table_2 VALUES ('2017-01-01', 'x', 1.5),"
              " ('2017-01-02', 'y', 2.5)")
    r = s.execute("SELECT SUM(m1) FROM druid_table_2")
    assert abs(r.rows[0][0] - 4.0) < 1e-9


def test_metastore_hook_notifications(druid_source):
    events = [e for _, e, _ in druid_source.hms.notifications()]
    assert "CREATE_TABLE" in events


# ===========================================================================
# SerDe: union of keys + null fill (heterogeneous external rows)
# ===========================================================================
def test_serde_union_of_keys_null_fill():
    from repro_torch.core.federation.handler import SerDe

    rows = [{"a": 1, "b": 2.5}, {"a": 2, "c": "x"}, {"b": 7.0, "c": "y"}]
    batch = SerDe().deserialize(rows)
    assert set(batch.column_names) == {"a", "b", "c"}  # not just rows[0]
    assert batch.num_rows == 3
    a = batch.cols["a"]
    assert a[0] == 1 and a[1] == 2 and np.isnan(a[2])
    b = batch.cols["b"]
    assert b[0] == 2.5 and np.isnan(b[1]) and b[2] == 7.0
    assert batch.cols["c"].tolist() == ["", "x", "y"]


def test_memtable_load_rows_routes_through_serde(warehouse):
    s = warehouse.session(engine="auto")
    s.execute("CREATE CATALOG hetero USING memtable")
    h = warehouse.catalogs.get("hetero").handler
    h.load("ev", [{"k": 1, "v": 10.0}, {"k": 2}, {"k": 3, "v": 30.0}])
    r = s.execute("SELECT SUM(v) sv, COUNT(*) c FROM hetero.default.ev")
    assert r.rows[0] == (40.0, 3)  # NaN null-fill skipped by SUM


# ===========================================================================
# catalogs: CREATE CATALOG, three-part names, lazy discovery, persistence
# ===========================================================================
def test_catalog_three_part_names_and_discovery(mem_catalog):
    s = mem_catalog.session(result_cache=False, engine="auto")
    r = s.execute("SELECT a, b FROM mem.default.t WHERE a < 5 ORDER BY a")
    assert [row[0] for row in r.rows] == [0, 1, 2, 3, 4]
    # two-part name goes through the connector's default schema
    r2 = s.execute("SELECT a FROM mem.t WHERE a >= 1998 ORDER BY a")
    assert [row[0] for row in r2.rows] == [1998, 1999]
    # lazy discovery cached the TableDesc on the catalog
    cat = mem_catalog.catalogs.get("mem")
    assert "default.t" in cat._descs
    assert cat.list_tables() == ["t"]


def test_catalog_alias_and_join_with_native(mem_catalog):
    s = mem_catalog.session(result_cache=False, engine="auto")
    s.execute("CREATE TABLE grp (g STRING, w INT)")
    s.execute("INSERT INTO grp VALUES ('g0', 10), ('g3', 20)")
    r = s.execute("""SELECT grp.g, COUNT(*) n FROM mem.default.t x, grp
                     WHERE x.c = grp.g GROUP BY grp.g ORDER BY grp.g""")
    assert [row[0] for row in r.rows] == ["g0", "g3"]
    assert all(n == 400 for _, n in r.rows)


def test_catalog_ddl_api_and_persistence(tmp_path):
    import repro_torch.api as db
    from repro_torch.core.session import Warehouse

    whdir = str(tmp_path / "wh")
    conn = db.connect(whdir, engine="auto")
    conn.execute("CREATE CATALOG sales USING jdbc")
    conn.execute("CREATE CATALOG events USING memtable WITH (latency_s = '0')")
    assert conn.catalogs() == {"events": "memtable", "sales": "jdbc"}
    # each jdbc catalog is its own connector instance, not the global one
    jd = conn.warehouse.catalogs.get("sales").handler
    assert jd is not conn.warehouse.handlers.get("jdbc")
    jd.load_table("customers", VectorBatch({
        "id": np.arange(5), "name": np.array(list("abcde"))}))
    cur = conn.execute("SELECT name FROM sales.main.customers WHERE id = 3")
    assert cur.fetchall() == [("d",)]
    conn.execute("DROP CATALOG events")
    assert conn.catalogs() == {"sales": "jdbc"}
    conn.close()

    # catalog definitions persist in the metastore across reopen
    wh2 = Warehouse(whdir)
    assert wh2.catalogs.names() == ["sales"]
    assert wh2.catalogs.get("sales").connector == "jdbc"
    wh2.close()


def test_unknown_catalog_and_table_errors(mem_catalog):
    s = mem_catalog.session(engine="auto")
    with pytest.raises(Exception, match="unknown catalog"):
        s.execute("SELECT * FROM nope.default.t")
    with pytest.raises(Exception, match="no table"):
        s.execute("SELECT * FROM mem.default.missing")


# ===========================================================================
# capability matrix: each pushdown kind on/off x residual correctness
# ===========================================================================
# (gate, query, expectation key/value); the LIMIT probe runs without a
# WHERE clause because a limit may not jump below an unpushed filter
FILTER_Q = "SELECT a, b FROM mem.default.t WHERE a < 1200 AND b < 0.9"
LIMIT_Q = "SELECT a, b FROM mem.default.t LIMIT 400"


@pytest.mark.parametrize("gate,query", [
    ("federation.push_filters", FILTER_Q),
    ("federation.push_projection", FILTER_Q),
    ("federation.push_limit", LIMIT_Q),
])
def test_capability_matrix_memtable(mem_catalog, gate, query):
    base = mem_catalog.session(result_cache=False, **PUSH_OFF, engine="auto")
    r_off = base.execute(query)
    assert r_off.info["federated_pushdown"]["mem.default.t"]["pushed"] == {}

    on = mem_catalog.session(result_cache=False,
                             **{**PUSH_OFF, gate: True}, engine="auto")
    r_on = on.execute(query)
    pushed = r_on.info["federated_pushdown"]["mem.default.t"]["pushed"]
    kind = gate.split(".")[-1].replace("push_", "")
    if kind == "filters":
        assert pushed.get("filters") == 2
    elif kind == "projection":
        assert pushed.get("projection") == ["a", "b"]
    else:
        assert pushed.get("limit") == "partial"
    if kind == "limit":
        # a LIMIT result set is not deterministic; counts must agree
        assert r_on.num_rows == r_off.num_rows == 400
        assert all(a < 2000 for a, _ in r_on.rows)
    else:
        # residual correctness: rows identical to pushdown-off
        assert _rounded(r_on.rows) == _rounded(r_off.rows)
        full_on = mem_catalog.session(result_cache=False, engine="auto")
        assert _rounded(full_on.execute(query).rows) == _rounded(r_off.rows)


@pytest.mark.parametrize("enabled", [True, False])
def test_capability_matrix_aggregate_jdbc(warehouse, enabled):
    jd = warehouse.handlers.get("jdbc")
    rng = np.random.default_rng(9)
    jd.load_table("m", VectorBatch({
        "g": np.array([f"k{i % 4}" for i in range(300)]),
        "v": rng.uniform(0, 5, 300).round(4)}))
    s = warehouse.session(result_cache=False,
                          **{"federation.push_aggregate": enabled}, engine="auto")
    s.execute("CREATE EXTERNAL TABLE magg (g STRING, v DOUBLE)"
              " STORED BY 'jdbc' TBLPROPERTIES ('jdbc.table'='m')")
    r = s.execute("SELECT g, SUM(v) sv, MIN(v) mv FROM magg GROUP BY g"
                  " ORDER BY g")
    pushed = r.info["federated_pushdown"]["magg"]["pushed"]
    assert ("aggregate" in pushed) == enabled
    exp = {}
    raw = jd.conn.execute('SELECT "g", "v" FROM "m"').fetchall()
    for g, v in raw:
        lo, sm = exp.get(g, (float("inf"), 0.0))
        exp[g] = (min(lo, v), sm + v)
    expect = sorted((g, round(sm, 6), round(lo, 6))
                    for g, (lo, sm) in exp.items())
    assert [(g, round(sv, 6), round(mv, 6)) for g, sv, mv in r.rows] == expect


def test_partial_filter_residual_parity(warehouse):
    """One conjunct translates, one does not: the residual is evaluated
    locally and results match pushdown-off exactly."""
    jd = warehouse.handlers.get("jdbc")
    jd.load_table("pr", VectorBatch({
        "a": np.arange(200), "s": np.array([f"V{i % 10}" for i in range(200)])}))
    s = warehouse.session(result_cache=False, engine="auto")
    s.execute("CREATE EXTERNAL TABLE prt (a INT, s STRING) STORED BY 'jdbc'"
              " TBLPROPERTIES ('jdbc.table'='pr')")
    q = "SELECT a, s FROM prt WHERE a < 100 AND lower(s) = 'v3'"
    r = s.execute(q)
    report = r.info["federated_pushdown"]["prt"]
    assert report["pushed"]["filters"] == 1      # a < 100 -> SQL
    assert report["residual"]["filters"] == 1    # lower(s) = 'v3' -> local
    off = warehouse.session(result_cache=False, **PUSH_OFF, engine="auto")
    assert _rounded(r.rows) == _rounded(off.execute(q).rows)
    assert r.num_rows == 10


def test_explain_shows_pushed_vs_residual(warehouse):
    jd = warehouse.handlers.get("jdbc")
    jd.load_table("ex", VectorBatch({
        "a": np.arange(50), "s": np.array([f"V{i % 5}" for i in range(50)])}))
    s = warehouse.session(engine="auto")
    s.execute("CREATE EXTERNAL TABLE ext (a INT, s STRING) STORED BY 'jdbc'"
              " TBLPROPERTIES ('jdbc.table'='ex')")
    text = s.explain("SELECT a FROM ext WHERE a < 10 AND lower(s) = 'v1'")
    assert "pushed=filters:1" in text          # on the FederatedScan node
    assert "Filter[" in text                   # the residual, kept local
    assert "lower" in text


# ===========================================================================
# streaming: first batch before the connector finishes; splits in parallel
# ===========================================================================
def test_streaming_first_batch_before_producer_finishes(warehouse):
    import repro_torch.api as db

    s = warehouse.session(engine="auto")
    s.execute("CREATE CATALOG slow USING memtable"
              " WITH (latency_s = '0.01', batch_rows = '50')")
    h = warehouse.catalogs.get("slow").handler
    h.load("t", VectorBatch({"a": np.arange(4000),
                             "b": np.arange(4000) * 0.5}))
    # 2 splits + union + root on the 4 LLAP executors: the root vertex
    # streams concurrently with the split readers
    conn = db.connect(warehouse=warehouse, result_cache=False,
                      **{"federation.splits": 2}, engine="auto")
    handle = conn.execute_async("SELECT a, b FROM slow.default.t")
    t_first = None
    rows = 0
    for batch in handle.fetch_stream(batch_rows=50):
        if t_first is None:
            t_first = time.monotonic()
            state_at_first = handle.state
        rows += len(batch)
    handle.result(60)
    assert rows == 4000
    # the connector was still producing when the first batch reached us
    assert h.last_produced_at() is not None
    assert t_first < h.last_produced_at()
    assert state_at_first == "RUNNING"
    # splits executed concurrently through the exchange layer
    assert h.peak_active_readers >= 2
    # ... and the DAG really fanned out one vertex per split
    p = handle.poll()
    assert p["vertices_total"] >= 4
    conn.close()


def test_split_parallel_parity_and_cancellation(warehouse):
    import repro_torch.api as db

    s = warehouse.session(engine="auto")
    s.execute("CREATE CATALOG par USING memtable"
              " WITH (latency_s = '0.005', batch_rows = '100')")
    h = warehouse.catalogs.get("par").handler
    h.load("t", VectorBatch({"a": np.arange(3000)}))
    conn = db.connect(warehouse=warehouse, result_cache=False, engine="auto")
    # parity across split counts
    one = db.connect(warehouse=warehouse, result_cache=False,
                     **{"federation.splits": 1}, engine="auto")
    q = "SELECT a FROM par.default.t WHERE a % 7 = 0"
    assert sorted(conn.execute(q).fetchall()) == \
        sorted(one.execute(q).fetchall())
    # cancel is observed at batch boundaries inside split readers
    handle = conn.execute_async("SELECT a FROM par.default.t")
    handle.cancel()
    with pytest.raises(db.QueryCancelledError):
        handle.result(30)
    one.close()
    conn.close()


def test_aggregate_over_expression_stays_local(warehouse):
    """SUM(v + 1): the binder pre-projects a computed column; that synthetic
    name is NOT a remote column, so the aggregate must stay local (pushing
    it used to generate SUM("aa_N") and silently return 0 via sqlite's
    string-literal fallback)."""
    jd = warehouse.handlers.get("jdbc")
    jd.load_table("r", VectorBatch({
        "g": np.array(["a", "a", "b", "b"]), "v": np.array([2.0, 3.0, 4.0, 3.0])}))
    s = warehouse.session(result_cache=False, engine="auto")
    s.execute("CREATE EXTERNAL TABLE rt (g STRING, v DOUBLE) STORED BY 'jdbc'"
              " TBLPROPERTIES ('jdbc.table'='r')")
    r = s.execute("SELECT g, SUM(v + 1) s2 FROM rt GROUP BY g ORDER BY g")
    assert "aggregate" not in \
        r.info["federated_pushdown"]["rt"]["pushed"]
    assert [(g, round(x, 6)) for g, x in r.rows] == [("a", 7.0), ("b", 9.0)]
    # same shape on druid: must not crash, must not push
    dr = warehouse.handlers.get("druid")
    dr.store.create_datasource("rexpr", VectorBatch({
        "g": np.array(["a", "a", "b"]), "v": np.array([1.0, 2.0, 3.0])}))
    s.execute("CREATE EXTERNAL TABLE drt STORED BY 'druid'"
              " TBLPROPERTIES ('druid.datasource'='rexpr')")
    r = s.execute("SELECT g, SUM(v * 2) m FROM drt GROUP BY g ORDER BY g")
    assert [(g, round(x, 6)) for g, x in r.rows] == [("a", 6.0), ("b", 6.0)]


def test_group_by_expression_stays_local(mem_catalog):
    """GROUP BY (a % 3): synthetic group-key columns must not push."""
    s = mem_catalog.session(result_cache=False, engine="auto")
    r = s.execute("SELECT a % 3 AS k, COUNT(*) n FROM mem.default.t"
                  " GROUP BY a % 3 ORDER BY k")
    assert [row[0] for row in r.rows] == [0, 1, 2]
    assert sum(row[1] for row in r.rows) == 2000
