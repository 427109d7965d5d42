"""Public client API (repro_torch.api): connection/cursor/prepared statements,
parameter binding, plan cache, staged pipeline timings, engine registry."""
import numpy as np
import pytest

import repro_torch.api as db
from repro_torch.kernels.registry import on_gpu


def _need_card(engine):
    """The port's kernel engines: ``ref`` runs everywhere, ``cuda`` (the
    JAX package's ``pallas``) needs an H100 and skips without one."""
    if engine == "cuda" and not on_gpu():
        pytest.skip("engine 'cuda' needs an NVIDIA GPU of compute "
                    "capability >= 9.0")


@pytest.fixture()
def conn(tmp_path):
    c = db.connect(str(tmp_path / "wh"), engine="auto")
    cur = c.cursor()
    cur.execute("CREATE TABLE events (k INT, v DOUBLE, tag STRING)")
    rows = ", ".join(
        f"({i}, {i * 1.5}, '{['red', 'green', 'blue'][i % 3]}')"
        for i in range(257)
    )
    cur.execute(f"INSERT INTO events VALUES {rows}")
    yield c
    c.close()


# ---------------------------------------------------------------------------
# connection basics
# ---------------------------------------------------------------------------
def test_module_globals():
    assert db.apilevel == "2.0"
    assert db.paramstyle == "qmark"
    assert issubclass(db.ProgrammingError, db.DatabaseError)
    assert issubclass(db.DatabaseError, db.Error)


def test_connect_validation(tmp_path):
    with pytest.raises(db.InterfaceError):
        db.connect()  # neither dir nor warehouse
    with pytest.raises(db.ProgrammingError):
        db.connect(str(tmp_path / "wh"), no_such_option=1)
    with pytest.raises(db.ProgrammingError):
        db.connect(str(tmp_path / "wh"), engine="tpu-v9")
    # the port's engine names: cuda (its default; pallas is an alias), ref
    # and auto are all valid, and connecting needs no card
    for engine in ("cuda", "pallas", "ref", "auto"):
        db.connect(str(tmp_path / "wh"), engine=engine).close()


def test_context_managers(tmp_path):
    with db.connect(str(tmp_path / "wh"), engine="auto") as conn:
        with conn.cursor() as cur:
            cur.execute("CREATE TABLE t (x INT)")
    assert conn.closed
    with pytest.raises(db.InterfaceError):
        conn.cursor()


def test_rollback_not_supported(conn):
    conn.commit()  # autocommit: a no-op, but allowed
    with pytest.raises(db.NotSupportedError):
        conn.rollback()


# ---------------------------------------------------------------------------
# cursor paging (fetchone / fetchmany / fetchall across page boundaries)
# ---------------------------------------------------------------------------
def test_fetchmany_pages_across_boundaries(conn):
    cur = conn.cursor()
    cur.execute("SELECT k FROM events ORDER BY k")
    assert cur.rowcount == 257
    got = []
    # uneven page sizes exercise boundary arithmetic incl. the short tail
    for size in (1, 100, 64, 64, 64):
        page = cur.fetchmany(size)
        assert len(page) <= size
        got.extend(r[0] for r in page)
    assert cur.fetchmany(10) == []  # exhausted
    assert got == list(range(257))


def test_fetchone_and_iteration(conn):
    cur = conn.cursor()
    cur.execute("SELECT k FROM events WHERE k < 5 ORDER BY k")
    assert cur.fetchone() == (0,)
    assert list(cur) == [(1,), (2,), (3,), (4,)]
    assert cur.fetchone() is None


def test_fetch_without_execute_raises(conn):
    cur = conn.cursor()
    with pytest.raises(db.InterfaceError):
        cur.fetchall()


def test_description_types(conn):
    cur = conn.cursor()
    cur.execute("SELECT k, v, tag FROM events LIMIT 1")
    names = [d[0] for d in cur.description]
    types = [d[1] for d in cur.description]
    assert names == ["k", "v", "tag"]
    assert types == ["BIGINT", "DOUBLE", "STRING"]


# ---------------------------------------------------------------------------
# parameter binding
# ---------------------------------------------------------------------------
def test_int_and_float_params(conn):
    cur = conn.cursor()
    cur.execute("SELECT COUNT(*) FROM events WHERE k >= ? AND v < ?",
                (250, 380.0))
    # k in [250, 253): v = 1.5k < 380 -> k < 253.33
    assert cur.fetchone() == (4,)


def test_string_param(conn):
    cur = conn.cursor()
    cur.execute("SELECT COUNT(*) FROM events WHERE tag = ?", ("green",))
    expected = len([i for i in range(257) if i % 3 == 1])
    assert cur.fetchone() == (expected,)


def test_null_param_roundtrip(conn):
    cur = conn.cursor()
    cur.execute("CREATE TABLE np (k INT, v DOUBLE)")
    cur.executemany("INSERT INTO np VALUES (?, ?)",
                    [(1, None), (2, 7.0)])
    cur.execute("SELECT k FROM np WHERE v IS NULL")
    assert cur.fetchall() == [(1,)]
    cur.execute("SELECT k FROM np WHERE v IS NOT NULL")
    assert cur.fetchall() == [(2,)]


def test_param_count_mismatch(conn):
    cur = conn.cursor()
    with pytest.raises(db.ProgrammingError):
        cur.execute("SELECT * FROM events WHERE k > ?")
    with pytest.raises(db.ProgrammingError):
        cur.execute("SELECT * FROM events WHERE k > ?", (1, 2))


def test_params_in_dml_update_delete(conn):
    cur = conn.cursor()
    cur.execute("CREATE TABLE dml (k INT, v DOUBLE)")
    cur.executemany("INSERT INTO dml VALUES (?, ?)",
                    [(i, float(i)) for i in range(10)])
    cur.execute("UPDATE dml SET v = ? WHERE k < ?", (99.0, 3))
    assert cur.rowcount == 3
    cur.execute("DELETE FROM dml WHERE v = ?", (99.0,))
    assert cur.rowcount == 3
    cur.execute("SELECT COUNT(*) FROM dml")
    assert cur.fetchone() == (7,)


# ---------------------------------------------------------------------------
# prepared statements / plan cache
# ---------------------------------------------------------------------------
def test_prepared_statement_plan_cache_hit(conn):
    ps = conn.prepare("SELECT k, v FROM events WHERE k > ? ORDER BY k")
    assert ps.is_query and ps.param_count == 1
    before = dict(conn.warehouse.plan_cache.stats)
    c1 = ps.execute((254,))
    assert c1.info.get("plan_cache_hit") is True  # warmed by prepare()
    assert c1.fetchall() == [(255, 382.5), (256, 384.0)]
    c2 = ps.execute((255,))  # different params reuse the same plan
    assert c2.info.get("plan_cache_hit") is True
    assert c2.fetchall() == [(256, 384.0)]
    after = conn.warehouse.plan_cache.stats
    assert after["hits"] >= before["hits"] + 2


def test_plain_execute_hits_plan_cache_second_time(conn):
    cur = conn.cursor()
    sql = "SELECT SUM(v) FROM events WHERE k < ?"
    r1 = cur.execute(sql, (100,)).info
    assert "plan_cache_hit" not in r1
    r2 = cur.execute(sql, (50,)).info  # different params -> same plan
    assert r2.get("plan_cache_hit") is True


def test_result_cache_key_includes_params(conn):
    cur = conn.cursor()
    sql = "SELECT COUNT(*) FROM events WHERE k < ?"
    a = cur.execute(sql, (10,)).fetchone()
    b = cur.execute(sql, (20,)).fetchone()
    assert a == (10,) and b == (20,)
    info = cur.execute(sql, (10,)).info  # same params -> result cache hit
    assert info.get("cache_hit") is True
    assert cur.fetchone() == (10,)


def test_prepare_rejects_bad_sql(conn):
    with pytest.raises(db.ProgrammingError):
        conn.prepare("SELECT * FROM missing_table")
    with pytest.raises(db.ProgrammingError):
        conn.prepare("SELEKT 1")
    ps = conn.prepare("SELECT k FROM events WHERE k = ?")
    with pytest.raises(db.ProgrammingError):
        ps.execute()  # missing parameter


def test_plan_cache_dropped_after_base_table_write(conn):
    """A cached MV-rewritten plan must not replay after base-table DML —
    the plan cache validates per-table WriteId state like the result cache."""
    cur = conn.cursor()
    cur.execute("CREATE TABLE base (g INT, x DOUBLE)")
    cur.execute("INSERT INTO base VALUES (1, 10.0), (2, 20.0)")
    cur.execute("CREATE MATERIALIZED VIEW mv_sum AS "
                "SELECT g, SUM(x) AS s FROM base GROUP BY g")
    sql = "SELECT g, SUM(x) FROM base GROUP BY g ORDER BY g"
    r1 = cur.execute(sql).fetchall()
    assert cur.info.get("mv_used") == "mv_sum"
    assert r1 == [(1, 10.0), (2, 20.0)]
    r2 = cur.execute(sql).fetchall()  # plan-cache hit, info preserved
    assert cur.info.get("plan_cache_hit") is True
    assert cur.info.get("mv_used") == "mv_sum"
    assert r2 == r1
    cur.execute("INSERT INTO base VALUES (1, 100.0)")
    r3 = cur.execute(sql).fetchall()  # stale MV plan must NOT replay
    assert cur.info.get("plan_cache_hit") is None
    assert r3 == [(1, 110.0), (2, 20.0)]


def test_kernel_filter_falls_back_beyond_float32(tmp_path):
    """Forced engines only use the float32 filter kernel when the cast is
    value-preserving; 2^24 + 1 must not collapse onto 2^24."""
    with db.connect(str(tmp_path / "wh"), engine="ref",
                    result_cache=False, pushdown=False) as c:
        cur = c.cursor()
        cur.execute("CREATE TABLE big (a INT)")
        cur.execute(f"INSERT INTO big VALUES ({1 << 24}), ({(1 << 24) + 1})")
        cur.execute(f"SELECT COUNT(*) FROM big WHERE a = {(1 << 24) + 1}")
        assert cur.fetchone() == (1,)


def test_plan_cache_invalidated_by_ddl(conn):
    cur = conn.cursor()
    cur.execute("SELECT COUNT(*) FROM events")
    cur.execute("SELECT COUNT(*) FROM events")
    assert len(conn.warehouse.plan_cache) > 0
    cur.execute("CREATE TABLE other (x INT)")
    assert len(conn.warehouse.plan_cache) == 0


# ---------------------------------------------------------------------------
# staged pipeline
# ---------------------------------------------------------------------------
def test_stage_times_in_info(conn):
    cur = conn.cursor()
    cur.execute("SELECT tag, COUNT(*) FROM events GROUP BY tag")
    st = cur.info.get("stage_times_ms")
    assert st is not None
    for stage in ("parse", "bind", "cache_probe", "mv_rewrite",
                  "optimize", "compile", "execute"):
        assert stage in st, f"missing stage {stage}"
        assert st[stage] >= 0


def test_explain_analyze_reports_stage_timings(conn):
    cur = conn.cursor()
    cur.execute("EXPLAIN ANALYZE SELECT tag, SUM(v) FROM events "
                "WHERE k > 10 GROUP BY tag")
    text = "\n".join(r[0] for r in cur.fetchall())
    assert "stage timings:" in text
    assert "execute:" in text and "optimize:" in text
    assert "Aggregate" in text  # the plan itself is included
    assert "stage_times_ms" in cur.info


def test_result_cache_not_shared_across_mv_rewriting_configs(conn):
    """An MV-rewriting session may serve stale-within-window MV data; a
    session with rewriting disabled must never get those rows from cache."""
    cur = conn.cursor()
    cur.execute("CREATE TABLE src (g INT, x DOUBLE)")
    cur.execute("INSERT INTO src VALUES (1, 1.0), (2, 2.0)")
    sql = "SELECT g, SUM(x) FROM src GROUP BY g ORDER BY g"
    cur.execute(sql)
    cur.execute(sql)
    assert cur.info["cache_hit"] is True
    with db.connect(warehouse=conn.warehouse, mv_rewriting=False, engine="auto") as c2:
        info = c2.execute(sql).info  # different cache identity -> fresh run
        assert info["cache_hit"] is False


def test_explain_analyze_bypasses_result_cache(conn):
    """EXPLAIN ANALYZE must execute and show the plan even when the plain
    query's result is already cached."""
    cur = conn.cursor()
    sql = "SELECT tag, COUNT(*) FROM events GROUP BY tag"
    cur.execute(sql)
    cur.execute(sql)
    assert cur.info["cache_hit"] is True
    cur.execute("EXPLAIN ANALYZE " + sql)
    text = "\n".join(r[0] for r in cur.fetchall())
    assert "Aggregate" in text and "execute:" in text
    assert cur.info["cache_hit"] is False


def test_explain_validates_param_count(conn):
    cur = conn.cursor()
    with pytest.raises(db.ProgrammingError):
        cur.execute("EXPLAIN SELECT k FROM events WHERE k > ?", (1, 2, 3))


def test_cache_hit_short_circuits_stages(conn):
    cur = conn.cursor()
    sql = "SELECT COUNT(*) FROM events WHERE tag = 'red'"
    miss = cur.execute(sql).info
    info = cur.execute(sql).info
    assert info["cache_hit"] is True
    st = info["stage_times_ms"]
    # a served hit reports the same stage keys as an executed query
    # (consumers key on stage names); the skipped post-probe stages are
    # zeroed, not absent — 0 ms spent, not "never happened"
    assert set(st) == set(miss["stage_times_ms"])
    assert st["execute"] == 0.0 and st["compile"] == 0.0
    assert st["cache_probe"] > 0.0


def test_legacy_session_execute_shim(conn):
    """Warehouse.session().execute() keeps working over the new pipeline."""
    s = conn.warehouse.session(engine="auto")
    r = s.execute("SELECT COUNT(*) FROM events")
    assert r.rows == [(257,)]
    assert r.info["cache_hit"] in (False, True)
    assert "stage_times_ms" in r.info
    r2 = s.execute("SELECT COUNT(*) FROM events WHERE k < ?", params=(5,))
    assert r2.rows == [(5,)]


# ---------------------------------------------------------------------------
# engine registry
# ---------------------------------------------------------------------------
def test_engine_validation_in_session(conn):
    with pytest.raises(ValueError):
        conn.warehouse.session(engine="tpu-v9")


@pytest.mark.parametrize("engine", ["ref", "cuda"])
def test_engine_ref_matches_default(tmp_path, engine):
    _need_card(engine)
    c_auto = db.connect(str(tmp_path / "wh"), result_cache=False, engine="auto")
    cur = c_auto.cursor()
    cur.execute("CREATE TABLE m (k INT, v DOUBLE)")
    cur.executemany("INSERT INTO m VALUES (?, ?)",
                    [(i, float(i % 7)) for i in range(64)])
    expect = cur.execute(
        "SELECT k FROM m WHERE v > 3 ORDER BY k").fetchall()
    # attached connections share the live warehouse; closing them must
    # not tear it down (only the owning connection does that)
    with db.connect(warehouse=c_auto.warehouse, result_cache=False,
                    engine=engine) as c_eng:
        got = c_eng.execute(
            "SELECT k FROM m WHERE v > 3 ORDER BY k").fetchall()
        assert got == expect, engine
    c_auto.close()


def test_registry_resolution():
    from repro_torch.kernels.registry import backends, resolve

    assert set(backends("filter_eval")) == {"cuda", "ref"}
    assert resolve("filter_eval", "ref") is not resolve("filter_eval",
                                                        "cuda")
    assert resolve("filter_eval", "auto") is resolve("filter_eval", "cuda")
    assert resolve("filter_eval", "pallas") is resolve("filter_eval", "cuda")
    with pytest.raises(KeyError):
        resolve("no_such_kernel")
    with pytest.raises(ValueError):
        resolve("filter_eval", "tpu-v9")


# ---------------------------------------------------------------------------
# plan-cache drift policy
# ---------------------------------------------------------------------------
def test_plan_cache_survives_small_writes(conn):
    """Non-MV plans stay cached across writes (scans re-resolve data at run
    time); only a >2x row-count shift re-optimizes."""
    cur = conn.cursor()
    q = "SELECT tag, COUNT(*) AS n FROM events GROUP BY tag ORDER BY tag"
    cur.execute(q)
    cur.execute(q)
    assert cur.info["plan_cache_hit"] is True
    cur.execute("INSERT INTO events VALUES (999, 1.0, 'red')")  # +1 row
    cur.execute(q)
    assert cur.info.get("plan_cache_hit") is True  # plan survived the write
    counts = dict(cur.fetchall())
    assert counts["red"] == 87  # ...and the new row is visible (86 + 1)


def test_plan_cache_drops_on_row_count_drift(conn):
    cur = conn.cursor()
    q = "SELECT tag, COUNT(*) AS n FROM events GROUP BY tag"
    cur.execute(q)
    cur.execute(q)
    assert cur.info["plan_cache_hit"] is True
    rows = ", ".join(f"({i}, 0.5, 'grey')" for i in range(600))  # 257 -> >2x
    cur.execute(f"INSERT INTO events VALUES {rows}")
    cur.execute(q)
    assert cur.info.get("plan_cache_hit") is None  # drift re-optimized


# ---------------------------------------------------------------------------
# grouped aggregation through the kernel registry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("engine", ["ref", "cuda"])
def test_engine_routes_grouped_aggregation_through_registry(tmp_path, engine):
    """engine != auto dispatches SUM/COUNT through kernels.registry
    ('hash_group'), like filter conjunctions already do."""
    import repro_torch.kernels.registry as registry

    _need_card(engine)
    c = db.connect(str(tmp_path / "wh"), result_cache=False, engine="auto")
    cur = c.cursor()
    cur.execute("CREATE TABLE g (k INT, v DOUBLE, n INT)")
    cur.execute("INSERT INTO g VALUES " + ", ".join(
        f"({i % 7}, {i * 0.5}, {i % 13})" for i in range(200)))
    q = ("SELECT k, SUM(v) AS sv, COUNT(v) AS cv, AVG(n) AS an "
         "FROM g GROUP BY k ORDER BY k")
    expect = cur.execute(q).fetchall()

    calls = []
    orig = registry.resolve

    def spy(kernel, engine="auto"):
        calls.append((kernel, engine))
        return orig(kernel, engine)

    registry.resolve = spy
    try:
        with db.connect(warehouse=c.warehouse, result_cache=False,
                        engine=engine) as ce:
            got = ce.execute(q).fetchall()
        assert [k for k, _ in calls].count("hash_group") > 0, engine
        assert all(e == engine for k, e in calls if k == "hash_group")
        for exp_row, got_row in zip(expect, got):
            assert exp_row == pytest.approx(got_row), engine
    finally:
        registry.resolve = orig
    c.close()


def test_kernel_agg_falls_back_beyond_float32(tmp_path):
    """Integer SUMs that float32 accumulation cannot represent exactly must
    take the numpy path even under a forced engine."""
    with db.connect(str(tmp_path / "wh"), engine="ref",
                    result_cache=False) as c:
        cur = c.cursor()
        cur.execute("CREATE TABLE big (k INT, a INT)")
        cur.execute(f"INSERT INTO big VALUES (1, {1 << 24}), (1, 1)")
        cur.execute("SELECT k, SUM(a) AS s FROM big GROUP BY k")
        assert cur.fetchall() == [(1, (1 << 24) + 1)]
