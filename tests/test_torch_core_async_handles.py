"""Async query handles: concurrent execution, WLM admission gating,
cancellation, kill triggers, and streaming fetch (paper §2 HS2 + §5.2)."""
import time

import pytest

import repro_torch.api as db


def wait_for(cond, timeout=10.0, interval=0.01, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out after {timeout}s waiting for {what}")


@pytest.fixture()
def conn(tmp_path):
    c = db.connect(str(tmp_path / "wh"), engine="auto")
    cur = c.cursor()
    cur.execute("CREATE TABLE t (k INT, v DOUBLE)")
    rows = ", ".join(f"({i % 50}, {i * 1.5})" for i in range(400))
    cur.execute(f"INSERT INTO t VALUES {rows}")
    yield c
    c.close()


TWO_POOL_DDL = [
    "CREATE RESOURCE PLAN duo",
    "CREATE POOL duo.a WITH alloc_fraction=0.5, query_parallelism=1",
    "CREATE POOL duo.b WITH alloc_fraction=0.5, query_parallelism=1",
    "CREATE APPLICATION MAPPING appA IN duo TO a",
    "CREATE APPLICATION MAPPING appB IN duo TO b",
    "ALTER PLAN duo SET DEFAULT POOL = a",
    "ALTER RESOURCE PLAN duo ENABLE ACTIVATE",
]


def activate_two_pools(conn):
    cur = conn.cursor()
    for ddl in TWO_POOL_DDL:
        cur.execute(ddl)


# ---------------------------------------------------------------------------
# handle basics
# ---------------------------------------------------------------------------
def test_handle_lifecycle_and_result(conn):
    h = conn.execute_async("SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY k")
    cur = h.result(timeout=30)
    assert h.state == "SUCCEEDED" and h.done()
    assert len(cur.fetchall()) == 50
    p = h.poll()
    assert p["state"] == "SUCCEEDED"
    assert p["vertices_total"] >= 2  # scan + aggregate: a multi-vertex DAG
    assert p["vertices_done"] == p["vertices_total"]
    assert "dag_edges" in h.info
    # result() is idempotent: same cursor back
    assert h.result() is cur


def test_cursor_execute_wraps_handle_path(conn):
    """PEP-249 Cursor.execute is a blocking wrapper over execute_async."""
    cur = conn.cursor()
    cur.execute("SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY k")
    sync_rows = cur.fetchall()
    assert cur.description[0][0] == "k"
    assert cur.rowcount == 50
    h = conn.execute_async("SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY k")
    assert h.result(30).fetchall() == sync_rows


def test_async_dml_and_ddl(conn):
    h = conn.execute_async("INSERT INTO t VALUES (99, 1.0)")
    h.result(30)
    assert h.state == "SUCCEEDED"
    assert conn.execute("SELECT COUNT(*) FROM t").fetchone() == (401,)


def test_submit_errors_raise_synchronously(conn):
    with pytest.raises(db.ProgrammingError):
        conn.execute_async("SELEKT nope")
    with pytest.raises(db.ProgrammingError):
        conn.execute_async("SELECT k FROM t WHERE v > ?")  # missing param


def test_result_timeout(conn):
    slow = db.connect(warehouse=conn.warehouse, debug_vertex_delay_s=0.5,
                      result_cache=False, engine="auto")
    h = slow.execute_async("SELECT COUNT(*) FROM t")
    with pytest.raises(TimeoutError):
        h.result(timeout=0.05)
    h.result(30)  # then completes fine


# ---------------------------------------------------------------------------
# WLM admission gating
# ---------------------------------------------------------------------------
def test_pool_parallelism_serializes_within_pool(conn):
    """Two handles in a parallelism=1 pool run serially (second QUEUED until
    the first finishes) while a second pool keeps running concurrently."""
    activate_two_pools(conn)
    wh = conn.warehouse
    ca = db.connect(warehouse=wh, application="appA",
                    debug_vertex_delay_s=0.4, result_cache=False, engine="auto")
    cb = db.connect(warehouse=wh, application="appB",
                    debug_vertex_delay_s=1.5, result_cache=False, engine="auto")

    # occupy pool b for the whole test so pool a cannot borrow idle capacity
    hb = cb.execute_async("SELECT COUNT(*) FROM t")
    wait_for(lambda: hb.state == "RUNNING", what="hb running")
    h1 = ca.execute_async("SELECT SUM(v) FROM t")
    wait_for(lambda: h1.state == "RUNNING", what="h1 running")
    h2 = ca.execute_async("SELECT COUNT(*) FROM t WHERE k > 10")

    time.sleep(0.25)  # let h2's worker reach (and sit in) admission
    assert h1.state == "RUNNING"
    assert h2.state == "QUEUED"          # pool a saturated, b not idle
    assert hb.state == "RUNNING"         # second pool concurrent throughout

    assert h1.result(30).fetchall()
    assert h2.result(30).fetchall()
    assert hb.result(30).fetchall()
    assert h2.poll()["pool"] == "a"
    assert h2.poll()["queue_wait_ms"] > 100  # measurably queued behind h1
    for c in (ca, cb):
        c.close()


def test_saturated_pools_queue_instead_of_killing(conn):
    """Async admission queues when every pool is full (the sync path's
    admit-or-die only applies to direct Session.execute calls)."""
    activate_two_pools(conn)
    wh = conn.warehouse
    ca = db.connect(warehouse=wh, application="appA",
                    debug_vertex_delay_s=0.3, result_cache=False, engine="auto")
    handles = [ca.execute_async("SELECT SUM(v) FROM t WHERE k > ?", (i,))
               for i in range(4)]
    for h in handles:
        h.result(60)
    assert all(h.state == "SUCCEEDED" for h in handles)
    ca.close()


# ---------------------------------------------------------------------------
# kill triggers / cancellation
# ---------------------------------------------------------------------------
def test_kill_trigger_fails_running_handle(conn):
    activate_two_pools(conn)
    cur = conn.cursor()
    cur.execute("CREATE RULE reaper IN duo WHEN rows_produced > 10 THEN KILL")
    cur.execute("ALTER RESOURCE PLAN duo ENABLE ACTIVATE")
    ca = db.connect(warehouse=conn.warehouse, application="appA",
                    result_cache=False, engine="auto")
    h = ca.execute_async("SELECT k, v FROM t WHERE v >= 0")
    with pytest.raises(db.QueryKilledError):
        h.result(30)
    assert h.state == "FAILED"
    ca.close()


def test_cancel_during_execution_leaves_session_usable(conn):
    slow = db.connect(warehouse=conn.warehouse, debug_vertex_delay_s=0.5,
                      result_cache=False, engine="auto")
    h = slow.execute_async("SELECT k, SUM(v) FROM t GROUP BY k")
    wait_for(lambda: h.state == "RUNNING", what="handle running")
    assert h.cancel()
    wait_for(h.done, what="handle terminal")
    assert h.state == "CANCELLED"
    with pytest.raises(db.QueryCancelledError):
        h.result(5)
    # the same session keeps serving queries afterwards
    assert slow.execute("SELECT COUNT(*) FROM t").fetchone() == (400,)
    slow.close()


def test_cancel_while_queued(conn):
    activate_two_pools(conn)
    wh = conn.warehouse
    ca = db.connect(warehouse=wh, application="appA",
                    debug_vertex_delay_s=0.6, result_cache=False, engine="auto")
    cb = db.connect(warehouse=wh, application="appB",
                    debug_vertex_delay_s=0.6, result_cache=False, engine="auto")
    blockers = [ca.execute_async("SELECT SUM(v) FROM t"),
                cb.execute_async("SELECT SUM(v) FROM t")]
    wait_for(lambda: all(b.state == "RUNNING" for b in blockers),
             what="both pools busy")
    h = ca.execute_async("SELECT COUNT(*) FROM t")
    time.sleep(0.1)
    assert h.state == "QUEUED"
    h.cancel()
    wait_for(h.done, what="queued handle cancelled")
    assert h.state == "CANCELLED"
    for b in blockers:
        b.result(30)
    for c in (ca, cb):
        c.close()


# ---------------------------------------------------------------------------
# streaming fetch
# ---------------------------------------------------------------------------
def test_fetch_stream_yields_before_succeeded(conn):
    """On a multi-vertex DAG, at least one batch arrives while the handle is
    still short of SUCCEEDED (backpressure holds the worker in RUNNING)."""
    h = conn.execute_async(
        "SELECT k, COUNT(*) AS n, SUM(v) AS s FROM t GROUP BY k ORDER BY k"
    )
    assert h.poll()["state"] in ("QUEUED", "ADMITTED", "RUNNING")
    states, rows = [], []
    for batch in h.fetch_stream(batch_rows=10):  # 50 groups -> 5 batches
        states.append(h.state)
        rows.extend(batch)
    assert len(rows) == 50
    assert len(states) == 5
    assert states[0] != "SUCCEEDED"  # streamed while still executing
    wait_for(h.done, what="handle terminal")
    assert h.state == "SUCCEEDED"
    assert h.poll()["vertices_total"] >= 2


def test_fetch_stream_replays_after_completion(conn):
    h = conn.execute_async("SELECT k FROM t ORDER BY k")
    h.result(30)
    batches = list(h.fetch_stream(batch_rows=100))
    assert [len(b) for b in batches] == [100, 100, 100, 100]
    assert batches[0][0] == (0,)


def test_fetch_stream_raises_query_error(conn):
    slow = db.connect(warehouse=conn.warehouse, debug_vertex_delay_s=0.3,
                      result_cache=False, engine="auto")
    h = slow.execute_async("SELECT k, SUM(v) FROM t GROUP BY k")
    wait_for(lambda: h.state == "RUNNING", what="handle running")
    h.cancel()
    with pytest.raises(db.QueryCancelledError):
        for _ in h.fetch_stream():
            pass
    slow.close()


def test_concurrent_handles_all_succeed(conn):
    """A fan-out of concurrent handles on one warehouse stays correct."""
    expect = conn.execute("SELECT COUNT(*) FROM t").fetchone()
    handles = [conn.execute_async("SELECT COUNT(*) FROM t WHERE k >= ?", (k,))
               for k in [0] * 6]
    got = [h.result(60).fetchone() for h in handles]
    assert got == [expect] * 6


def test_explain_analyze_queues_behind_admission(conn):
    """EXPLAIN ANALYZE executes its query, so the async path admits it like
    one: with every pool saturated it queues instead of being killed."""
    activate_two_pools(conn)
    wh = conn.warehouse
    ca = db.connect(warehouse=wh, application="appA",
                    debug_vertex_delay_s=0.5, result_cache=False, engine="auto")
    cb = db.connect(warehouse=wh, application="appB",
                    debug_vertex_delay_s=0.5, result_cache=False, engine="auto")
    blockers = [ca.execute_async("SELECT SUM(v) FROM t"),
                cb.execute_async("SELECT SUM(v) FROM t")]
    wait_for(lambda: all(b.state == "RUNNING" for b in blockers),
             what="both pools busy")
    he = conn.execute_async("EXPLAIN ANALYZE SELECT k, SUM(v) FROM t GROUP BY k")
    time.sleep(0.15)
    assert he.state == "QUEUED"
    for b in blockers:
        b.result(30)
    lines = [r[0] for r in he.result(30).fetchall()]
    assert any("stage timings:" in line for line in lines)
    for c in (ca, cb):
        c.close()
