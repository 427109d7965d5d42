"""Serving tier: shared scans, serving result cache, sharded
admission, serve-without-admission, and the DROP-during-scan race.

Covers: result parity between attached and fresh scans, byte-bounded LRFU
eviction and write-ID invalidation of the serving result cache, cache hits
served without a WLM slot while the pool is saturated, sharded-admission
stress (no lost wakeups; kill triggers still fire), DROP TABLE racing an
in-flight scan, and a 32-client mixed-workload concurrency smoke (the CI
deadlock-guard step).
"""
from _torch_core import session  # noqa: F401
import threading
import time

import numpy as np
import pytest

import repro_torch.api as db
from repro_torch.core.runtime.wlm import QueryKilledError

SERVING_OFF = {"serving.shared_scans": False, "serving.result_cache": False}


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
    cur.execute("CREATE TABLE dim (k INT, grp INT, w DOUBLE)")
    cur.execute("CREATE TABLE fact (fk INT, v INT)")
    rows = ", ".join(f"({i}, {i % 7}, {i * 0.5})" for i in range(60))
    cur.execute(f"INSERT INTO dim VALUES {rows}")
    rng = np.random.default_rng(11)
    fk = rng.integers(0, 60, 4000)
    v = rng.integers(0, 1000, 4000)
    rows = ", ".join(f"({int(a)}, {int(b)})" for a, b in zip(fk, v))
    cur.execute(f"INSERT INTO fact VALUES {rows}")
    yield c
    c.close()


# ===========================================================================
# shared scans
# ===========================================================================
def _compile(session, sql):
    from repro_torch.core.optimizer.rules import Optimizer
    from repro_torch.core.runtime.dag import compile_dag
    from repro_torch.core.sql.binder import Binder
    from repro_torch.core.sql.parser import parse

    plan = Optimizer(session.hms).optimize(
        Binder(session.hms).bind(parse(sql)))
    return compile_dag(plan)


def test_attached_scan_parity_with_fresh(conn):
    """A query attaching to an in-flight scan's exchange produces exactly
    the rows a fresh (serving-off) scan produces.  Deterministic: the
    producer's root vertex is delayed so its published scan entry is
    guaranteed live while the consumer DAG runs."""
    from repro_torch.core.runtime.dag import DAGScheduler

    wh = conn.warehouse
    s = conn.session
    cfg = {**s.config, "result_cache": False, "semijoin_reduction": False}
    q1 = ("SELECT grp, SUM(v) AS s FROM fact, dim WHERE fk = k"
          " GROUP BY grp ORDER BY grp")
    q2 = ("SELECT grp, COUNT(v) AS c FROM fact, dim WHERE fk = k"
          " GROUP BY grp ORDER BY grp")
    dag1, dag2 = _compile(s, q1), _compile(s, q2)

    producer_out, errs = [], []

    def produce():
        try:
            sched = DAGScheduler(injected_delays={dag1.root: 1.5})
            producer_out.append(sched.execute(dag1, s._make_ctx(cfg)))
        except Exception as exc:  # noqa: BLE001 - surfaced below
            errs.append(exc)

    t = threading.Thread(target=produce)
    t.start()
    wait_for(lambda: wh.shared_scans.stats_snapshot()["live_entries"] > 0,
             what="producer to publish its scan exchanges")

    before = wh.shared_scans.stats_snapshot()["attached"]
    attached = DAGScheduler().execute(dag2, s._make_ctx(cfg))
    assert wh.shared_scans.stats_snapshot()["attached"] > before, \
        "consumer never attached to the live scan"

    fresh_ctx = s._make_ctx(cfg)
    fresh_ctx.shared_scans = None
    fresh = DAGScheduler().execute(dag2, fresh_ctx)
    assert attached.to_rows() == fresh.to_rows()

    t.join(timeout=30)
    assert not errs, errs
    # the producer's own result is unaffected by having been shared
    off_ctx = s._make_ctx(cfg)
    off_ctx.shared_scans = None
    assert producer_out[0].to_rows() == \
        DAGScheduler().execute(dag1, off_ctx).to_rows()
    wait_for(lambda: wh.shared_scans.stats_snapshot()["live_entries"] == 0,
             what="all published entries to retire")


def test_shared_scan_disabled_never_publishes(conn):
    wh = conn.warehouse
    off = db.connect(warehouse=wh, **SERVING_OFF, engine="auto")
    off.execute("SELECT grp, SUM(v) AS s FROM fact, dim WHERE fk = k"
                " GROUP BY grp").fetchall()
    assert wh.serving_stats()["shared_scans"]["published"] == 0
    off.close()


def test_snapshot_difference_prevents_sharing(conn):
    """A write between two executions changes the write-ID state, so the
    second query's scan key misses the registry instead of reading stale
    retained chunks."""
    wh = conn.warehouse
    on = db.connect(warehouse=wh, semijoin_reduction=False,
                    result_cache=False, **{"debug_vertex_delay_s": 0.1}, engine="auto")
    q = ("SELECT grp, SUM(v) AS s FROM fact, dim WHERE fk = k"
         " GROUP BY grp ORDER BY grp")
    h1 = on.execute_async(q)
    r1 = h1.result().fetchall()
    on.execute("INSERT INTO fact VALUES (0, 100000)")
    r2 = on.execute(q).fetchall()
    assert r1 != r2  # the insert must be visible to the second run
    on.close()


# ===========================================================================
# serving result cache
# ===========================================================================
def test_result_cache_invalidated_on_write(conn):
    q = "SELECT SUM(v) AS s FROM fact"
    first = conn.execute(q).fetchall()
    again = conn.execute(q).fetchall()
    assert first == again
    assert conn.server_stats()["result_cache"]["hits"] >= 1
    conn.execute("INSERT INTO fact VALUES (1, 123456)")
    bumped = conn.execute(q).fetchall()
    assert bumped[0][0] == first[0][0] + 123456


def test_result_cache_byte_bound_lrfu_eviction(tmp_path):
    from repro_torch.core.serving import ResultCacheServer
    from repro_torch.core.session import Warehouse

    wh = Warehouse(str(tmp_path / "wh"), result_cache_bytes=2 << 10)
    assert isinstance(wh.result_cache, ResultCacheServer)
    s = wh.session(engine="auto")
    s.execute("CREATE TABLE t (a INT)")
    s.execute("INSERT INTO t VALUES " +
              ", ".join(f"({i})" for i in range(400)))
    # each distinct window caches a ~480-byte result; ten of them overflow
    # the 2 KiB budget, forcing LRFU victims out
    for lo in range(0, 300, 30):
        s.execute(f"SELECT a FROM t WHERE a >= {lo} AND a < {lo + 60}")
    stats = wh.result_cache.stats_snapshot()
    assert stats["evictions"] > 0
    assert stats["bytes_used"] <= 2 << 10
    wh.close()


def test_cache_hit_served_without_admission(conn):
    """With the only pool slot occupied by a slow query, a repeated
    (cached) query completes without ever taking a WLM slot."""
    wh = conn.warehouse
    s = conn.session
    q = "SELECT SUM(v) AS s FROM fact"
    warm = conn.execute(q).fetchall()  # fill the cache pre-plan
    for ddl in [
        "CREATE RESOURCE PLAN serve",
        "CREATE POOL serve.only WITH alloc_fraction=1.0,"
        " query_parallelism=1",
        "ALTER PLAN serve SET DEFAULT POOL = only",
        "ALTER RESOURCE PLAN serve ENABLE ACTIVATE",
    ]:
        s.execute(ddl)
    slow_conn = db.connect(warehouse=wh, result_cache=False,
                           **{"debug_vertex_delay_s": 0.5}, engine="auto")
    slow = slow_conn.execute_async(
        "SELECT grp, SUM(v) AS s FROM fact, dim WHERE fk = k GROUP BY grp")
    wait_for(lambda: wh.wlm.queue_depths().get("only", 0) == 0
             and slow.poll()["state"] in ("ADMITTED", "RUNNING"),
             what="slow query to occupy the pool")
    h = conn.execute_async(q)
    res = h.result(timeout=5).fetchall()  # must NOT queue behind `slow`
    assert res == warm
    assert h.info.get("admission_skipped") is True
    assert h.info.get("cache_hit") is True
    slow.result(timeout=30)
    slow_conn.close()


# ===========================================================================
# sharded admission
# ===========================================================================
def test_sharded_admission_stress_no_lost_wakeups(conn):
    """Many more async queries than slots across two pools: every one is
    eventually admitted and completes (no lost wakeups across shards)."""
    s = conn.session
    for ddl in [
        "CREATE RESOURCE PLAN shard",
        "CREATE POOL shard.a WITH alloc_fraction=0.5, query_parallelism=2",
        "CREATE POOL shard.b WITH alloc_fraction=0.5, query_parallelism=2",
        "CREATE USER MAPPING ua IN shard TO a",
        "CREATE USER MAPPING ub IN shard TO b",
        "ALTER PLAN shard SET DEFAULT POOL = a",
        "ALTER RESOURCE PLAN shard ENABLE ACTIVATE",
    ]:
        s.execute(ddl)
    wh = conn.warehouse
    conns = [db.connect(warehouse=wh, user=u, result_cache=False, engine="auto")
             for u in ("ua", "ub") for _ in range(2)]
    handles = []
    for i in range(40):
        c = conns[i % len(conns)]
        handles.append(c.execute_async(
            f"SELECT COUNT(*) AS n FROM fact WHERE v >= {i % 3}"))
    for h in handles:
        assert h.result(timeout=60).fetchall()[0][0] > 0
    assert all(d == 0 for d in wh.wlm.queue_depths().values())
    for c in conns:
        c.close()


def test_kill_trigger_fires_with_sharded_admission(conn):
    s = conn.session
    for ddl in [
        "CREATE RESOURCE PLAN reap",
        "CREATE POOL reap.p WITH alloc_fraction=1.0, query_parallelism=4",
        "ALTER PLAN reap SET DEFAULT POOL = p",
        "ALTER RESOURCE PLAN reap ENABLE ACTIVATE",
    ]:
        s.execute(ddl)
    wlm = conn.warehouse.wlm
    wlm.create_rule("reap", "reaper", "rows_produced", 100, "kill", None)
    wlm.activate("reap")
    slot = wlm.admit("qk")
    with pytest.raises(QueryKilledError):
        wlm.update_metrics("qk", rows_produced=1000)
    assert slot.killed
    wlm.release("qk")


# ===========================================================================
# DROP TABLE racing an in-flight scan
# ===========================================================================
def test_drop_table_during_scan_fails_cleanly_or_completes(conn):
    """DROP TABLE while a scan of the same table streams: the query either
    completes on its snapshot or fails with the explicit dropped-during-scan
    error — never a partial result or a bare file error."""
    wh = conn.warehouse
    total = conn.execute("SELECT COUNT(*) AS n FROM fact").fetchall()[0][0]
    slow = db.connect(warehouse=wh, result_cache=False,
                      **{"serving.shared_scans": False,
                         "debug_vertex_delay_s": 0.3}, engine="auto")
    h = slow.execute_async(
        "SELECT grp, COUNT(v) AS c FROM fact, dim WHERE fk = k GROUP BY grp")
    wait_for(lambda: h.poll()["state"] == "RUNNING",
             what="scan to start")
    conn.execute("DROP TABLE fact")
    try:
        rows = h.result(timeout=30).fetchall()
    except db.Error as exc:
        assert "dropped during" in str(exc) or "fact" in str(exc)
    else:
        # completed on its snapshot: counts must cover every fact row
        assert sum(c for _, c in rows) == total
    slow.close()


def test_drop_table_invalidates_shared_scan_registry(conn):
    wh = conn.warehouse
    wh.shared_scans.publish(("key",), "dim", object())
    conn.execute("DROP TABLE dim")
    assert wh.shared_scans.attach(("key",)) is None
    assert wh.serving_stats()["shared_scans"]["invalidated"] >= 1


# ===========================================================================
# concurrency smoke (CI runs this with the SIGALRM deadlock guard)
# ===========================================================================
def test_concurrency_smoke_32_clients(tmp_path):
    """32 concurrent clients, seeded mixed repeated/unique workload:
    everything completes, with nonzero shared-scan and result-cache hits."""
    from repro_torch.core.session import Warehouse

    wh = Warehouse(str(tmp_path / "wh"), query_workers=32)
    base = db.connect(warehouse=wh, engine="auto")
    cur = base.cursor()
    cur.execute("CREATE TABLE d (k INT, yr INT, w DOUBLE)")
    cur.execute("INSERT INTO d VALUES " +
                ", ".join(f"({i}, {1992 + i % 6}, {i * 0.5})"
                          for i in range(48)))
    cur.execute("CREATE TABLE f (fk INT, rev INT)")
    rng = np.random.default_rng(3)
    fk = rng.integers(0, 48, 6000)
    rev = rng.integers(1, 500, 6000)
    cur.execute("INSERT INTO f VALUES " + ", ".join(
        f"({int(a)}, {int(b)})" for a, b in zip(fk, rev)))

    repeated = ["SELECT yr, SUM(rev) AS s FROM f, d WHERE fk = k GROUP BY yr",
                "SELECT COUNT(*) AS n FROM f"]

    def unique_sql(cid, j):
        # unique filters live on non-join-key dim columns: each query is
        # distinct (no result-cache absorption) and no predicate transits
        # onto the fact side, so the fact-scan vertex key stays identical
        # and overlapping executions attach to each other's scans
        n = cid * 4 + j
        return (f"SELECT yr, SUM(rev) AS s FROM f, d WHERE fk = k"
                f" AND yr >= {1992 + n % 5} AND w >= {n * 0.01:.2f}"
                f" GROUP BY yr")

    errors = []

    def client(cid):
        try:
            c = db.connect(warehouse=wh, semijoin_reduction=False,
                           **{"debug_vertex_delay_s": 0.05}, engine="auto")
            r = np.random.default_rng(cid)
            for j in range(4):
                if r.uniform() < 0.5:
                    sql = repeated[int(r.integers(len(repeated)))]
                else:
                    sql = unique_sql(cid, j)
                rows = c.execute(sql).fetchall()
                assert rows
        except Exception as exc:  # noqa: BLE001 - surfaced below
            errors.append((cid, exc))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(32)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "client threads deadlocked"
    assert not errors, errors[:3]
    stats = wh.serving_stats()
    assert stats["result_cache"]["hits"] > 0
    assert stats["shared_scans"]["attached"] > 0
    base.close()
    wh.close()
