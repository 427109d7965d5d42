"""Query results cache (§4.3), re-optimization (§4.2), workload mgmt (§5.2)."""
from _torch_core import warehouse, star_schema  # noqa: F401
import threading

import numpy as np
import pytest

from repro_torch.core.runtime.wlm import QueryKilledError


SQL = ("SELECT i_category, SUM(ss_price) s FROM store_sales, item"
       " WHERE ss_item_sk = i_item_sk GROUP BY i_category ORDER BY s DESC")


def test_cache_hit_and_snapshot_invalidation(star_schema):
    s = star_schema.session(engine="auto")
    r1 = s.execute(SQL)
    assert r1.info["cache_hit"] is False
    r2 = s.execute(SQL)
    assert r2.info["cache_hit"] is True
    assert r2.rows == r1.rows
    # any write to a participating table invalidates (WriteId snapshot moves)
    s.execute("INSERT INTO store_sales VALUES (1, 1, 1, 1, 5.0)")
    r3 = s.execute(SQL)
    assert r3.info["cache_hit"] is False


def test_unrelated_write_keeps_cache(star_schema):
    s = star_schema.session(engine="auto")
    s.execute(SQL)
    s.execute("CREATE TABLE unrelated (x INT)")
    s.execute("INSERT INTO unrelated VALUES (1)")
    r = s.execute(SQL)
    assert r.info["cache_hit"] is True


def test_pending_entry_thundering_herd(star_schema):
    """Concurrent identical queries: one fills, the rest wait (§4.3)."""
    results, hits = [], []
    barrier = threading.Barrier(4)

    def run():
        s = star_schema.session(engine="auto")
        barrier.wait()
        r = s.execute(SQL)
        results.append(tuple(map(tuple, r.rows)))
        hits.append(r.info.get("cache_hit"))

    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(set(results)) == 1
    assert star_schema.result_cache.stats["pending_waits"] >= 1 or \
        sum(1 for h in hits if h) >= 1


def test_reoptimize_on_memory_pressure(star_schema):
    s = star_schema.session(mapjoin_max_rows=10, reopt_mode="reoptimize",
                            result_cache=False, semijoin_reduction=False, engine="auto")
    r = s.execute(SQL)
    assert r.info.get("reexecuted") is True
    ref = star_schema.session(result_cache=False, mapjoin_max_rows=10**9, engine="auto").execute(SQL)
    assert [(a, round(b, 6)) for a, b in r.rows] == \
        [(a, round(b, 6)) for a, b in ref.rows]


def test_overlay_reexecution(star_schema):
    s = star_schema.session(mapjoin_max_rows=10, reopt_mode="overlay",
                            result_cache=False, semijoin_reduction=False, engine="auto")
    r = s.execute(SQL)
    assert r.info.get("reexecuted") is True
    assert r.info.get("reopt_mode") == "overlay"


def test_reopt_off_raises(star_schema):
    from repro_torch.core.runtime.exec import MemoryPressureError

    s = star_schema.session(mapjoin_max_rows=10, reopt_mode="off",
                            result_cache=False, semijoin_reduction=False, engine="auto")
    with pytest.raises(MemoryPressureError):
        s.execute(SQL)


def test_runtime_stats_persisted(star_schema):
    s = star_schema.session(result_cache=False, engine="auto")
    s.execute(SQL)
    rows = star_schema.hms._q("SELECT COUNT(*) FROM runtime_stats")
    assert rows[0][0] > 0  # feedback loop for the §9 roadmap item


WLM_DDL = [
    "CREATE RESOURCE PLAN daytime",
    "CREATE POOL daytime.bi WITH alloc_fraction=0.8, query_parallelism=5",
    "CREATE POOL daytime.etl WITH alloc_fraction=0.2, query_parallelism=20",
    "CREATE RULE downgrade IN daytime WHEN total_runtime > 3000 THEN MOVE etl",
    "ADD RULE downgrade TO bi",
    "CREATE APPLICATION MAPPING visualization_app IN daytime TO bi",
    "ALTER PLAN daytime SET DEFAULT POOL = etl",
    "ALTER RESOURCE PLAN daytime ENABLE ACTIVATE",
]


def test_wlm_paper_example(star_schema):
    s = star_schema.session(engine="auto")
    for ddl in WLM_DDL:
        s.execute(ddl)
    plan = star_schema.wlm.active_plan
    assert plan.name == "daytime"
    assert plan.pools["bi"].alloc_fraction == 0.8
    assert plan.pools["bi"].query_parallelism == 5
    assert plan.rules["downgrade"].pools == ["bi"]
    r = star_schema.session(application="visualization_app",
                            result_cache=False, engine="auto").execute(
        "SELECT COUNT(*) FROM item")
    assert r.info["wlm_pool"] == "bi"
    r = star_schema.session(result_cache=False, engine="auto").execute(
        "SELECT COUNT(*) FROM item")
    assert r.info["wlm_pool"] == "etl"


def test_wlm_trigger_moves_query(star_schema):
    s = star_schema.session(engine="auto")
    for ddl in WLM_DDL:
        s.execute(ddl)
    wlm = star_schema.wlm
    slot = wlm.admit("qq", application="visualization_app")
    assert slot.pool == "bi"
    slot.admitted_at -= 10  # simulate 10s elapsed
    wlm.update_metrics("qq", rows_produced=1)
    assert slot.pool == "etl" and slot.moves == ["bi->etl"]
    wlm.release("qq")


def test_wlm_kill_trigger(star_schema):
    s = star_schema.session(engine="auto")
    for ddl in WLM_DDL:
        s.execute(ddl)
    wlm = star_schema.wlm
    wlm.create_rule("daytime", "reaper", "rows_produced", 100, "kill", None)
    wlm.activate("daytime")
    slot = wlm.admit("qk")
    with pytest.raises(QueryKilledError):
        wlm.update_metrics("qk", rows_produced=1000)
    wlm.release("qk")


def test_wlm_idle_capacity_borrowing(star_schema):
    s = star_schema.session(engine="auto")
    for ddl in WLM_DDL:
        s.execute(ddl)
    wlm = star_schema.wlm
    slots = [wlm.admit(f"q{i}", application="visualization_app")
             for i in range(5)]
    extra = wlm.admit("q-extra", application="visualization_app")
    assert extra.borrowed_from == "etl"  # bi full; borrows idle etl capacity
    for i in range(5):
        wlm.release(f"q{i}")
    wlm.release("q-extra")


def test_wlm_cross_pool_borrow_round_robin(warehouse):
    """Queue heads from several pools contending for borrowed idle capacity
    are granted round-robin across pools, not in wakeup order."""
    import time

    s = warehouse.session(engine="auto")
    for ddl in [
        "CREATE RESOURCE PLAN rr",
        "CREATE POOL rr.a WITH alloc_fraction=0.3, query_parallelism=1",
        "CREATE POOL rr.b WITH alloc_fraction=0.3, query_parallelism=1",
        "CREATE POOL rr.spare WITH alloc_fraction=0.4, query_parallelism=1",
        "CREATE USER MAPPING ua IN rr TO a",
        "CREATE USER MAPPING ub IN rr TO b",
        "ALTER PLAN rr SET DEFAULT POOL = spare",
        "ALTER RESOURCE PLAN rr ENABLE ACTIVATE",
    ]:
        s.execute(ddl)
    wlm = warehouse.wlm
    # saturate every pool so all further admissions must queue
    wlm.admit("a0", user="ua")
    wlm.admit("b0", user="ub")
    wlm.admit("sp0")

    grants = []  # (qid, granted pool) in admission order
    done = threading.Semaphore(0)

    def waiter(qid, user):
        slot = wlm.wait_admit(qid, user=user, timeout=30)
        grants.append((qid, slot.pool))
        done.release()

    threads = [threading.Thread(target=waiter, args=(f"{p}{i}", f"u{p}"))
               for i in (1, 2) for p in ("a", "b")]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 10
    while not all(wlm.queue_depths().get(p, 0) == 2 for p in ("a", "b")):
        assert time.monotonic() < deadline, "admission queues never formed"
        time.sleep(0.01)

    # free the spare slot; each released borrower frees it again for the
    # next contending head -- grants must alternate a, b, a, b
    wlm.release("sp0")
    for k in range(4):
        assert done.acquire(timeout=10), f"grant {k} never arrived"
        qid, _pool = grants[k]
        wlm.release(qid)  # frees the borrowed spare capacity for the next
    for t in threads:
        t.join(timeout=10)
    assert [pool for _, pool in grants] == ["a", "b", "a", "b"]
    wlm.release("a0")
    wlm.release("b0")
