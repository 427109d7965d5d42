"""Observability layer: per-query tracing, the warehouse metrics
registry, the always-on query log, and the trace-backed EXPLAIN ANALYZE.

Covers the acceptance contract of the obs subsystem:

  * tracing off is *free*: hot-path helpers return the shared NOOP_SPAN
    singleton (identity-checked — zero span allocations) and queries carry
    no QueryTrace;
  * tracing on records one span per pipeline stage and one vertex record
    per DAG vertex, with monotone timestamps and proper nesting;
  * the Chrome export validates (ph/ts/pid/tid present, B/E balanced,
    per-tid monotone) through ``repro_torch.analysis.trace_check``;
  * ``poll()`` / ``server_stats()`` keep their historical dict shapes but
    now derive from the MetricsRegistry;
  * the query log is a bounded ring (oldest evicts first);
  * cache-served results report the same ``stage_times_ms`` keys as
    executed ones (satellite a).
"""
import glob
import json
import os

import numpy as np
import pytest

import repro_torch.api as db
from repro_torch.analysis.trace_check import validate_chrome_trace
from repro_torch.core.obs import (NOOP_SPAN, MetricsRegistry, QueryLog, QueryTrace,
                            emit_event, make_span, tracing_enabled)

TRACED = {"obs.tracing": True}


@pytest.fixture()
def wh_dir(tmp_path):
    return str(tmp_path / "wh")


def _load_events(conn):
    conn.execute("CREATE TABLE ev (k BIGINT, grp BIGINT, val DOUBLE)")
    conn.execute(
        "INSERT INTO ev VALUES " + ", ".join(
            f"({i}, {i % 7}, {float(i) / 3:.4f})" for i in range(300)))


# ===========================================================================
# tracing off: no allocations, no traces
# ===========================================================================
class TestTracingOff:
    def test_make_span_returns_noop_singleton(self):
        s1 = make_span(None, "stage:parse", "stage")
        s2 = make_span(None, "vertex:v1", "vertex")
        assert s1 is NOOP_SPAN and s2 is NOOP_SPAN

    def test_emit_event_is_noop_without_trace(self):
        emit_event(None, "adaptive:skew", "adaptive", vid="v1")  # no raise

    def test_tracing_enabled_resolution(self, monkeypatch):
        monkeypatch.delenv("REPRO_OBS_TRACING", raising=False)
        assert tracing_enabled({"obs.tracing": False}) is False
        assert tracing_enabled({"obs.tracing": True}) is True
        monkeypatch.setenv("REPRO_OBS_TRACING", "1")
        assert tracing_enabled({"obs.tracing": False}) is True
        monkeypatch.setenv("REPRO_OBS_TRACING", "0")
        assert tracing_enabled({"obs.tracing": False}) is False

    def test_untraced_query_allocates_no_trace(self, wh_dir):
        with db.connect(wh_dir, engine="auto") as conn:
            _load_events(conn)
            h = conn.execute_async("SELECT grp, SUM(val) FROM ev GROUP BY grp")
            h.result()
            assert h._task.trace is None
            with pytest.raises(RuntimeError, match="tracing off"):
                h.trace()

    def test_query_log_records_even_untraced(self, wh_dir):
        with db.connect(wh_dir, engine="auto") as conn:
            _load_events(conn)
            conn.execute("SELECT COUNT(*) FROM ev").fetchall()
            log = conn.query_log()
            assert log, "query log must be always-on"
            assert {"qid", "sql", "status", "wall_ms"} <= set(log[-1])
            assert log[-1]["status"] == "SUCCEEDED"


# ===========================================================================
# tracing on: spans, vertices, Chrome export
# ===========================================================================
class TestTracedQuery:
    def test_stage_spans_and_vertex_records(self, wh_dir):
        # engine="ref": aggregate kernels only route when engine != auto
        with db.connect(wh_dir, engine="ref", **TRACED) as conn:
            _load_events(conn)
            h = conn.execute_async(
                "SELECT grp, SUM(k), COUNT(*) FROM ev "
                "WHERE k > 10 GROUP BY grp")
            h.result()
            trace = h._task.trace
            assert trace is not None
            summ = trace.summary()
            # every pipeline stage that ran shows up as a stage span
            for stage in ("parse", "bind", "optimize", "compile", "execute"):
                assert stage in summ["stages_ms"], summ["stages_ms"]
            # one vertex record per DAG vertex, wall split into sub-phases
            done = h.poll()
            assert len(summ["vertices"]) == done["vertices_total"]
            for vid, v in summ["vertices"].items():
                total = v["total_ms"]
                parts = (v["compute_ms"] + v["exchange_wait_ms"]
                         + v["spill_io_ms"])
                assert total >= 0 and parts <= total + 0.01, (vid, v)
            assert summ["kernel_dispatches"], "kernels must be counted"

    def test_chrome_export_validates(self, wh_dir):
        with db.connect(wh_dir, **TRACED, engine="auto") as conn:
            _load_events(conn)
            h = conn.execute_async(
                "SELECT grp, AVG(val) FROM ev GROUP BY grp")
            h.result()
            data = h.trace()
            assert validate_chrome_trace(data) == []
            events = data["traceEvents"]
            # balanced B/E with monotone, non-negative timestamps per tid
            opens = {}
            for ev in events:
                assert {"ph", "ts", "pid", "tid", "name"} <= set(ev)
                if ev["ph"] == "B":
                    opens.setdefault(ev["tid"], []).append(ev)
                elif ev["ph"] == "E":
                    assert opens[ev["tid"]], "E without open B"
                    b = opens[ev["tid"]].pop()
                    assert ev["ts"] >= b["ts"] >= 0
            assert all(not stack for stack in opens.values())

    def test_export_trace_roundtrip(self, wh_dir, tmp_path):
        with db.connect(wh_dir, **TRACED, engine="auto") as conn:
            _load_events(conn)
            h = conn.execute_async("SELECT COUNT(*) FROM ev")
            h.result()
            path = str(tmp_path / "trace.json")
            assert conn.export_trace(h.query_id, path) == path
            with open(path) as f:
                assert validate_chrome_trace(json.load(f)) == []
            with pytest.raises(KeyError):
                conn.export_trace("q999999", str(tmp_path / "x.json"))

    def test_stage_spans_nest_and_order(self):
        tr = QueryTrace("q1", "SELECT 1")
        with tr.span("stage:execute", "stage"):
            with tr.span("wlm:admission_wait", "wlm"):
                pass
        data = tr.to_chrome()
        rows = [(e["ph"], e["name"], e["ts"]) for e in data["traceEvents"]
                if e["ph"] in "BE"]
        names = [r[1] for r in rows]
        # inner span closes before the outer one
        assert names.index("wlm:admission_wait") \
            < names.index("stage:execute", 1) \
            or names == ["stage:execute", "wlm:admission_wait",
                         "wlm:admission_wait", "stage:execute"]
        ts = [r[2] for r in rows]
        assert ts == sorted(ts)


# ===========================================================================
# metrics registry as the single stats source
# ===========================================================================
class TestMetrics:
    def test_registry_primitives(self):
        reg = MetricsRegistry()
        reg.counter("c").inc()
        reg.inc("c", 2)
        reg.gauge("g", lambda: {"pool": 3})
        reg.observe("h_ms", 12.5)
        snap = reg.snapshot()
        assert snap["counters"]["c"] == 3
        assert snap["gauges"]["g"] == {"pool": 3}
        assert snap["histograms"]["h_ms"]["count"] == 1

    def test_serving_stats_shape_preserved_and_registry_backed(self, wh_dir):
        with db.connect(wh_dir, engine="auto") as conn:
            _load_events(conn)
            sql = "SELECT grp, COUNT(*) FROM ev GROUP BY grp"
            conn.execute(sql).fetchall()
            conn.execute(sql).fetchall()
            stats = conn.server_stats()
            # historical shape
            assert {"result_cache", "shared_scans",
                    "admission_queues"} <= set(stats)
            rc = stats["result_cache"]
            assert {"hits", "misses", "evictions", "fills"} <= set(rc)
            assert rc["hits"] >= 1
            # same numbers flow from the registry snapshot
            counters = conn.metrics()["counters"]
            assert counters["serving.result_cache.hits"] == rc["hits"]
            assert counters["serving.result_cache.misses"] == rc["misses"]
            sc = stats["shared_scans"]
            assert counters["serving.shared_scans.published"] \
                == sc["published"]

    def test_wlm_counters_in_registry(self, wh_dir):
        with db.connect(wh_dir, engine="auto") as conn:
            _load_events(conn)
            for ddl in ("CREATE RESOURCE PLAN obsplan",
                        "CREATE POOL obsplan.bi WITH alloc_fraction=1.0, "
                        "query_parallelism=4",
                        "ALTER PLAN obsplan SET DEFAULT POOL = bi",
                        "ALTER RESOURCE PLAN obsplan ENABLE ACTIVATE"):
                conn.execute(ddl)
            conn.execute_async("SELECT COUNT(*) FROM ev").result()
            m = conn.metrics()
            assert m["counters"].get("wlm.admitted", 0) >= 1
            assert "wlm.queue_depths" in m["gauges"]

    def test_kernel_dispatch_counts_surface(self, wh_dir):
        with db.connect(wh_dir, engine="ref") as conn:
            _load_events(conn)
            conn.execute("SELECT grp, SUM(k) FROM ev GROUP BY grp")
            m = conn.metrics()
            assert any(k.startswith("kernels.dispatch.")
                       for k in m["counters"])

    def test_query_outcome_counters(self, wh_dir):
        with db.connect(wh_dir, engine="auto") as conn:
            _load_events(conn)
            conn.execute("SELECT COUNT(*) FROM ev").fetchall()
            with pytest.raises(db.Error):
                conn.execute("SELECT nope FROM ev").fetchall()
            c = conn.metrics()["counters"]
            assert c.get("query.succeeded", 0) >= 1
            assert c.get("query.failed", 0) >= 1


# ===========================================================================
# query log ring
# ===========================================================================
class TestQueryLog:
    def test_ring_bounds_and_eviction(self):
        log = QueryLog(capacity=4)
        for i in range(10):
            log.record({"qid": f"q{i}"})
        assert len(log) == 4
        assert [e["qid"] for e in log.entries()] == ["q6", "q7", "q8", "q9"]
        assert [e["qid"] for e in log.entries(limit=2)] == ["q8", "q9"]

    def test_entries_are_copies(self):
        log = QueryLog(capacity=2)
        log.record({"qid": "q0"})
        log.entries()[0]["qid"] = "mutated"
        assert log.entries()[0]["qid"] == "q0"

    def test_failed_and_cancelled_logged(self, wh_dir):
        with db.connect(wh_dir, engine="auto") as conn:
            _load_events(conn)
            with pytest.raises(db.Error):
                conn.execute("SELECT nope FROM ev").fetchall()
            statuses = {e["status"] for e in conn.query_log()}
            assert "FAILED" in statuses
            failed = [e for e in conn.query_log()
                      if e["status"] == "FAILED"][-1]
            assert failed["error"]


# ===========================================================================
# satellite (a): cache-hit stage_times_ms parity
# ===========================================================================
class TestCacheHitStageParity:
    def test_same_keys_zeroed_post_probe(self, wh_dir):
        with db.connect(wh_dir, engine="auto") as conn:
            _load_events(conn)
            sql = "SELECT grp, MAX(val) FROM ev GROUP BY grp"
            miss = conn.execute(sql).info
            hit = conn.execute(sql).info
            assert hit["cache_hit"] is True
            assert hit.get("admission_skipped") is True
            assert set(hit["stage_times_ms"]) == set(miss["stage_times_ms"])
            assert hit["stage_times_ms"]["execute"] == 0.0
            assert hit["stage_times_ms"]["compile"] == 0.0
            assert hit["stage_times_ms"]["parse"] > 0.0


# ===========================================================================
# trace-backed EXPLAIN ANALYZE
# ===========================================================================
class TestExplainAnalyze:
    def test_vertex_breakdown_and_events(self, wh_dir):
        with db.connect(wh_dir, engine="ref") as conn:
            _load_events(conn)
            cur = conn.execute(
                "EXPLAIN ANALYZE SELECT grp, SUM(k) FROM ev "
                "WHERE k > 5 GROUP BY grp")
            text = "\n".join(r[0] for r in cur.fetchall())
            assert "stage timings:" in text
            assert "vertex breakdown:" in text
            assert "compute=" in text and "exchange_wait=" in text \
                and "spill_io=" in text
            assert "kernel dispatches:" in text

    def test_analyze_forces_tracing_without_session_flag(self, wh_dir):
        # session tracing off: ANALYZE still gets a trace-backed report
        with db.connect(wh_dir, engine="auto") as conn:
            _load_events(conn)
            cur = conn.execute("EXPLAIN ANALYZE SELECT COUNT(*) FROM ev")
            text = "\n".join(r[0] for r in cur.fetchall())
            assert "vertex breakdown:" in text
