"""Spans inside the port's per-query trace: each kernel call, each join and
runtime-filter probe, the result cache's wait on a pending entry, each
exchange wait, every live span's CPU time, and the clock the export
counts from.

Under ``engine: ref`` the kernels' plain versions run on the CPU through
the same ``registry.host_call`` as on the card; under ``auto`` the executor
takes its numpy host paths and calls no kernel.
"""
import threading
import time

import numpy as np
import pytest

import repro_torch.api as db
from repro_torch.analysis.trace_check import validate_chrome_trace
from repro_torch.core.obs import trace as trace_mod
from repro_torch.core.obs.trace import (EXCHANGE_WAIT, NOOP_SPAN, QueryTrace,
                                        bind_trace, current_trace, make_span,
                                        restore_trace, vertex_phase)
from repro_torch.kernels import registry

ENGINES = ("ref", "auto")
TRACED = {"obs.tracing": True}
# a star join whose dimension filter gives the fact scan a runtime filter
# (bloom_probe under ref) and whose join probes go through key_lookup
JOIN = ("SELECT grp, SUM(v) FROM fact, dim WHERE fk = k AND grp < 3 "
        "GROUP BY grp ORDER BY grp")
# the same join on keys above 2**24, which float32 does not hold exactly
BIG_JOIN = ("SELECT grp, SUM(v) FROM fact, dim WHERE bk = big "
            "GROUP BY grp ORDER BY grp")


def _load(conn):
    conn.execute("CREATE TABLE dim (k BIGINT, grp BIGINT, big BIGINT)")
    conn.execute("CREATE TABLE fact (fk BIGINT, v DOUBLE, bk BIGINT)")
    conn.execute("INSERT INTO dim VALUES " + ", ".join(
        f"({i}, {i % 5}, {2**24 + 3 + 7 * i})" for i in range(200)))
    conn.execute("INSERT INTO fact VALUES " + ", ".join(
        f"({i % 300}, {i * 0.5}, {2**24 + 3 + 7 * (i % 300)})"
        for i in range(5000)))


@pytest.fixture()
def wh_dir(tmp_path):
    return str(tmp_path / "wh")


def _spans(data):
    """(name, tid, begin, end, args, parents) of every B/E pair, parents
    being the names of the spans open around it on its tid."""
    out, stacks = [], {}
    for ev in data["traceEvents"]:
        stack = stacks.setdefault(ev["tid"], [])
        if ev["ph"] == "B":
            stack.append(ev)
        elif ev["ph"] == "E":
            b = stack.pop()
            assert b["name"] == ev["name"]
            out.append((b["name"], ev["tid"], b["ts"], ev["ts"],
                        b.get("args", {}), [p["name"] for p in stack]))
    return out


def _traced_run(wh_dir, engine, sql, **cfg):
    with db.connect(wh_dir, engine=engine, result_cache=False, **TRACED,
                    **cfg) as conn:
        _load(conn)
        h = conn.execute_async(sql)
        h.result()
        return h.trace(), h._task.trace


# ===========================================================================
# tracing off
# ===========================================================================
@pytest.mark.parametrize("engine", ENGINES)
def test_untraced_host_call_is_the_plain_call(engine):
    fn = registry.resolve("key_lookup", engine)
    device = registry.engine_device(engine)
    assert current_trace() is None
    call = registry.host_call(fn, device)
    assert call.__name__ == "on_host" and not hasattr(call, "__wrapped__")
    prev = bind_trace(QueryTrace("q1"))
    try:
        traced = registry.host_call(fn, device)
    finally:
        restore_trace(prev)
    assert traced.__wrapped__.__name__ == "on_host"
    assert current_trace() is None


@pytest.mark.parametrize("engine", ENGINES)
def test_untraced_query_allocates_no_span(wh_dir, engine, monkeypatch):
    made = []
    real = trace_mod._Span.__init__

    def counting(self, *a, **kw):
        made.append(a)
        real(self, *a, **kw)

    monkeypatch.setattr(trace_mod._Span, "__init__", counting)
    assert make_span(None, "probe:key_lookup", "probe") is NOOP_SPAN
    assert vertex_phase(EXCHANGE_WAIT) is NOOP_SPAN
    with db.connect(wh_dir, engine=engine, result_cache=False) as conn:
        _load(conn)
        made.clear()
        # the sync session runs the pipeline on this thread
        rows = conn.session.execute(JOIN).batch.num_rows
        conn.execute(BIG_JOIN).fetchall()
    assert rows == 3
    assert made == []
    assert current_trace() is None


# ===========================================================================
# kernel and probe spans
# ===========================================================================
@pytest.mark.parametrize("engine", ENGINES)
def test_kernel_spans_lie_in_probe_spans(wh_dir, engine):
    data, trace = _traced_run(wh_dir, engine, JOIN)
    assert validate_chrome_trace(data) == []
    spans = _spans(data)
    dispatches = trace.summary()["kernel_dispatches"]
    probes = [s for s in spans if s[0].startswith("probe:")]
    assert any(s[0] == "probe:key_lookup" for s in probes)
    for kernel in ("key_lookup", "bloom_probe"):
        calls = [s for s in spans if s[0] == f"kernel:{kernel}"]
        assert len(calls) == dispatches.get(f"{kernel}[{engine}]", 0)
        for name, tid, b, e, args, parents in calls:
            assert parents and parents[-1] == f"probe:{kernel}"
            assert args["rows"] > 0 and args["cpu_ms"] >= 0
            assert any(p[1] == tid and p[2] <= b and e <= p[3]
                       for p in probes)
    if engine == "ref":
        assert dispatches.get("key_lookup[ref]", 0) > 0
        assert dispatches.get("bloom_probe[ref]", 0) > 0
        paths = {s[4]["path"] for s in probes if s[0] == "probe:key_lookup"}
        assert paths == {"kernel"}
    else:
        assert not any(s[0].startswith("kernel:") for s in spans)


@pytest.mark.parametrize("engine", ENGINES)
def test_keys_above_float32_take_the_host_path(wh_dir, engine):
    data, trace = _traced_run(wh_dir, engine, BIG_JOIN)
    spans = _spans(data)
    lookups = [s for s in spans if s[0] == "probe:key_lookup"]
    assert lookups and all(s[4]["path"] == "host" for s in lookups)
    assert not any(s[0] == "kernel:key_lookup" for s in spans)
    assert "key_lookup[ref]" not in trace.summary()["kernel_dispatches"]


# ===========================================================================
# the result cache's pending wait
# ===========================================================================
@pytest.mark.parametrize("engine", ENGINES)
def test_repeats_of_a_statement_in_flight_wait_in_cache_probe(wh_dir,
                                                               engine):
    with db.connect(wh_dir, engine=engine, **TRACED,
                    debug_vertex_delay_s=0.3) as filler:
        _load(filler)
        wh = filler.warehouse
        waits0 = filler.metrics()["counters"].get(
            "serving.result_cache.pending_waits", 0)
        h = filler.execute_async(JOIN)
        deadline = time.monotonic() + 30
        # vertices exist once the filler passed its cache probe, where it
        # installed the pending entry the others wait on
        while h.poll()["vertices_total"] == 0:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        conns = [db.connect(warehouse=wh, engine=engine, **TRACED)
                 for _ in range(3)]
        try:
            waiters = [c.execute_async(JOIN) for c in conns]
            want = h.result().fetchall()
            for w in waiters:
                assert w.result().fetchall() == want
                assert w.result().info["cache_hit"] is True
            traces = [w.trace() for w in waiters]
        finally:
            for c in conns:
                c.close()
        waits = filler.metrics()["counters"][
            "serving.result_cache.pending_waits"] - waits0
        filler_trace = h.trace()
    assert not any(s[0] == "cache:pending_wait"
                   for s in _spans(filler_trace))
    count = 0
    for data in traces:
        assert validate_chrome_trace(data) == []
        mine = [s for s in _spans(data) if s[0] == "cache:pending_wait"]
        assert len(mine) == 1
        assert mine[0][5][-1] == "stage:cache_probe"
        count += len(mine)
    assert count == waits == 3


# ===========================================================================
# CPU time, the stated clock, exchange waits
# ===========================================================================
def test_span_cpu_time_excludes_sleep():
    tr = QueryTrace("q1")
    with tr.span("sleep", "test"):
        time.sleep(0.05)
    ((name, _tid, b, e, args, _parents),) = _spans(tr.to_chrome())
    assert name == "sleep"
    assert args["cpu_ms"] < 10
    assert e - b >= 50_000


@pytest.mark.parametrize("engine", ENGINES)
def test_clock_stated_and_exchange_waits_inside_vertices(wh_dir, engine):
    data, trace = _traced_run(wh_dir, engine, JOIN,
                              debug_vertex_delay_s=0.05)
    assert validate_chrome_trace(data) == []
    assert data["otherData"]["t0_s"] == trace.t0
    spans = _spans(data)
    names = {s[0] for s in spans}
    assert not any(n.endswith((":compute", ":exchange-wait", ":spill-io"))
                   for n in names)
    assert not any(ev.get("cat") in ("vertex-phase", "kernel")
                   for ev in data["traceEvents"] if ev["ph"] == "i")
    vertices = [(s[2], s[3]) for s in spans if s[0].startswith("vertex:")]
    stage_tids = {s[1] for s in spans if s[0].startswith("stage:")}
    waits = [s for s in spans if s[0] == EXCHANGE_WAIT]
    assert waits and vertices
    for _name, tid, b, e, args, _parents in waits:
        assert tid not in stage_tids
        assert any(vb <= b and e <= ve for vb, ve in vertices)
    # the vertex records' wait totals are the waits' own seconds
    total = sum(v["exchange_wait_s"] for v in trace.vertices.values())
    assert total * 1e6 == pytest.approx(
        sum(e - b for _n, _t, b, e, _a, _p in waits), abs=5 * len(waits))


def test_vertex_frame_binds_and_restores_the_trace():
    outer, inner = QueryTrace("q1"), QueryTrace("q2")
    seen, charged = [], []

    def vertex():
        frame = trace_mod.open_vertex_frame(inner)
        try:
            seen.append(current_trace())
            with vertex_phase(EXCHANGE_WAIT):
                time.sleep(0.01)
        finally:
            trace_mod.close_vertex_frame(frame)
        seen.append(current_trace())
        charged.append(frame.wait_s)

    prev = bind_trace(outer)
    try:
        t = threading.Thread(target=vertex)
        t.start()
        t.join()
        assert current_trace() is outer
        vertex()
        assert current_trace() is outer
    finally:
        restore_trace(prev)
    assert seen == [inner, None, inner, outer]
    waits = [s for s in _spans(inner.to_chrome()) if s[0] == EXCHANGE_WAIT]
    assert len(waits) == 2 and all(e - b >= 10_000
                                   for _n, _t, b, e, _a, _p in waits)
    assert np.allclose(sorted(charged),
                       sorted((e - b) / 1e6 for _n, _t, b, e, _a, _p in waits),
                       atol=1e-8)
