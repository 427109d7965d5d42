"""The readers of the program's spans (``metrics/_spans.py`` and the five
metrics on it) on hand-built Chrome traces: nesting, self time, a query
with no such span, a trace from a program without these spans, and no
traced record at all."""
from types import SimpleNamespace

import pytest

from warehouse_bench.cell import reader
from warehouse_bench.metrics import _spans


def trace(*spans, t0_s=100.0):
    """A query's Chrome trace of ``(name, tid, begin_us, end_us, args)``
    spans, its B/E events sorted as the program sorts them."""
    events = []
    for name, tid, b, e, args in spans:
        events.append(((b, 1, b - e), {"ph": "B", "ts": b, "tid": tid,
                                       "pid": 1, "name": name,
                                       "args": args}))
        events.append(((e, 0, e - b), {"ph": "E", "ts": e, "tid": tid,
                                       "pid": 1, "name": name}))
    events.sort(key=lambda pair: pair[0])
    other = {"qid": "q1"} if t0_s is None else {"qid": "q1", "t0_s": t0_s}
    return {"traceEvents": [{"ph": "M", "ts": 0, "pid": 1, "tid": 0,
                             "name": "process_name"}]
            + [ev for _k, ev in events], "otherData": other}


def obs(*traces):
    return {"records": [SimpleNamespace(trace=t) for t in traces]}


# a power query: two key_lookup probes (one through the kernel, one on the
# host path), a bloom probe, a filter kernel outside any probe, on two
# vertex threads beside the pipeline's (tid 1)
POWER = trace(
    ("stage:parse", 1, 0, 1000, {"cpu_ms": 0.9}),
    ("stage:optimize", 1, 1000, 5000, {"cpu_ms": 2.5}),
    ("stage:execute", 1, 5000, 20000, {"cpu_ms": 1.0}),
    ("probe:key_lookup", 2, 6000, 7000, {"path": "kernel", "cpu_ms": 0.5}),
    ("kernel:key_lookup", 2, 6200, 6800, {"rows": 1024, "cpu_ms": 0.1}),
    ("probe:key_lookup", 2, 7000, 7400, {"path": "host", "cpu_ms": 0.4}),
    ("probe:bloom_probe", 3, 6000, 9000, {"cpu_ms": 2.0}),
    ("kernel:bloom_probe", 3, 8000, 8500, {"rows": 8192, "cpu_ms": 0.2}),
    ("kernel:filter_eval", 3, 9500, 9800, {"rows": 1024, "cpu_ms": 0.1}),
)
# a repeat that waited 300 ms on the filler's pending entry, inside its
# cache probe, and a query that did not wait
WAITER = trace(
    ("stage:parse", 1, 0, 2000, {"cpu_ms": 1.0}),
    ("stage:cache_probe", 1, 2000, 303000, {"cpu_ms": 0.5}),
    ("cache:pending_wait", 1, 2500, 302500, {"cpu_ms": 0.1}),
    ("stage:execute", 1, 303000, 303000, {"cpu_ms": 0.0}),
)
PLAIN = trace(("stage:parse", 1, 0, 1000, {"cpu_ms": 0.25}),
              ("stage:bind", 1, 1000, 3000, {"cpu_ms": 1.75}))
# the parent program's trace: stage spans without cpu_ms, no clock stated
OLD = trace(("stage:parse", 1, 0, 1000, {}),
            ("stage:execute", 1, 1000, 9000, {}), t0_s=None)


def test_spans_pair_by_tid_and_nest():
    spans = _spans.spans(POWER)
    assert len(spans) == 9
    by_name = {}
    for i, s in enumerate(spans):
        by_name.setdefault(s.name, []).append(i)
    (k,) = by_name["kernel:key_lookup"]
    assert spans[spans[k].parent].name == "probe:key_lookup"
    assert spans[spans[k].parent].args["path"] == "kernel"
    (f,) = by_name["kernel:filter_eval"]
    assert spans[f].parent is None
    assert _spans.enclosing(spans, f, "probe:") is None
    (b,) = by_name["kernel:bloom_probe"]
    assert spans[_spans.enclosing(spans, b, "probe:")].tid == 3
    assert spans[b].ms == pytest.approx(0.5)


def test_kernel_trip_ms():
    read = reader("kernel_trip_ms.power")
    assert read(obs(POWER)) == pytest.approx(0.6 + 0.5 + 0.3)
    # a query with no kernel call adds 0 to the mean
    assert read(obs(POWER, PLAIN)) == pytest.approx(1.4 / 2)
    assert read(obs(PLAIN)) is None
    assert read(obs(OLD)) is None


def test_probe_self_ms_counts_host_path_lookups():
    read = reader("probe_self_ms.power")
    # (1.0 - 0.6) + 0.4 (host path, no kernel) + (3.0 - 0.5)
    assert read(obs(POWER)) == pytest.approx(0.4 + 0.4 + 2.5)
    assert read(obs(POWER, PLAIN)) == pytest.approx(3.3 / 2)
    assert read(obs(PLAIN)) is None


def test_cache_wait_ms():
    read = reader("cache_wait_ms.dash")
    assert read(obs(WAITER)) == pytest.approx(300.0)
    assert read(obs(WAITER, PLAIN, POWER)) == pytest.approx(100.0)
    assert read(obs(PLAIN)) == 0.0
    # a program that records no such wait: nothing to read
    assert read(obs(OLD)) is None


def test_plan_offcpu_ms_leaves_out_execute_and_the_cache_wait():
    for name in ("plan_offcpu_ms.power", "plan_offcpu_ms.dash"):
        read = reader(name)
        # parse 1.0 - 0.9, optimize 4.0 - 2.5; execute left out
        assert read(obs(POWER)) == pytest.approx(0.1 + 1.5)
        # parse 2.0 - 1.0; cache_probe (301.0 - 0.5) less the wait's
        # (300.0 - 0.1)
        assert read(obs(WAITER)) == pytest.approx(1.0 + 0.6)
        assert read(obs(WAITER, PLAIN)) == pytest.approx(
            (1.6 + 0.75 + 0.25) / 2)
        assert read(obs(OLD)) is None


@pytest.mark.parametrize("name", ["kernel_trip_ms.power",
                                  "probe_self_ms.power", "cache_wait_ms.dash",
                                  "plan_offcpu_ms.power",
                                  "plan_offcpu_ms.dash"])
def test_nothing_traced_reads_none(name):
    read = reader(name)
    assert read({"records": []}) is None
    assert read(obs(None, None)) is None
