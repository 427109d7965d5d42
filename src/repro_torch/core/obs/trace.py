"""Structured per-query tracing (spans + point events, Chrome-exportable).

One :class:`QueryTrace` collects everything a single query does — pipeline
stages, the WLM admission wait, the result cache's wait on a pending
entry, every DAG vertex (split into compute vs. exchange-wait vs.
spill-I/O time), each exchange wait and spill I/O, each join probe and
runtime-filter probe, every kernel call, shuffle lanes, federated split
reads, serving-tier attach/hit and adaptive decisions — on one shared
clock (:mod:`.clock`), and exports the lot as Chrome trace-event JSON
(``QueryHandle.trace()`` / ``Connection.export_trace``) so a query renders
directly in Perfetto / ``chrome://tracing``.  Every live span also carries
its thread's CPU milliseconds (``cpu_ms``), so its wall time less that is
the time its thread spent off the CPU.

Hot-path discipline follows the lockdep factory pattern: tracing resolves
to a per-query ``trace`` object exactly once (``None`` when ``obs.tracing``
is off), every instrumentation site pays a single ``is not None`` attribute
test, and :func:`make_span` returns the module-level :data:`NOOP_SPAN`
singleton when tracing is off — no span objects are ever allocated on the
morsel path.

The thread-local :func:`current_trace` is the trace of the query whose work
a thread runs: the pipeline binds it on the thread that runs the stages
(:func:`bind_trace` / :func:`restore_trace`) and the DAG scheduler on each
vertex's executor thread (:func:`open_vertex_frame`); it stays ``None``
with tracing off.  Code with no query context at hand — the kernel
registry's ``host_call``, the result cache — reads it there.

Vertex sub-phase accounting is thread-local too: a vertex thread opens a
frame, and the exchange layer times each blocking wait and spill I/O in a
:func:`vertex_phase` span, which is recorded on the thread's track and also
added to the frame's totals; the scheduler folds the frame into the vertex
record at completion.  Outside an open frame (e.g. the client thread
draining the root exchange) :func:`vertex_phase` is the no-op.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

from ...analysis.lockdep import make_lock
from . import clock

ENV_FLAG = "REPRO_OBS_TRACING"


def tracing_enabled(config: Optional[dict] = None) -> bool:
    """Is per-query tracing on — via session config or process-wide env?"""
    if os.environ.get(ENV_FLAG, "") not in ("", "0"):
        return True
    return bool((config or {}).get("obs.tracing", False))


# ---------------------------------------------------------------- factories
class _NoopSpan:
    """The tracing-off span: a stateless context-manager singleton."""

    __slots__ = ()

    def note(self, **args) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


#: The one no-op span instance; ``make_span(None, ...)`` always returns it,
#: so tracing-off runs allocate zero span objects (tests check identity).
NOOP_SPAN = _NoopSpan()


def make_span(trace: Optional["QueryTrace"], name: str, cat: str = "span",
              **args):
    """A live span on ``trace``, or the shared no-op when tracing is off."""
    if trace is None:
        return NOOP_SPAN
    return trace.span(name, cat, **args)


def emit_event(trace: Optional["QueryTrace"], name: str, cat: str = "event",
               **args) -> None:
    """Record a point event; no-op (no allocation) when tracing is off."""
    if trace is not None:
        trace.event(name, cat, **args)


# ---------------------------------------------------- thread-local state
class _Local(threading.local):
    """This thread's current query trace and open vertex frame."""

    trace: Optional["QueryTrace"] = None
    frame: Optional["_VertexFrame"] = None


_tls = _Local()


def current_trace() -> Optional["QueryTrace"]:
    """The trace of the query whose work this thread runs now (``None``
    with tracing off, or on a thread that runs no query's work)."""
    return _tls.trace


def bind_trace(trace: Optional["QueryTrace"]) -> Optional["QueryTrace"]:
    """Make ``trace`` this thread's current trace; returns the one it
    replaces, for :func:`restore_trace`."""
    prev = _tls.trace
    _tls.trace = trace
    return prev


def restore_trace(prev: Optional["QueryTrace"]) -> None:
    _tls.trace = prev


class _VertexFrame:
    __slots__ = ("wait_s", "spill_s", "prev")

    def __init__(self, prev: Optional["QueryTrace"]):
        self.wait_s = 0.0
        self.spill_s = 0.0
        self.prev = prev


def open_vertex_frame(trace: "QueryTrace") -> _VertexFrame:
    """Start exchange-wait / spill-I/O accounting on this thread, with
    ``trace`` its current trace until :func:`close_vertex_frame`."""
    frame = _VertexFrame(_tls.trace)
    _tls.frame = frame
    _tls.trace = trace
    return frame


def close_vertex_frame(frame: Optional[_VertexFrame]) -> None:
    _tls.frame = None
    if frame is not None:
        _tls.trace = frame.prev


# ------------------------------------------------------------------- spans
class _Span:
    """A live span: context manager recording a completed interval, with
    its thread's CPU milliseconds in ``cpu_ms``."""

    __slots__ = ("_trace", "name", "cat", "args", "_t0", "_c0")

    def __init__(self, trace: "QueryTrace", name: str, cat: str, args: dict):
        self._trace = trace
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = self._c0 = 0.0

    def note(self, **args) -> None:
        """Add arguments known only once the span is open."""
        self.args.update(args)

    def __enter__(self) -> "_Span":
        # the CPU reads lie inside the wall reads: cpu_ms <= the wall time
        self._t0 = clock.perf_counter()
        self._c0 = clock.thread_time()
        return self

    def __exit__(self, *exc) -> bool:
        c1 = clock.thread_time()
        self._record(clock.perf_counter(), c1)
        return False

    def _record(self, t1: float, c1: float) -> None:
        self.args["cpu_ms"] = (c1 - self._c0) * 1e3
        self._trace._append(self.name, self.cat, self._t0, t1,
                            threading.get_ident(), self.args)


EXCHANGE_WAIT = "exchange:wait"
SPILL_IO = "spill:io"


class _PhaseSpan(_Span):
    """A vertex's exchange wait or spill I/O: a live span whose seconds
    also go to the thread's vertex frame."""

    __slots__ = ("_frame",)

    def __init__(self, trace: "QueryTrace", name: str, frame: _VertexFrame):
        super().__init__(trace, name, "exchange", {})
        self._frame = frame

    def __exit__(self, *exc) -> bool:
        c1 = clock.thread_time()
        t1 = clock.perf_counter()
        if self.name == EXCHANGE_WAIT:
            self._frame.wait_s += t1 - self._t0
        else:
            self._frame.spill_s += t1 - self._t0
        self._record(t1, c1)
        return False


def vertex_phase(name: str):
    """An ``exchange:wait`` (:data:`EXCHANGE_WAIT`) or ``spill:io``
    (:data:`SPILL_IO`) span on this thread, charged to its open vertex
    frame too; the shared no-op outside a frame."""
    frame = _tls.frame
    if frame is None:
        return NOOP_SPAN
    return _PhaseSpan(_tls.trace, name, frame)


class QueryTrace:
    """All spans and events one query emitted, on one shared clock.

    Live spans record on the thread they ran on; the per-vertex and
    per-lane spans (built from :meth:`add_vertex` records at export time)
    get their own tracks, so they never interleave with live span nesting.
    """

    def __init__(self, qid: str, sql: str = ""):
        self.qid = qid
        self.sql = sql
        self.t0 = clock.perf_counter()
        self._lock = make_lock("obs.trace")
        # (name, cat, t_begin, t_end, track, args); track None => this thread
        self._spans: List[tuple] = []
        # (name, cat, ts, track, args)
        self._events: List[tuple] = []
        self.vertices: Dict[str, dict] = {}
        self.kernels: Dict[str, int] = {}

    # -- recording ----------------------------------------------------------
    def span(self, name: str, cat: str = "span", **args) -> _Span:
        return _Span(self, name, cat, args)

    def event(self, name: str, cat: str = "event", **args) -> None:
        with self._lock:
            self._events.append(
                (name, cat, clock.perf_counter(), threading.get_ident(),
                 args))

    def add_span(self, name: str, cat: str, t_begin: float, t_end: float,
                 track=None, **args) -> None:
        """Record a completed interval (``track=None`` = calling thread)."""
        self._append(name, cat, t_begin, t_end,
                     threading.get_ident() if track is None else track, args)

    def _append(self, name: str, cat: str, t_begin: float, t_end: float,
                track, args: dict) -> None:
        with self._lock:
            self._spans.append((name, cat, t_begin, t_end, track, args))

    def kernel_dispatch(self, name: str, engine: str) -> None:
        """Count a kernel-registry dispatch (the call itself is a
        ``kernel:<name>`` span, opened by ``registry.host_call``)."""
        key = f"{name}[{engine}]"
        with self._lock:
            self.kernels[key] = self.kernels.get(key, 0) + 1

    def add_vertex(self, vid: str, t_begin: float, seconds: float,
                   wait_s: float = 0.0, spill_s: float = 0.0, rows: int = 0,
                   lanes=None, **extra) -> None:
        """Record one DAG vertex's wall split into compute vs.
        exchange-wait vs. spill-I/O (sub-phase seconds come from this
        thread's vertex frame; compute is the remainder)."""
        seconds = max(float(seconds), 0.0)
        wait_s = min(max(float(wait_s), 0.0), seconds)
        spill_s = min(max(float(spill_s), 0.0), max(seconds - wait_s, 0.0))
        rec = {
            "vid": vid,
            "t0": t_begin,
            "seconds": seconds,
            "compute_s": max(seconds - wait_s - spill_s, 0.0),
            "exchange_wait_s": wait_s,
            "spill_io_s": spill_s,
            "rows": int(rows),
            "lanes": list(lanes) if lanes else None,
        }
        rec.update(extra)
        with self._lock:
            # trace rollup keyed by vertex id, not DAG structure
            self.vertices[vid] = rec  # repro-lint: REP005

    # -- export -------------------------------------------------------------
    def summary(self) -> dict:
        """Structured rollup (EXPLAIN ANALYZE / bench trace_summary feed)."""
        with self._lock:
            spans = list(self._spans)
            events = list(self._events)
            vertices = {k: dict(v) for k, v in self.vertices.items()}
            kernels = dict(self.kernels)
        stages = {
            name.split(":", 1)[1]: round((t1 - t_b) * 1e3, 3)
            for name, cat, t_b, t1, _track, _a in spans if cat == "stage"
        }
        verts = {
            vid: {
                "total_ms": round(r["seconds"] * 1e3, 3),
                "compute_ms": round(r["compute_s"] * 1e3, 3),
                "exchange_wait_ms": round(r["exchange_wait_s"] * 1e3, 3),
                "spill_io_ms": round(r["spill_io_s"] * 1e3, 3),
                "rows": r["rows"],
                "lanes": r["lanes"],
            }
            for vid, r in sorted(vertices.items())
        }
        return {
            "qid": self.qid,
            "stages_ms": stages,
            "vertices": verts,
            "events": [
                {"name": name, "cat": cat,
                 "ts_ms": round((ts - self.t0) * 1e3, 3), **args}
                for name, cat, ts, _track, args in sorted(
                    events, key=lambda e: e[2])
            ],
            "kernel_dispatches": kernels,
        }

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON (ph/ts/pid/tid; balanced B/E pairs)."""
        with self._lock:
            spans = list(self._spans)
            events = list(self._events)
            vertices = {k: dict(v) for k, v in self.vertices.items()}

        def us(t: float) -> float:
            return round((t - self.t0) * 1e6, 3)

        # per-vertex tracks (the vertex's wall, its compute / wait / spill
        # totals as arguments) and one track per shuffle lane
        for vid, r in sorted(vertices.items()):
            end = r["t0"] + r["seconds"]
            spans.append((f"vertex:{vid}", "vertex", r["t0"], end,
                          f"vertex {vid}", {
                              "rows": r["rows"],
                              "compute_ms": round(r["compute_s"] * 1e3, 3),
                              "exchange_wait_ms":
                                  round(r["exchange_wait_s"] * 1e3, 3),
                              "spill_io_ms": round(r["spill_io_s"] * 1e3, 3),
                          }))
            for lane in r["lanes"] or []:
                p = lane.get("partition")
                spans.append((f"lane:{vid}.p{p}", "lane", r["t0"], end,
                              f"lane {vid}.p{p}", dict(lane)))

        # stable small-int tids per track, in first-seen order
        tids: Dict[object, int] = {}

        def tid_of(track) -> int:
            if track not in tids:
                tids[track] = len(tids) + 1
            return tids[track]

        pid = os.getpid()
        out = []
        for name, cat, t_b, t_e, track, args in spans:
            b = us(t_b)
            e = max(us(t_e), b + 0.001)
            dur = e - b
            tid = tid_of(track)
            # sort keys give valid nesting for any properly-nestable set:
            # at equal ts all E before all B, longer B (parents) first,
            # shorter E (children) first
            out.append(((b, 1, -dur),
                        {"ph": "B", "ts": b, "pid": pid, "tid": tid,
                         "name": name, "cat": cat, "args": args}))
            out.append(((e, 0, dur),
                        {"ph": "E", "ts": e, "pid": pid,
                         "tid": tid, "name": name, "cat": cat}))
        for name, cat, ts, track, args in events:
            out.append(((us(ts), 2, 0.0),
                        {"ph": "i", "ts": us(ts), "pid": pid,
                         "tid": tid_of(track), "name": name, "cat": cat,
                         "s": "t", "args": args}))
        out.sort(key=lambda pair: pair[0])
        trace_events = [
            {"ph": "M", "ts": 0, "pid": pid, "tid": 0,
             "name": "process_name", "args": {"name": f"query {self.qid}"}}
        ]
        for track, tid in tids.items():
            label = track if isinstance(track, str) else f"thread-{tid}"
            trace_events.append(
                {"ph": "M", "ts": 0, "pid": pid, "tid": tid,
                 "name": "thread_name", "args": {"name": label}})
        trace_events.extend(ev for _k, ev in out)
        # t0_s: the obs clock's (clock.perf_counter) seconds at ts 0, so a
        # reader can place every span beside other records of that clock
        return {"traceEvents": trace_events, "displayTimeUnit": "ms",
                "otherData": {"qid": self.qid, "sql": self.sql,
                              "t0_s": self.t0}}
