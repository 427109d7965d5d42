"""Structured per-query tracing (spans + point events, Chrome-exportable).

One :class:`QueryTrace` collects everything a single query does — pipeline
stages, the WLM admission wait, every DAG vertex (split into compute vs.
exchange-wait vs. spill-I/O time), shuffle lanes, federated split reads,
kernel dispatches, serving-tier attach/hit and adaptive decisions — on one
shared clock (:mod:`.clock`), and exports the lot as Chrome trace-event
JSON (``QueryHandle.trace()`` / ``Connection.export_trace``) so a query
renders directly in Perfetto / ``chrome://tracing``.

Hot-path discipline follows the lockdep factory pattern: tracing resolves
to a per-query ``trace`` object exactly once (``None`` when ``obs.tracing``
is off), every instrumentation site pays a single ``is not None`` attribute
test, and :func:`make_span` returns the module-level :data:`NOOP_SPAN`
singleton when tracing is off — no span objects are ever allocated on the
morsel path.

Vertex sub-phase accounting is thread-local: a vertex thread opens a
frame (:func:`open_vertex_frame`), the exchange layer accumulates blocking
wait and spill-I/O durations into it (:func:`note_exchange_wait` /
:func:`note_spill_io`), and the scheduler folds the frame into the vertex
record at completion.  Accumulation outside an open frame (e.g. the client
thread draining the root exchange) is silently dropped.
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


# -------------------------------------------------- thread-local accounting
class _VertexFrame:
    __slots__ = ("wait_s", "spill_s")

    def __init__(self):
        self.wait_s = 0.0
        self.spill_s = 0.0


_tls = threading.local()


def open_vertex_frame() -> _VertexFrame:
    """Start exchange-wait / spill-I/O accounting on this thread."""
    frame = _VertexFrame()
    _tls.frame = frame
    return frame


def close_vertex_frame() -> None:
    _tls.frame = None


def note_exchange_wait(seconds: float) -> None:
    frame = getattr(_tls, "frame", None)
    if frame is not None:
        frame.wait_s += seconds


def note_spill_io(seconds: float) -> None:
    frame = getattr(_tls, "frame", None)
    if frame is not None:
        frame.spill_s += seconds


# ------------------------------------------------------------------- spans
class _Span:
    """A live span: context manager recording a completed interval."""

    __slots__ = ("_trace", "name", "cat", "args", "_t0")

    def __init__(self, trace: "QueryTrace", name: str, cat: str, args: dict):
        self._trace = trace
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        self._t0 = clock.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self._trace.add_span(self.name, self.cat, self._t0,
                             clock.perf_counter(), **self.args)
        return False


class QueryTrace:
    """All spans and events one query emitted, on one shared clock.

    Live spans record on the thread they ran on; synthetic per-vertex and
    per-lane spans (built from :meth:`add_vertex` records at export time)
    get their own tracks so aggregate sub-phases can never interleave with
    live span nesting.
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
        if track is None:
            track = threading.get_ident()
        with self._lock:
            self._spans.append((name, cat, t_begin, t_end, track, args))

    def kernel_dispatch(self, name: str, engine: str) -> None:
        """Count a kernel-registry dispatch; first occurrence of each
        (kernel, engine) pair also drops a point event on the timeline."""
        key = f"{name}[{engine}]"
        with self._lock:
            seen = self.kernels.get(key, 0)
            self.kernels[key] = seen + 1
            if seen == 0:
                self._events.append(
                    (f"kernel:{key}", "kernel", clock.perf_counter(),
                     threading.get_ident(), {}))

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

        # synthetic per-vertex tracks: vertex span wrapping strictly-nested
        # sequential sub-phase spans, plus one track per shuffle lane
        for vid, r in sorted(vertices.items()):
            track = f"vertex {vid}"
            base = us(r["t0"])
            total = max(r["seconds"] * 1e6, 1.0)
            spans.append((f"vertex:{vid}", "vertex", r["t0"],
                          r["t0"] + total / 1e6, track, {
                              "rows": r["rows"],
                              "compute_ms": round(r["compute_s"] * 1e3, 3),
                              "exchange_wait_ms":
                                  round(r["exchange_wait_s"] * 1e3, 3),
                              "spill_io_ms": round(r["spill_io_s"] * 1e3, 3),
                          }))
            subs = [("compute", r["compute_s"] * 1e6),
                    ("exchange-wait", r["exchange_wait_s"] * 1e6),
                    ("spill-io", r["spill_io_s"] * 1e6)]
            durs = [max(d, 0.01) for _n, d in subs]
            scale = (total - 0.02) / sum(durs) if sum(durs) > total - 0.02 \
                else 1.0
            cursor = base + 0.01
            for (sub, _d), dur in zip(subs, durs):
                end = cursor + dur * scale
                spans.append((f"{vid}:{sub}", "vertex-phase",
                              self.t0 + cursor / 1e6, self.t0 + end / 1e6,
                              track, {}))
                cursor = end
            for lane in r["lanes"] or []:
                p = lane.get("partition")
                spans.append((f"lane:{vid}.p{p}", "lane", r["t0"],
                              r["t0"] + total / 1e6, f"lane {vid}.p{p}",
                              dict(lane)))

        # stable small-int tids per track, in first-seen order
        tids: Dict[object, int] = {}

        def tid_of(track) -> int:
            if track not in tids:
                tids[track] = len(tids) + 1
            return tids[track]

        pid = os.getpid()
        out = []
        for name, cat, t_b, t_e, track, args in spans:
            dur = max(us(t_e) - us(t_b), 0.001)
            tid = tid_of(track)
            # sort keys give valid nesting for any properly-nestable set:
            # at equal ts all E before all B, longer B (parents) first,
            # shorter E (children) first
            out.append(((us(t_b), 1, -dur),
                        {"ph": "B", "ts": us(t_b), "pid": pid, "tid": tid,
                         "name": name, "cat": cat, "args": args}))
            out.append(((us(t_b) + dur, 0, dur),
                        {"ph": "E", "ts": us(t_b) + dur, "pid": pid,
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
        return {"traceEvents": trace_events, "displayTimeUnit": "ms",
                "otherData": {"qid": self.qid, "sql": self.sql}}
