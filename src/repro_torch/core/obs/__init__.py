"""Warehouse observability layer (PR 10).

Three coupled pieces, shared by every telemetry surface:

  * :mod:`.trace` — structured per-query tracing: a :class:`QueryTrace`
    of nested spans and point events (pipeline stages, WLM admission
    wait, the result cache's pending wait, DAG vertices split into
    compute / exchange-wait / spill-I/O, each exchange wait and spill,
    join and runtime-filter probes, kernel calls, shuffle lanes,
    federated split reads, serving and adaptive events), each live span
    with its thread's CPU time, exportable as Chrome trace-event JSON for
    Perfetto.  ``make_span`` / ``emit_event`` follow the lockdep factory
    pattern: plain no-op singletons when ``obs.tracing`` is off, one
    attribute test on the hot path; ``current_trace`` is the trace of the
    query a thread works for.
  * :mod:`.metrics` — the warehouse :class:`MetricsRegistry` (counters /
    gauges / bucketed histograms); ``poll()``, ``server_stats()`` and the
    WLM/serving/shuffle counters keep their dict shapes but derive from
    it, and ``Connection.metrics()`` exposes the full snapshot.
  * :mod:`.query_log` — the always-on bounded ring of completed queries
    behind ``Connection.query_log()``.

:class:`WarehouseObs` bundles the three plus a bounded store of completed
traces (``Connection.export_trace(query_id, path)``); the clock aliases in
:mod:`.clock` are the REP007-sanctioned timing sources for
``core/runtime``, ``core/serving`` and ``core/federation``.
"""
from __future__ import annotations

import json
from collections import OrderedDict
from typing import Optional

from ...analysis.lockdep import make_lock
from . import clock
from .metrics import DEFAULT_BUCKETS_MS, Counter, Histogram, MetricsRegistry
from .query_log import QueryLog
from .trace import (NOOP_SPAN, QueryTrace, bind_trace, close_vertex_frame,
                    current_trace, emit_event, make_span, open_vertex_frame,
                    restore_trace, tracing_enabled, vertex_phase)

__all__ = [
    "DEFAULT_BUCKETS_MS", "Counter", "Histogram", "MetricsRegistry",
    "NOOP_SPAN", "QueryLog", "QueryTrace", "WarehouseObs", "bind_trace",
    "clock", "close_vertex_frame", "current_trace", "emit_event",
    "make_span", "open_vertex_frame", "restore_trace", "tracing_enabled",
    "vertex_phase",
]


class WarehouseObs:
    """Per-warehouse observability hub: registry + query log + traces."""

    def __init__(self, query_log_size: Optional[int] = None,
                 trace_store_size: Optional[int] = None):
        from ..config_keys import DEFAULT_CONFIG

        self.metrics = MetricsRegistry()
        self.query_log = QueryLog(
            query_log_size or DEFAULT_CONFIG["obs.query_log_size"])
        self._trace_cap = max(
            int(trace_store_size
                or DEFAULT_CONFIG["obs.trace_store_size"]), 1)
        self._traces: "OrderedDict[str, QueryTrace]" = OrderedDict()
        self._lock = make_lock("obs.traces")

    # -- trace store --------------------------------------------------------
    def store_trace(self, qid: str, trace: QueryTrace) -> None:
        with self._lock:
            self._traces[qid] = trace
            self._traces.move_to_end(qid)
            while len(self._traces) > self._trace_cap:
                self._traces.popitem(last=False)

    def get_trace(self, qid: str) -> Optional[QueryTrace]:
        with self._lock:
            return self._traces.get(qid)

    def export_trace(self, qid: str, path: str) -> str:
        """Write one completed query's Chrome trace JSON to ``path``."""
        trace = self.get_trace(qid)
        if trace is None:
            raise KeyError(
                f"no trace retained for query {qid!r} (was obs.tracing on, "
                f"and is the query within the last {self._trace_cap} traced "
                f"completions?)")
        with open(path, "w") as f:
            json.dump(trace.to_chrome(), f, indent=1)
            f.write("\n")
        return path

    # -- query completion ---------------------------------------------------
    def note_query_done(self, entry: dict,
                        trace: Optional[QueryTrace] = None) -> None:
        """Record one completed query: ring-buffer entry, outcome counters,
        latency histograms, and (when traced) the retained trace."""
        self.query_log.record(entry)
        status = str(entry.get("status", "unknown")).lower()
        self.metrics.inc(f"query.{status}")
        if entry.get("wall_ms") is not None:
            self.metrics.observe("query.wall_ms", entry["wall_ms"])
        if entry.get("queue_wait_ms") is not None:
            self.metrics.observe("query.queue_wait_ms",
                                 entry["queue_wait_ms"])
        if entry.get("cache_hit"):
            self.metrics.inc("query.result_cache_served")
        if trace is not None and entry.get("qid"):
            self.store_trace(entry["qid"], trace)
