"""Asynchronous query handles (the client side of HS2 async operations).

``Connection.execute_async(sql, params)`` returns a :class:`QueryHandle`
immediately; the statement runs on the warehouse's scheduler worker pool
behind workload-manager admission (paper §5.2).  The handle exposes:

  * ``state`` — QUEUED / ADMITTED / RUNNING / SUCCEEDED / FAILED / CANCELLED;
  * ``poll()`` — progress: DAG vertices done/total, WLM pool, queue wait,
    rows/bytes spilled per vertex by the spill-aware exchanges, and the
    per-pool admission queue depth;
  * ``result(timeout)`` — block for completion, return a :class:`Cursor`
    over the result set (raises the query's error on failure);
  * ``cancel()`` — cooperative cancellation, observed while queued for
    admission and at every operator batch boundary (latency bounded by one
    morsel);
  * ``fetch_stream()`` — iterate row batches as the engine produces them:
    root-vertex morsels stream out while upstream DAG vertices are still
    running, so first rows arrive long before the handle reaches SUCCEEDED
    (a lagging consumer backpressures the executing worker; upstream
    vertices keep going, bounded by the exchanges' spill budget).

Queries killed by a WLM trigger rule raise
:class:`repro_torch.api.exceptions.QueryKilledError` from ``result()`` /
``fetch_stream()``; client-cancelled queries raise
:class:`repro_torch.api.exceptions.QueryCancelledError`.
"""
from __future__ import annotations

from typing import Iterator, List, Optional

from ..core.runtime import scheduler as _sched
from .cursor import Cursor, _translate_error


class QueryHandle:
    """Created via :meth:`repro_torch.api.Connection.execute_async`."""

    def __init__(self, connection, task: _sched.QueryTask):
        self._conn = connection
        self._task = task
        self._cursor: Optional[Cursor] = None

    # ------------------------------------------------------------- state
    @property
    def query_id(self) -> str:
        return self._task.qid

    @property
    def state(self) -> str:
        """QUEUED | ADMITTED | RUNNING | SUCCEEDED | FAILED | CANCELLED."""
        return self._task.state

    def done(self) -> bool:
        return self._task.done()

    def poll(self) -> dict:
        """Non-blocking progress snapshot: ``state``, ``pool``,
        ``vertices_done``/``vertices_total``, ``queue_wait_ms``,
        ``spill`` (per-vertex rows/bytes spilled by the exchanges),
        ``rows_spilled``/``bytes_spilled`` totals, and
        ``pool_queue_depth`` (queued queries per WLM pool)."""
        return self._task.poll()

    @property
    def info(self) -> dict:
        """Engine-side execution info once the query succeeded."""
        res = self._task.result
        return dict(res.info) if res is not None else {}

    def trace(self) -> dict:
        """This query's Chrome trace-event JSON (paper-style EXPLAIN
        ANALYZE's raw material): pipeline-stage spans, WLM admission wait,
        the result cache's pending wait, per-vertex tracks (compute /
        exchange-wait / spill-I/O totals as arguments), each exchange wait
        and spill, join and runtime-filter probes and kernel calls on the
        threads that ran them (each live span with its ``cpu_ms``),
        shuffle lanes, and serving/adaptive instant events;
        ``otherData["t0_s"]`` is the obs clock's seconds at ``ts`` 0.
        Requires ``obs.tracing``
        (or ``REPRO_OBS_TRACING=1``) to have been on when the query was
        submitted; dump to a file and open in Perfetto, or use
        ``Connection.export_trace(handle.query_id, path)``."""
        if self._task.trace is None:
            raise RuntimeError(
                "query ran with tracing off; submit with obs.tracing=True "
                "(connect(..., **{'obs.tracing': True}) or "
                "REPRO_OBS_TRACING=1) to record a trace")
        return self._task.trace.to_chrome()

    # ------------------------------------------------------------- results
    def result(self, timeout: Optional[float] = None) -> Cursor:
        """Block until the query finishes; return a cursor over the result.

        Raises ``TimeoutError`` if still running after ``timeout`` seconds,
        or the query's (DB-API-translated) error if it failed, was killed,
        or was cancelled.
        """
        res = self._wait_result(timeout)
        if self._cursor is None:
            self._cursor = Cursor(self._conn)
            self._cursor._install(res)  # noqa: SLF001 - same package
        return self._cursor

    def cancel(self) -> bool:
        """Request cooperative cancellation (observed at DAG vertex
        boundaries and in the admission queue).  Returns ``False`` when the
        query already completed."""
        return self._task.cancel()

    def fetch_stream(self, batch_rows: Optional[int] = None
                     ) -> Iterator[List[tuple]]:
        """Yield result rows in batches as the engine produces them.

        While the query is in flight, the root vertex's morsels stream from
        the executing worker as they are produced — the first batch arrives
        before the root vertex (let alone the DAG) finishes, upstream
        vertices report through :meth:`poll` as they go, and rows are handed
        over in ``batch_rows``-row slices (default: session config
        ``stream_batch_rows``).  On a finished handle the final result is
        replayed in slices instead, so the method is safe to call at any
        point.  Raises like :meth:`result` if the query failed.
        """
        task = self._task
        if task.stream.activate(batch_rows):
            for batch in task.stream:
                yield batch.to_rows()
            if task.done() and task.error is not None:
                self._wait_result()  # raises the translated error
            return
        # producer already passed its emit point: replay the final result
        res = self._wait_result()
        rows = int(batch_rows or _sched.stream_batch_rows(task.config))
        for piece in _sched.ResultStream.iter_slices(res.batch, rows):
            yield piece.to_rows()

    # ------------------------------------------------------------- internals
    def _wait_result(self, timeout: Optional[float] = None):
        try:
            return self._task.wait(timeout)
        except TimeoutError:
            raise
        except Exception as exc:  # noqa: BLE001 - translated to DB-API
            raise _translate_error(exc) from exc

    def __repr__(self):
        return (f"QueryHandle({self.query_id}, {self.state}, "
                f"sql={self._task.sql!r})")
