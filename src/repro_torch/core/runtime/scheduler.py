"""Asynchronous query scheduling (HiveServer2 async operations, paper §2/§5.2).

The paper's HiveServer2 serves many interactive clients at once: a client
submits a statement and gets back an *operation handle* it can poll, cancel,
or fetch from, while the server drives execution on a worker pool behind the
workload manager's admission control.  This module is that server side:

  * :class:`QueryTask` — the server-side state of one submitted statement:
    a QUEUED → ADMITTED → RUNNING → SUCCEEDED/FAILED/CANCELLED state
    machine, a :class:`~repro_torch.core.runtime.cancel.CancelToken`, progress
    counters (DAG vertices done/total, pool, queue wait), and a
    :class:`ResultStream` for incremental fetches;
  * :class:`QueryScheduler` — runs submitted statements on a bounded worker
    pool.  Queries pass through WLM admission (blocking until their pool has
    capacity, §5.2) and then the staged ``QueryPipeline``; DML/DDL run
    directly under their usual single-statement transactions.

The public face of a task is :class:`repro_torch.api.handle.QueryHandle`.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from queue import Empty, Full, Queue
from typing import Dict, Iterator, Optional, Tuple

from ...analysis.lockdep import make_condition, make_lock
from ..obs.trace import QueryTrace, emit_event, make_span, tracing_enabled
from ..sql import ast as A
from .cancel import CancelToken, QueryCancelledError
from .vector import VectorBatch

QUEUED = "QUEUED"
ADMITTED = "ADMITTED"
RUNNING = "RUNNING"
SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"
CANCELLED = "CANCELLED"
TERMINAL_STATES = (SUCCEEDED, FAILED, CANCELLED)

_POLL_S = 0.05  # producer/consumer wake-up to observe cancel/detach
_STREAM_STALL_S = 60.0  # give up on a consumer that stopped draining

DEFAULT_STREAM_BATCH_ROWS = 4096


def stream_batch_rows(config: dict) -> int:
    """Rows per streamed batch for a session config (single authority)."""
    return int(config.get("stream_batch_rows", DEFAULT_STREAM_BATCH_ROWS)
               or DEFAULT_STREAM_BATCH_ROWS)


class ResultStream:
    """Bounded hand-off of result row-batches from the executing worker to a
    consumer iterating ``QueryHandle.fetch_stream()``.

    The queue is small on purpose: a lagging consumer exerts backpressure on
    the producer (the worker thread blocks in :meth:`publish`), which is what
    lets a client observe batches while the query is still ``RUNNING``.  The
    producer detaches cleanly if the consumer abandons the iterator, and
    ``publish`` is first-wins so the mid-execution emit (DAG root output) and
    the post-completion fallback (cache hits, replays) never double-stream.
    """

    _DONE = object()

    def __init__(self, maxsize: int = 2):
        self._q: Queue = Queue(maxsize)
        self._lock = make_lock("scheduler.result_stream")
        self._active = False          # a consumer is (or will be) iterating
        self._started = False         # a producer reached its emit point
        self._detached = False        # consumer abandoned the iterator
        self._live = False            # incremental emit() streaming is on
        self.batch_rows: Optional[int] = None  # consumer-requested page size

    # -------------------------------------------------------- consumer side
    def activate(self, batch_rows: Optional[int] = None) -> bool:
        """Claim live streaming; ``False`` means the producer already passed
        its emit point and the caller should replay the final result."""
        with self._lock:
            if self._started:
                return False
            self._active = True
            if batch_rows:
                self.batch_rows = int(batch_rows)
            return True

    def __iter__(self) -> Iterator[VectorBatch]:
        try:
            while True:
                item = self._q.get()
                if item is self._DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            self._detached = True

    @staticmethod
    def iter_slices(batch: VectorBatch, rows: int) -> Iterator[VectorBatch]:
        """The one slicing rule shared by live streaming and replay."""
        rows = max(int(rows), 1)
        for lo in range(0, batch.num_rows, rows):
            yield batch.slice(lo, lo + rows)

    # -------------------------------------------------------- producer side
    def publish(self, batch: VectorBatch, default_batch_rows: int,
                cancel_token: Optional[CancelToken] = None) -> None:
        """Slice ``batch`` into row-batches and stream them to the consumer.
        First call wins; a no-op when no consumer attached in time."""
        with self._lock:
            if self._started:
                return
            self._started = True
            if not self._active:
                return
            rows = self.batch_rows or default_batch_rows
        for piece in self.iter_slices(batch, rows):
            self._put(piece, cancel_token)

    def emit(self, batch: VectorBatch, default_batch_rows: int,
             cancel_token: Optional[CancelToken] = None) -> None:
        """Incrementally stream one engine morsel to a live consumer.

        Called by the executing worker for every root-vertex chunk as the
        DAG produces it, so the consumer sees first rows while upstream
        vertices are still running.  The first call claims the stream (the
        post-completion ``publish`` fallback then no-ops); when no consumer
        attached before the first chunk, emits are dropped and the finished
        handle replays the final result instead."""
        with self._lock:
            if not self._started:
                self._started = True
                self._live = self._active
            if not self._live:
                return
            rows = self.batch_rows or default_batch_rows
        for piece in self.iter_slices(batch, rows) if batch.num_rows else ():
            self._put(piece, cancel_token)

    def abort_live(self, error: BaseException) -> None:
        """Fail a live consumer mid-stream (e.g. §4.2 re-execution after
        chunks already streamed): the partial prefix must not be silently
        passed off as a complete result."""
        with self._lock:
            if not self._live or self._detached:
                return
            self._live = False
        self._flush_error(error)

    def close(self) -> None:
        """Terminate the stream (always called by the worker, success or
        not), so a blocked consumer wakes up."""
        with self._lock:
            self._started = True  # late activate() must take the replay path
        self._put(self._DONE, None)

    def _put(self, item, cancel_token: Optional[CancelToken]) -> None:
        stalled_since = time.monotonic()
        while not self._detached:
            if cancel_token is not None:
                cancel_token.check()
            try:
                self._q.put(item, timeout=_POLL_S)
                return
            except Full:
                # backstop: a consumer that claimed the stream but stopped
                # draining it must not pin a worker thread forever.  Swap the
                # queued batches for an error so a late-waking consumer gets
                # a loud failure, never a silent truncation or a hung get()
                if time.monotonic() - stalled_since > _STREAM_STALL_S:
                    self._detached = True
                    self._flush_error(RuntimeError(
                        f"fetch_stream consumer stalled for more than "
                        f"{_STREAM_STALL_S:.0f}s; stream abandoned"
                    ))
                    return

    def _flush_error(self, error: BaseException) -> None:
        while True:
            try:
                self._q.get_nowait()
            except Empty:
                break
        try:
            self._q.put_nowait(error)
        except Full:  # consumer raced a get(); queue has room next round
            pass


class QueryTask:
    """Server-side state of one asynchronously submitted statement."""

    def __init__(self, qid: str, sql: str, stmt, params: Tuple, config: dict):
        self.qid = qid
        self.sql = sql
        self.stmt = stmt
        self.params = tuple(params)
        self.config = config
        self.cancel_token = CancelToken()
        self.stream = ResultStream()
        # per-query structured trace (PR 10): None unless obs.tracing /
        # REPRO_OBS_TRACING is on — every instrumented hot path then pays
        # one attribute test and allocates no span objects
        self.trace = QueryTrace(qid, sql) if tracing_enabled(config) else None
        self.submitted_at = time.time()
        self.admitted_at: Optional[float] = None
        self.wlm = None                        # set by QueryScheduler.submit
        self.serving_stats = None              # set by QueryScheduler.submit
        self._cond = make_condition(name="scheduler.task")
        self._state = QUEUED
        self.result = None                     # QueryResult on SUCCEEDED
        self.error: Optional[BaseException] = None
        self._progress: Dict[str, object] = {
            "pool": None, "vertices_total": 0, "vertices_done": 0,
            "rows_spilled": 0, "bytes_spilled": 0, "spill": {},
            "peak_buffered_rows": 0, "lanes": {}, "shared_scans": {},
            "adaptive": [],
        }

    # ------------------------------------------------------------- state
    @property
    def state(self) -> str:
        with self._cond:
            return self._state

    def done(self) -> bool:
        return self.state in TERMINAL_STATES

    def _set_state(self, state: str) -> None:
        with self._cond:
            if self._state in TERMINAL_STATES:
                return
            self._state = state
            self._cond.notify_all()

    def _finish(self, state: str, result=None,
                error: Optional[BaseException] = None) -> None:
        with self._cond:
            if self._state in TERMINAL_STATES:
                return
            self._state = state
            self.result = result
            self.error = error
            self._cond.notify_all()

    # ------------------------------------------------------------- client ops
    def wait(self, timeout: Optional[float] = None):
        """Block until terminal; return the QueryResult or raise the
        query's error (TimeoutError if still running after ``timeout``)."""
        with self._cond:
            if not self._cond.wait_for(
                lambda: self._state in TERMINAL_STATES, timeout
            ):
                raise TimeoutError(
                    f"query {self.qid} still {self._state} "
                    f"after {timeout:.3f}s"
                )
            if self._state == SUCCEEDED:
                return self.result
            raise self.error

    def cancel(self, reason: str = "cancelled by client") -> bool:
        """Request cooperative cancellation; ``False`` when the query
        already reached SUCCEEDED or FAILED.

        ``True`` means the request was accepted, checked atomically against
        the state transition (the worker finishes under the same lock); a
        query past its last cancellation point may still complete."""
        with self._cond:
            if self._state in TERMINAL_STATES:
                return self._state == CANCELLED
            self.cancel_token.cancel(reason)
            return True

    def poll(self) -> Dict[str, object]:
        """Progress snapshot: state, pool, vertices done/total, queue wait,
        per-vertex spill (rows/bytes) and per-pool admission queue depth."""
        with self._cond:
            out = dict(self._progress)
            out["spill"] = {k: dict(v) for k, v in out["spill"].items()}
            out["lanes"] = {k: [dict(l) for l in v]
                            for k, v in out["lanes"].items()}
            out["adaptive"] = [dict(ev) for ev in out["adaptive"]]
            out["state"] = self._state
            out["queue_wait_ms"] = (
                round((self.admitted_at - self.submitted_at) * 1e3, 3)
                if self.admitted_at is not None else None
            )
        if self.wlm is not None:
            out["pool_queue_depth"] = self.wlm.queue_depths()
        if self.serving_stats is not None:
            # warehouse-wide serving-tier counters (result-cache hit/miss/
            # eviction, shared-scan attach/publish) alongside this query's
            # own shared_scans progress entry
            out["serving"] = self.serving_stats()
        return out

    # ------------------------------------------------------------- execution
    def note_pool(self, pool: Optional[str]) -> None:
        with self._cond:
            self._progress["pool"] = pool

    def note_vertices_total(self, total: int) -> None:
        with self._cond:
            self._progress["vertices_total"] = total
            self._progress["vertices_done"] = 0

    def note_shared_scans(self, stats: Dict[str, int]) -> None:
        with self._cond:
            self._progress["shared_scans"] = dict(stats)

    def note_adaptive(self, event: Dict[str, object]) -> None:
        """One adaptive replanning decision (lane split, fan-out collapse,
        speculation swap, elided shuffle, declined mutation)."""
        with self._cond:
            self._progress["adaptive"].append(dict(event))

    def note_vertex_done(self, vid: Optional[str] = None,
                         stats: Optional[Dict[str, int]] = None) -> None:
        with self._cond:
            self._progress["vertices_done"] = (
                int(self._progress["vertices_done"]) + 1
            )
            if stats and vid is not None:
                self._progress["spill"][vid] = {
                    "rows": int(stats.get("spilled_rows", 0)),
                    "bytes": int(stats.get("spilled_bytes", 0)),
                }
                if stats.get("lanes"):
                    # per-lane rows/bytes/spill of a partitioned shuffle
                    # edge: skew across lanes is visible while running
                    self._progress["lanes"][vid] = [
                        dict(lane) for lane in stats["lanes"]
                    ]
                self._progress["rows_spilled"] = sum(
                    v["rows"] for v in self._progress["spill"].values())
                self._progress["bytes_spilled"] = sum(
                    v["bytes"] for v in self._progress["spill"].values())
                self._progress["peak_buffered_rows"] = max(
                    int(self._progress["peak_buffered_rows"]),
                    int(stats.get("peak_buffered_rows", 0)),
                )


class QueryScheduler:
    """Executes submitted statements on a worker pool behind WLM admission.

    One scheduler per :class:`~repro_torch.core.session.Warehouse`; sessions submit
    through it, so per-pool ``query_parallelism`` is enforced across every
    connection of the deployment (paper §5.2).
    """

    def __init__(self, warehouse, max_workers: int = 8):
        self.wh = warehouse
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="query-worker"
        )
        self._tasks: Dict[str, QueryTask] = {}
        self._lock = make_lock("scheduler.global")
        self._closed = False

    # ------------------------------------------------------------- submit
    def submit(self, session, stmt, sql: str = "",
               params: Tuple = ()) -> QueryTask:
        if self._closed:
            raise RuntimeError("scheduler is shut down")
        qid = f"q{next(self.wh._qid)}"
        task = QueryTask(qid, sql, stmt, params, dict(session.config))
        task.wlm = self.wh.wlm
        task.serving_stats = self.wh.serving_stats
        with self._lock:
            self._tasks[qid] = task
        self._pool.submit(self._run, session, task)
        return task

    def running(self) -> Dict[str, QueryTask]:
        with self._lock:
            return dict(self._tasks)

    def shutdown(self) -> None:
        self._closed = True
        for task in self.running().values():
            task.cancel("scheduler shut down")
        self._pool.shutdown(wait=False)

    # ------------------------------------------------------------- worker
    def _run(self, session, task: QueryTask) -> None:
        wlm = self.wh.wlm
        admitted = False
        cache_hit = False
        try:
            task.cancel_token.check()
            stmt = task.stmt
            executes_query = isinstance(stmt, (A.Select, A.SetOp)) or (
                isinstance(stmt, A.Explain) and stmt.analyze
                and isinstance(stmt.stmt, (A.Select, A.SetOp))
            )
            if executes_query:
                # serving tier: probe the result cache *before* admission —
                # a repeated dashboard query is answered from cache without
                # taking a WLM slot or executing anything
                result, pre = session._probe_result_cache(task)
                if result is not None:
                    cache_hit = True
                    task.admitted_at = time.time()
                    task._set_state(RUNNING)
                else:
                    # queries (and EXPLAIN ANALYZE, which runs one) queue
                    # behind WLM admission, then take the staged pipeline
                    # with the task threaded through for progress,
                    # cancellation, and streaming.  If admission fails
                    # while we hold a pending cache entry from the probe,
                    # release the waiters queued behind it.
                    try:
                        with make_span(task.trace, "wlm:admission_wait",
                                       "wlm"):
                            slot = wlm.wait_admit(
                                task.qid,
                                task.config.get("user"),
                                task.config.get("application"),
                                cancel_token=task.cancel_token,
                            )
                    except BaseException:
                        if (pre is not None and pre.cacheable
                                and pre.filling):
                            self.wh.result_cache.cancel_pending(
                                pre.result_key)
                        raise
                    admitted = slot is not None
                    if admitted:
                        emit_event(task.trace, "wlm:admitted", "wlm",
                                   pool=slot.pool)
                    task.admitted_at = time.time()
                    task.note_pool(slot.pool if slot is not None else None)
                    task._set_state(ADMITTED)
                    task._set_state(RUNNING)
                    result = session._run_query_task(task, slot, pre=pre)
            else:
                # DML/DDL: single-statement transactions, no WLM admission
                task.admitted_at = time.time()
                task._set_state(RUNNING)
                result = session.execute_stmt(task.stmt, task.sql,
                                              task.params or None)
            # fallback publish for paths that skipped the mid-execution emit
            # (result-cache hits, DML); first-wins, so no double streaming
            if result is not None and result.batch is not None:
                task.stream.publish(result.batch,
                                    stream_batch_rows(task.config),
                                    task.cancel_token)
            task._finish(SUCCEEDED, result=result)
        except QueryCancelledError as exc:
            task._finish(CANCELLED, error=exc)
        except BaseException as exc:  # noqa: BLE001 - surfaced via handle
            task._finish(FAILED, error=exc)
        finally:
            if admitted:
                wlm.release(task.qid)
            task.stream.close()
            self._note_done(task, cache_hit)
            with self._lock:
                self._tasks.pop(task.qid, None)

    def _note_done(self, task: QueryTask, cache_hit: bool) -> None:
        """Record the finished statement with the warehouse observability
        tier: the always-on query-log ring, outcome metrics, and — when the
        query was traced — the bounded trace store behind
        ``Connection.export_trace``."""
        obs = getattr(self.wh, "obs", None)
        if obs is None:  # pragma: no cover - warehouse always wires obs
            return
        rows = None
        result = task.result
        if result is not None and getattr(result, "batch", None) is not None:
            rows = int(result.batch.num_rows)
        with task._cond:
            pool = task._progress.get("pool")
        entry = {
            "qid": task.qid,
            "sql": task.sql,
            "status": task.state,
            "wall_ms": round((time.time() - task.submitted_at) * 1e3, 3),
            "queue_wait_ms": (
                round((task.admitted_at - task.submitted_at) * 1e3, 3)
                if task.admitted_at is not None else None
            ),
            "rows": rows,
            "pool": pool,
            "cache_hit": cache_hit,
        }
        if task.error is not None:
            entry["error"] = str(task.error)
        try:
            obs.note_query_done(entry, trace=task.trace)
        except Exception:  # pragma: no cover - observability must not fail
            pass            # the query it observes
