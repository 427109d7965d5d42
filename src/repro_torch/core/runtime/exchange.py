"""Spill-aware exchanges between DAG vertices (paper §2/§5 Tez edges).

An :class:`Exchange` is the data-movement channel behind one DAG edge: the
producer vertex appends ``VectorBatch`` morsels as it streams them, and any
number of downstream readers replay the chunk sequence (a vertex output can
feed several consumers — shared-work reuse, semijoin producers — so chunks
are retained until the whole query finishes).

Memory is bounded: the in-memory buffer holds at most ``buffer_rows`` rows /
``buffer_bytes`` bytes per exchange; overflow chunks spill to a per-query
scratch directory and are transparently re-loaded when a reader reaches
them.  With spill disabled (session config ``exchange.spill = False``) an
overflowing exchange raises :class:`MemoryPressureError` instead, feeding
the §4.2 re-optimization path.

``put`` never blocks — downstream backpressure is absorbed by the
spill-to-disk path, which is what lets upstream vertices keep running while
the client drains first rows from the root.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

from ...analysis.lockdep import make_condition
from ..obs import clock
from ..obs.trace import note_exchange_wait, note_spill_io
from .exec import MemoryPressureError
from .vector import VectorBatch

# Defaults for the session config knobs (see session.DEFAULT_CONFIG).
DEFAULT_BUFFER_ROWS = 1 << 16
DEFAULT_BUFFER_BYTES = 64 << 20


def batch_nbytes(batch: VectorBatch) -> int:
    return int(sum(v.nbytes for v in batch.cols.values()))


class ExchangeConfig:
    """Per-query exchange policy, resolved once from the session config."""

    def __init__(self, config: Optional[dict] = None, scratch_dir: Optional[str] = None):
        config = config or {}
        self.buffer_rows = int(
            config.get("exchange.buffer_rows", DEFAULT_BUFFER_ROWS)
            or DEFAULT_BUFFER_ROWS
        )
        self.buffer_bytes = int(
            config.get("exchange.buffer_bytes", DEFAULT_BUFFER_BYTES)
            or DEFAULT_BUFFER_BYTES
        )
        self.spill = bool(config.get("exchange.spill", True))
        # runtime schema sanitizer (lockdep pattern: resolved once per query,
        # zero overhead on put() unless enabled AND a schema is declared)
        self.check_batches = bool(os.environ.get("REPRO_CHECK_BATCHES")
                                  or config.get("debug.check_batches"))
        self.scratch_dir = scratch_dir
        self._own_scratch = False
        # observability (PR 10), resolved once per query like check_batches:
        # ``trace`` is the query's QueryTrace (None = tracing off — every
        # hot-path site pays one attribute test and allocates nothing),
        # ``metrics`` the warehouse MetricsRegistry for spill counters.
        # Both set by the execute stage / DAG scheduler, never from config.
        self.trace = None
        self.metrics = None

    def make_scratch(self) -> str:
        if self.scratch_dir is None:
            import tempfile

            self.scratch_dir = tempfile.mkdtemp(prefix="repro_exchange_")
            self._own_scratch = True
        os.makedirs(self.scratch_dir, exist_ok=True)
        return self.scratch_dir

    def cleanup(self) -> None:
        """Remove an auto-created scratch directory (query teardown)."""
        if self._own_scratch and self.scratch_dir is not None:
            import shutil

            shutil.rmtree(self.scratch_dir, ignore_errors=True)
            self.scratch_dir = None
            self._own_scratch = False


class _MemSlot:
    __slots__ = ("batch",)

    def __init__(self, batch: VectorBatch):
        self.batch = batch


class _DiskSlot:
    __slots__ = ("path",)

    def __init__(self, path: str):
        self.path = path


def _save_chunk(path: str, batch: VectorBatch) -> None:
    names = np.array(batch.column_names)
    data = {f"c{i}": v for i, v in enumerate(batch.cols.values())}
    with open(path, "wb") as f:
        np.savez(f, __names__=names, **data)


def _load_chunk(path: str) -> VectorBatch:
    with np.load(path, allow_pickle=False) as z:
        names = [str(n) for n in z["__names__"]]
        return VectorBatch({n: z[f"c{i}"] for i, n in enumerate(names)})


class Exchange:
    """One producer, N replaying readers, bounded memory via spill.

    ``buffer_rows``/``buffer_bytes`` default to the query-wide budgets in
    ``cfg`` but can be overridden per exchange — the shuffle service gives
    every partition lane a full edge budget of its own (the Tez
    per-partition buffer model: a partitioned edge may buffer up to N× the
    configured ``exchange.buffer_*`` before lanes spill)."""

    def __init__(self, tag: str, cfg: ExchangeConfig,
                 buffer_rows: Optional[int] = None,
                 buffer_bytes: Optional[int] = None):
        self.tag = tag
        self.cfg = cfg
        self.buffer_rows = int(buffer_rows if buffer_rows is not None
                               else cfg.buffer_rows)
        self.buffer_bytes = int(buffer_bytes if buffer_bytes is not None
                                else cfg.buffer_bytes)
        self._slots: List[object] = []
        self._cond = make_condition(name="exchange")
        self._closed = False
        self._error: Optional[BaseException] = None
        self._mem_rows = 0
        self._mem_bytes = 0
        self._spill_seq = 0
        # multi-consumer edges replay the full chunk sequence, so chunks are
        # retained until query teardown; the DAG scheduler flips this off
        # for single-consumer FORWARD edges, which then free each chunk
        # (memory and spill file) the moment its one reader consumes it
        self.retain = True
        # metrics surfaced through DAGScheduler -> QueryHandle.poll()
        self.total_rows = 0
        self.spilled_rows = 0
        self.spilled_bytes = 0
        self.spilled_chunks = 0
        self.peak_buffered_rows = 0
        self.freed_chunks = 0
        # declared edge schema (repro_torch.core.schema.Schema) — set by the DAG
        # scheduler from the producer vertex's inferred plan schema.
        # ``_verify`` is non-None only when cfg.check_batches is on AND a
        # schema is known: the put() hot path pays one attribute test.
        self.schema = None
        self._verify = None

    def declare_schema(self, schema) -> None:
        """Declare the edge's column contract; under ``REPRO_CHECK_BATCHES``
        / ``debug.check_batches`` every put() asserts conformance."""
        self.schema = schema
        self._verify = schema if (schema is not None
                                  and self.cfg.check_batches) else None

    # ------------------------------------------------------------ producer
    def put(self, batch: VectorBatch) -> None:
        if self._verify is not None:
            self._verify.check_batch(batch, context=f"exchange {self.tag}")
        n = batch.num_rows
        nbytes = batch_nbytes(batch)
        with self._cond:
            if self._closed:
                return
            overflow = n > 0 and (
                self._mem_rows + n > self.buffer_rows
                or self._mem_bytes + nbytes > self.buffer_bytes
            )
            if overflow and not self.cfg.spill:
                raise MemoryPressureError(
                    f"exchange {self.tag} over budget "
                    f"({self._mem_rows + n} rows / "
                    f"{self._mem_bytes + nbytes} bytes buffered, "
                    f"budget {self.buffer_rows} rows / "
                    f"{self.buffer_bytes} bytes) and exchange.spill is off"
                )
            if overflow:
                # unique per process + exchange instance: vertex tags (v1,
                # v2, ...) repeat across queries that may share a configured
                # exchange.spill_dir
                path = os.path.join(
                    self.cfg.make_scratch(),
                    f"{self.tag}_{os.getpid():x}_{id(self):x}"
                    f"_{self._spill_seq:06d}.npz",
                )
                self._spill_seq += 1
                if self.cfg.trace is not None:
                    t_io = clock.perf_counter()
                    _save_chunk(path, batch)
                    note_spill_io(clock.perf_counter() - t_io)
                else:
                    _save_chunk(path, batch)
                self._slots.append(_DiskSlot(path))
                self.spilled_rows += n
                self.spilled_bytes += nbytes
                self.spilled_chunks += 1
                if self.cfg.metrics is not None:
                    self.cfg.metrics.inc("exchange.spilled_chunks")
                    self.cfg.metrics.inc("exchange.spilled_rows", n)
                    self.cfg.metrics.inc("exchange.spilled_bytes", nbytes)
            else:
                self._slots.append(_MemSlot(batch))
                self._mem_rows += n
                self._mem_bytes += nbytes
                self.peak_buffered_rows = max(self.peak_buffered_rows,
                                              self._mem_rows)
            self.total_rows += n
            self._cond.notify_all()

    def close(self, error: Optional[BaseException] = None) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._error = error
            self._cond.notify_all()

    # ------------------------------------------------------------ consumers
    def available(self, i: int) -> bool:
        """Would ``reader()``'s next step at position ``i`` return without
        blocking?  True when chunk ``i`` exists or the stream is closed
        (end-of-stream / error both resolve immediately).  The adaptive
        layer's swappable sources poll this to drain an exchange without
        ever committing to a blocking wait."""
        with self._cond:
            return i < len(self._slots) or self._closed

    def failed(self) -> bool:
        """True when the producer closed this exchange with an error."""
        with self._cond:
            return self._error is not None

    def reader(self) -> Iterator[VectorBatch]:
        """A pass over the full chunk sequence (blocking iterator).

        With ``retain`` off (single-consumer edges) each slot is released
        as soon as it is handed to the reader: buffered memory is returned
        to the budget and spill files are unlinked after loading.
        """
        i = 0
        while True:
            with self._cond:
                if self.cfg.trace is not None and i >= len(self._slots) \
                        and not self._closed:
                    # blocking wait: charge it to the consuming vertex's
                    # exchange-wait sub-phase (thread-local frame)
                    t_wait = clock.perf_counter()
                    while i >= len(self._slots) and not self._closed:
                        self._cond.wait(0.05)
                    note_exchange_wait(clock.perf_counter() - t_wait)
                else:
                    while i >= len(self._slots) and not self._closed:
                        self._cond.wait(0.05)
                if i < len(self._slots):
                    slot = self._slots[i]
                    if slot is None:
                        raise RuntimeError(
                            f"exchange {self.tag}: chunk {i} already freed "
                            f"(single-consumer edge read twice)"
                        )
                    if not self.retain:
                        self._slots[i] = None
                        self.freed_chunks += 1
                        if isinstance(slot, _MemSlot):
                            self._mem_rows -= slot.batch.num_rows
                            self._mem_bytes -= batch_nbytes(slot.batch)
                elif self._error is not None:
                    raise self._error
                else:
                    return
            i += 1
            if isinstance(slot, _MemSlot):
                yield slot.batch
            else:
                if self.cfg.trace is not None:
                    t_io = clock.perf_counter()
                    batch = _load_chunk(slot.path)
                    note_spill_io(clock.perf_counter() - t_io)
                else:
                    batch = _load_chunk(slot.path)
                if not self.retain:
                    try:
                        os.unlink(slot.path)
                    except OSError:  # pragma: no cover - already gone
                        pass
                yield batch

    def read_all(self) -> VectorBatch:
        chunks = list(self.reader())
        if not chunks:
            # keep the declared schema on zero-row results instead of
            # collapsing to a columnless batch
            return VectorBatch.empty(self.schema) if self.schema is not None \
                else VectorBatch({})
        return VectorBatch.concat(chunks, context=f"exchange {self.tag}")

    # ------------------------------------------------------------ teardown
    def stats(self) -> Dict[str, int]:
        with self._cond:
            return {
                "rows": self.total_rows,
                "spilled_rows": self.spilled_rows,
                "spilled_bytes": self.spilled_bytes,
                "spilled_chunks": self.spilled_chunks,
                "peak_buffered_rows": self.peak_buffered_rows,
                "freed_chunks": self.freed_chunks,
            }

    def discard(self) -> None:
        """Release buffered chunks and delete this exchange's spill files."""
        with self._cond:
            slots, self._slots = self._slots, []
            self._closed = True
            self._mem_rows = self._mem_bytes = 0
        for slot in slots:
            if isinstance(slot, _DiskSlot):
                try:
                    os.unlink(slot.path)
                except OSError:
                    pass
