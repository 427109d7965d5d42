"""In-memory DataSource connector for tests and benchmarks.

``memtable`` serves tables held in process memory with *configurable
production latency and batch size*, which makes streaming behavior
observable: a reader that sleeps ``latency_s`` per produced morsel lets
tests assert that the first batch reached the client **before** the
connector finished producing, and that splits ran in parallel through the
exchange layer.

Capabilities: filter pushdown (evaluated vectorized against the stored
batch), projection, and per-split (partial) limit.  Aggregates stay local
on purpose, so queries over memtable exercise the residual/merge paths.

Tables are keyed ``schema.table`` (default schema ``default``); rows can be
loaded either as a ``VectorBatch`` or as a list of dicts with possibly
heterogeneous keys (routed through :class:`SerDe.deserialize`, which
null-fills missing columns).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ...analysis.lockdep import make_lock
from ..metastore import TableDesc
from ..obs import clock
from ..runtime.vector import DEFAULT_BATCH_ROWS, VectorBatch
from ..sql import ast as A
from .datasource import NONE, PARTIAL, ScanBuilder, Writer
from .handler import SerDe, StorageHandler


class MemTableHandler(StorageHandler):
    name = "memtable"
    default_schema = "default"

    def __init__(self, latency_s: float = 0.0, batch_rows: int = 0):
        self.tables: Dict[str, VectorBatch] = {}
        self.latency_s = float(latency_s)
        self.batch_rows = int(batch_rows)
        self._lock = make_lock("federation.memtable")
        # remote statistics cache (planning runs per query; the per-column
        # NDV scans should not) — dropped whenever a table is (re)loaded
        self._stats_cache: Dict[str, object] = {}
        # production telemetry (streaming tests/benchmarks read these)
        self.produced: List[Tuple[float, int]] = []  # (monotonic time, rows)
        self.active_readers = 0
        self.peak_active_readers = 0

    @classmethod
    def from_props(cls, props: Dict[str, str]) -> "MemTableHandler":
        return cls(latency_s=float(props.get("latency_s", 0) or 0),
                   batch_rows=int(props.get("batch_rows", 0) or 0))

    # ---- table management -----------------------------------------------------
    def _key(self, schema: str, table: str) -> str:
        return f"{schema}.{table}"

    def load(self, name: str, data, schema: Optional[str] = None) -> None:
        """Load a table; ``data`` is a VectorBatch or a list of row dicts
        (heterogeneous keys allowed — missing values are null-filled)."""
        if not isinstance(data, VectorBatch):
            data = self.serde.deserialize(list(data))
        key = self._key(schema or self.default_schema, name) \
            if "." not in name else name
        with self._lock:
            self.tables[key] = data
            self._stats_cache.pop(key, None)

    def _resolve_key(self, table: TableDesc) -> str:
        """The storage key a TableDesc addresses (the key load() writes)."""
        key = table.props.get("memtable.table", table.name)
        with self._lock:
            if key in self.tables:
                return key
        return self._key(self.default_schema, key) if "." not in key else key

    def _resolve(self, table: TableDesc) -> VectorBatch:
        key = self._resolve_key(table)
        with self._lock:
            return self.tables.get(key, VectorBatch({}))

    # ---- telemetry ------------------------------------------------------------
    def reset_telemetry(self) -> None:
        with self._lock:
            self.produced = []
            self.active_readers = 0
            self.peak_active_readers = 0

    def note_produced(self, rows: int) -> None:
        with self._lock:
            self.produced.append((clock.monotonic(), rows))

    def last_produced_at(self) -> Optional[float]:
        with self._lock:
            return self.produced[-1][0] if self.produced else None

    def _reader_enter(self) -> None:
        with self._lock:
            self.active_readers += 1
            self.peak_active_readers = max(self.peak_active_readers,
                                           self.active_readers)

    def _reader_exit(self) -> None:
        with self._lock:
            self.active_readers -= 1

    # ---- connector surface ----------------------------------------------------
    def scan_builder(self, table: TableDesc, config=None) -> "MemTableScanBuilder":
        return MemTableScanBuilder(self, table, config)

    def writer(self, table: TableDesc) -> "MemTableWriter":
        return MemTableWriter(self, table)

    def infer_schema(self, props: Dict[str, str]):
        key = props.get("memtable.table")
        return self.discover(None, key) if key else None

    def list_schemas(self) -> List[str]:
        with self._lock:
            schemas = sorted({k.split(".", 1)[0] for k in self.tables})
        return schemas or [self.default_schema]

    def list_tables(self, schema: str) -> List[str]:
        prefix = f"{schema}."
        with self._lock:
            return sorted(k[len(prefix):] for k in self.tables
                          if k.startswith(prefix))

    def discover(self, schema: Optional[str], table: str):
        key = table if "." in table else \
            self._key(schema or self.default_schema, table)
        with self._lock:
            batch = self.tables.get(key)
        if batch is None:
            return None
        kinds = {"i": "BIGINT", "u": "BIGINT", "f": "DOUBLE", "b": "BOOLEAN"}
        return [(c, "FLOAT" if v.dtype == np.float32
                 else kinds.get(v.dtype.kind, "STRING"))
                for c, v in batch.cols.items()]

    def table_props(self, schema: str, table: str) -> Dict[str, str]:
        return {"memtable.table": self._key(schema, table)}


class MemTableScanBuilder(ScanBuilder):
    def estimate_stats(self):
        from .datasource import stats_from_batch

        h: MemTableHandler = self.handler
        key = h._resolve_key(self.table)
        with h._lock:
            cached = h._stats_cache.get(key)
        if cached is not None:
            return cached
        stats = stats_from_batch(h._resolve(self.table))
        with h._lock:
            h._stats_cache[key] = stats
        return stats

    def push_filters(self, conjuncts: List[A.Expr]) -> List[A.Expr]:
        table_cols = {c for c, _ in self.table.schema}
        residual = []
        for c in conjuncts:
            cols = {n.name for n in A.walk(c) if isinstance(n, A.Col)}
            if cols and cols <= table_cols and _evaluable(c):
                self.spec.filters.append(c)
            else:
                residual.append(c)
        return residual

    def push_projection(self, columns: List[str]) -> bool:
        self.spec.projection = list(columns)
        return True

    def push_limit(self, n: int, sort) -> str:
        if sort:
            return NONE  # memtable returns storage order
        self.spec.limit = int(n)
        self.spec.limit_mode = PARTIAL  # per-split limit, merged locally
        return PARTIAL

    # ---- execution --------------------------------------------------------
    def to_splits(self) -> List[object]:
        batch = self.handler._resolve(self.table)
        n = batch.num_rows
        want = max(int(self.config.get("federation.splits", 1) or 1), 1)
        if n == 0 or want <= 1:
            return [(0, n)]
        want = min(want, max(n, 1))
        bounds = np.linspace(0, n, want + 1).astype(int)
        return [(int(lo), int(hi)) for lo, hi in zip(bounds[:-1], bounds[1:])
                if hi > lo]

    def read_split(self, split) -> Iterator[VectorBatch]:
        handler: MemTableHandler = self.handler
        lo, hi = split if split is not None else (0, None)
        batch = handler._resolve(self.table)
        part = batch.slice(lo, batch.num_rows if hi is None else hi)
        from ..runtime.exec import eval_expr

        for f in self.spec.filters:
            if part.num_rows:
                part = part.select(eval_expr(f, part, None).astype(bool))
        if self.spec.projection is not None:
            part = part.project([c for c in self.spec.projection
                                 if c in part.cols])
        if self.spec.limit is not None:
            part = part.slice(0, self.spec.limit)
        rows = handler.batch_rows or int(
            self.config.get("exchange.batch_rows", DEFAULT_BATCH_ROWS)
            or DEFAULT_BATCH_ROWS)
        handler._reader_enter()
        try:
            if part.num_rows == 0:
                handler.note_produced(0)
                yield part if part.cols else self.empty_batch()
                return
            for chunk in part.iter_chunks(rows):
                if handler.latency_s:
                    time.sleep(handler.latency_s)
                handler.note_produced(chunk.num_rows)
                yield chunk
        finally:
            handler._reader_exit()


class MemTableWriter(Writer):
    def __init__(self, handler: MemTableHandler, table: TableDesc):
        self.handler = handler
        self.table = table
        self._pending: List[VectorBatch] = []

    def write_batch(self, batch: VectorBatch) -> None:
        if batch.num_rows:
            self._pending.append(batch)

    def commit(self) -> None:
        if not self._pending:
            return
        key = self.table.props.get("memtable.table", self.table.name)
        h = self.handler
        with h._lock:
            prev = h.tables.get(key)
            parts = ([prev] if prev is not None and prev.num_rows else []) \
                + self._pending
            h.tables[key] = VectorBatch.concat(parts)
            h._stats_cache.pop(key, None)
        self._pending = []


def _evaluable(e: A.Expr) -> bool:
    """Only expression forms the vectorized evaluator handles make it in."""
    ok = (A.Col, A.Lit, A.BinOp, A.UnOp, A.Between, A.InList, A.IsNull, A.Case,
          A.Cast)
    return all(isinstance(x, ok) for x in A.walk(e))
