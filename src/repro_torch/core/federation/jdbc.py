"""JDBC connector (paper §6.2 "multiple engines with JDBC support").

Calcite can generate SQL in many dialects; here the external RDBMS is an
embedded sqlite3 database.  The :class:`JdbcScanBuilder` negotiates pushdown
capability-by-capability — filters translate conjunct-by-conjunct into SQL
(untranslatable ones stay local), projection narrows the SELECT list,
aggregates/sort/limit fold into the generated statement — and plain scans
split into ``rowid % N`` shards that stream morsels through a server-side
cursor (``fetchmany``), so large remote tables never materialize in one
batch.
"""
from __future__ import annotations

import sqlite3
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ...analysis.lockdep import make_lock
from ..metastore import TableDesc
from ..runtime.vector import DEFAULT_BATCH_ROWS, VectorBatch
from ..sql import ast as A
from .datasource import FULL, NONE, ScanBuilder, Writer
from .handler import StorageHandler


class JdbcHandler(StorageHandler):
    name = "jdbc"
    default_schema = "main"

    def __init__(self, db_path: str = ":memory:"):
        self.conn = sqlite3.connect(db_path, check_same_thread=False)
        self._lock = make_lock("federation.jdbc")
        self.queries_served: List[str] = []
        # remote statistics cache (planning runs per query; the remote
        # COUNT/NDV probes should not) — dropped whenever this handler writes
        self._stats_cache: Dict[str, object] = {}

    @classmethod
    def from_props(cls, props: Dict[str, str]) -> "JdbcHandler":
        return cls(props.get("db", props.get("jdbc.db", ":memory:")))

    # ---- external-side table management (for tests/benchmarks) ----------------
    def load_table(self, name: str, batch: VectorBatch) -> None:
        cols = batch.column_names
        decls = ", ".join(f'"{c}" {_sqlite_type(batch.cols[c])}' for c in cols)
        with self._lock:
            self.conn.execute(f'DROP TABLE IF EXISTS "{name}"')
            self.conn.execute(f'CREATE TABLE "{name}" ({decls})')
            rows = batch.to_rows()
            ph = ",".join("?" * len(cols))
            self.conn.executemany(f'INSERT INTO "{name}" VALUES ({ph})',
                                  [tuple(_py(v) for v in r) for r in rows])
            self.conn.commit()
            self._stats_cache.pop(name, None)

    # ---- scan path ------------------------------------------------------------
    def scan_builder(self, table: TableDesc, config=None) -> "JdbcScanBuilder":
        return JdbcScanBuilder(self, table, config)

    # ---- write path -----------------------------------------------------------
    def writer(self, table: TableDesc) -> "JdbcWriter":
        return JdbcWriter(self, table)

    # ---- schema inference / catalog surface -----------------------------------
    def infer_schema(self, props: Dict[str, str]):
        remote = props.get("jdbc.table")
        return self.discover(self.default_schema, remote) if remote else None

    def list_tables(self, schema: str) -> List[str]:
        with self._lock:
            rows = self.conn.execute(
                "SELECT name FROM sqlite_master WHERE type='table'"
                " ORDER BY name").fetchall()
        return [r[0] for r in rows]

    def discover(self, schema: str, table: str):
        with self._lock:
            rows = self.conn.execute(f'PRAGMA table_info("{table}")').fetchall()
        if not rows:
            return None
        m = {"INTEGER": "BIGINT", "REAL": "DOUBLE", "TEXT": "STRING"}
        return [(r[1], m.get((r[2] or "TEXT").upper(), "STRING")) for r in rows]

    def table_props(self, schema: str, table: str) -> Dict[str, str]:
        return {"jdbc.table": table}


class JdbcScanBuilder(ScanBuilder):
    """SQL-generating negotiation (paper §6.2 footnote 4)."""

    def __init__(self, handler: JdbcHandler, table: TableDesc, config=None):
        super().__init__(handler, table, config)
        self._where: List[str] = []

    # ---- negotiation ------------------------------------------------------
    def push_filters(self, conjuncts: List[A.Expr]) -> List[A.Expr]:
        residual = []
        for c in conjuncts:
            sql = _expr_to_sql(c)
            if sql is None:
                residual.append(c)
            else:
                self.spec.filters.append(c)
                self._where.append(sql)
        return residual

    def push_projection(self, columns: List[str]) -> bool:
        self.spec.projection = list(columns)
        return True

    def push_aggregate(self, group_keys, aggs) -> str:
        if any(fn not in ("sum", "count", "min", "max") for fn, _, _ in aggs):
            return NONE
        from .datasource import AggPush

        self.spec.agg = AggPush(list(group_keys), list(aggs), FULL)
        return FULL

    def push_limit(self, n: int, sort) -> str:
        self.spec.limit = int(n)
        self.spec.limit_mode = FULL
        self.spec.sort = list(sort)
        return FULL

    # ---- statistics -------------------------------------------------------
    def estimate_stats(self):
        """Remote row-count + per-column NDV/min/max via generated SQL
        (COUNT(*) / COUNT(DISTINCT c) / MIN / MAX), cached per table on the
        handler until its next write."""
        from .datasource import RemoteColumnStats, RemoteTableStats

        remote = self._remote()
        h = self.handler
        with h._lock:
            cached = h._stats_cache.get(remote)
        if cached is not None:
            return cached
        cols = [c for c, _ in self.table.schema]
        sel = ["COUNT(*)"]
        for c in cols:
            sel += [f'COUNT(DISTINCT "{c}")', f'MIN("{c}")', f'MAX("{c}")']
        sql = f'SELECT {", ".join(sel)} FROM "{remote}"'
        with h._lock:
            try:
                row = h.conn.execute(sql).fetchone()
            except sqlite3.Error:
                return None
        stats = RemoteTableStats(row_count=float(row[0]))
        for i, c in enumerate(cols):
            ndv, mn, mx = row[1 + 3 * i: 4 + 3 * i]
            stats.columns[c] = RemoteColumnStats(
                ndv=int(ndv or 0), min_value=mn, max_value=mx)
        with h._lock:
            h._stats_cache[remote] = stats
        return stats

    # ---- execution --------------------------------------------------------
    def _remote(self) -> str:
        return self.table.props.get("jdbc.table", self.table.name)

    def _sql(self, split) -> str:
        spec = self.spec
        if spec.agg is not None:
            sel = [f'"{k}"' for k in spec.agg.group_keys]
            for fn, arg, _out in spec.agg.aggs:
                sel.append(f"{fn.upper()}({_quote(arg) if arg else '*'})")
            group = ", ".join(f'"{k}"' for k in spec.agg.group_keys)
        else:
            sel = [f'"{c}"' for c in self.output_columns()]
            group = ""
        where = list(self._where)
        if split is not None and split[0] == "mod":
            _, i, n = split
            where.append(f"(rowid % {n}) = {i}")
        sql = f'SELECT {", ".join(sel)} FROM "{self._remote()}"'
        if where:
            sql += " WHERE " + " AND ".join(where)
        if group:
            sql += f" GROUP BY {group}"
        if spec.sort:
            sql += " ORDER BY " + ", ".join(
                f"{pos + 1} {'DESC' if d else 'ASC'}" for pos, d in spec.sort)
        if spec.limit is not None:
            sql += f" LIMIT {spec.limit}"
        return sql

    def to_splits(self) -> List[object]:
        spec = self.spec
        if spec.agg is not None or spec.limit is not None:
            return [("all",)]
        n = max(int(self.config.get("federation.splits", 1) or 1), 1)
        if n <= 1:
            return [("all",)]
        return [("mod", i, n) for i in range(n)]

    def read_split(self, split) -> Iterator[VectorBatch]:
        sql = self._sql(split)
        self.handler.queries_served.append(sql)
        batch_rows = int(self.config.get("exchange.batch_rows",
                                         DEFAULT_BATCH_ROWS) or DEFAULT_BATCH_ROWS)
        names = self.output_columns()
        # hold the connection lock only around each fetch, never across a
        # yield: concurrent split readers (and writers) interleave instead
        # of serializing behind one suspended generator
        with self.handler._lock:
            cur = self.handler.conn.execute(sql)
        while True:
            with self.handler._lock:
                rows = cur.fetchmany(batch_rows)
            if not rows:
                break
            yield VectorBatch({
                n: _column([r[i] for r in rows])
                for i, n in enumerate(names)
            })


class JdbcWriter(Writer):
    def __init__(self, handler: JdbcHandler, table: TableDesc):
        self.handler = handler
        self.table = table
        self._created = False
        self._pending: List[VectorBatch] = []

    def write_batch(self, batch: VectorBatch) -> None:
        if batch.num_rows == 0:
            return
        remote = self.table.props.get("jdbc.table", self.table.name)
        h = self.handler
        with h._lock:
            if not self._created:
                exists = h.conn.execute(
                    "SELECT name FROM sqlite_master WHERE type='table'"
                    " AND name=?", (remote,)).fetchone()
                if exists is None:
                    decls = ", ".join(
                        f'"{c}" {_sqlite_type(batch.cols[c])}'
                        for c in batch.column_names)
                    h.conn.execute(f'CREATE TABLE "{remote}" ({decls})')
                self._created = True
            ph = ",".join("?" * len(batch.column_names))
            h.conn.executemany(
                f'INSERT INTO "{remote}" VALUES ({ph})',
                [tuple(_py(v) for v in r) for r in batch.to_rows()],
            )

    def commit(self) -> None:
        with self.handler._lock:
            self.handler.conn.commit()
            remote = self.table.props.get("jdbc.table", self.table.name)
            self.handler._stats_cache.pop(remote, None)

    def abort(self) -> None:
        """Roll back uncommitted batches so a failed multi-batch write
        cannot be made durable by the next unrelated commit."""
        with self.handler._lock:
            self.handler.conn.rollback()


def _expr_to_sql(e: A.Expr) -> Optional[str]:
    """Raw-column expression -> sqlite SQL; None when untranslatable."""
    if isinstance(e, A.Col):
        return f'"{e.name}"' if e.table is None else None
    if isinstance(e, A.Lit):
        if isinstance(e.value, str):
            return "'" + e.value.replace("'", "''") + "'"
        if e.value is None:
            return "NULL"
        if isinstance(e.value, bool):
            return "1" if e.value else "0"
        return repr(e.value)
    if isinstance(e, A.BinOp):
        l, r = _expr_to_sql(e.left), _expr_to_sql(e.right)
        if l is None or r is None:
            return None
        op = {"AND": "AND", "OR": "OR", "=": "=", "!=": "<>", "LIKE": "LIKE"}.get(
            e.op, e.op
        )
        return f"({l} {op} {r})"
    if isinstance(e, A.UnOp):
        v = _expr_to_sql(e.operand)
        return None if v is None else (f"(NOT {v})" if e.op == "NOT" else f"(-{v})")
    if isinstance(e, A.Between):
        v = _expr_to_sql(e.expr)
        lo = _expr_to_sql(e.low)
        hi = _expr_to_sql(e.high)
        if None in (v, lo, hi):
            return None
        neg = "NOT " if e.negated else ""
        return f"({v} {neg}BETWEEN {lo} AND {hi})"
    if isinstance(e, A.InList):
        v = _expr_to_sql(e.expr)
        vals = [_expr_to_sql(x) for x in e.values]
        if v is None or None in vals:
            return None
        neg = "NOT " if e.negated else ""
        return f"({v} {neg}IN ({', '.join(vals)}))"
    return None


def _column(vals: list) -> np.ndarray:
    """SQL NULLs -> NaN (numeric) / "" (text), keeping dtypes non-object."""
    if any(v is None for v in vals):
        if all(v is None or isinstance(v, (int, float)) for v in vals):
            return np.array([np.nan if v is None else float(v) for v in vals])
        return np.array(["" if v is None else str(v) for v in vals])
    return np.array(vals)


def _quote(name: str) -> str:
    return '"' + name.replace('"', '""') + '"'


def _sqlite_type(arr: np.ndarray) -> str:
    return {"i": "INTEGER", "u": "INTEGER", "f": "REAL", "b": "INTEGER"}.get(
        arr.dtype.kind, "TEXT"
    )


def _py(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.str_):
        return str(v)
    return v
