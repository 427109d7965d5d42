"""Druid connector (paper §6.1-§6.2, Figures 6 & 8).

An embedded columnar mini-OLAP store standing in for Apache Druid: data
sources are time-partitioned columnar segments optimized for filtered
groupBy/topN aggregations.  The :class:`DruidScanBuilder` negotiates:

  * filters -> Druid filter JSON, conjunct-by-conjunct (untranslatable
    conjuncts stay local as a residual Filter);
  * projection -> scan-query column list;
  * aggregates -> groupBy / timeseries queries.  With multiple segments the
    pushdown is **partial**: each segment split returns per-segment partial
    aggregates and the warehouse's local Aggregate merges them (the paper's
    "handlers may split pushed queries into parallel sub-queries");
  * limit (+sort) -> ``limitSpec``, full only over a single split.

Splits map to segments and stream morsels through the exchange layer.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..metastore import TableDesc
from ..runtime.vector import DEFAULT_BATCH_ROWS, VectorBatch
from ..sql import ast as A
from .datasource import FULL, NONE, PARTIAL, AggPush, ScanBuilder, Writer
from .handler import StorageHandler


class DruidSegment:
    """One time-chunked columnar segment."""

    def __init__(self, batch: VectorBatch):
        self.batch = batch

    @property
    def num_rows(self):
        return self.batch.num_rows


class DruidStore:
    """The embedded 'cluster': datasource name -> list of segments."""

    def __init__(self, segment_rows: int = 100_000):
        self.datasources: Dict[str, List[DruidSegment]] = {}
        self.segment_rows = segment_rows
        self.queries_served: List[dict] = []
        self._stats_cache: Dict[str, object] = {}

    def create_datasource(self, name: str, batch: VectorBatch) -> None:
        segs = [
            DruidSegment(batch.slice(i, min(i + self.segment_rows, batch.num_rows)))
            for i in range(0, max(batch.num_rows, 1), self.segment_rows)
        ]
        self.datasources[name] = segs
        self._stats_cache.pop(name, None)

    def append(self, name: str, batch: VectorBatch) -> None:
        if name not in self.datasources:
            self.create_datasource(name, batch)
        else:
            self.datasources[name].append(DruidSegment(batch))
            self._stats_cache.pop(name, None)

    def stats(self, name: str):
        """Datasource row-count/NDV estimates (sampled per segment)."""
        if name not in self._stats_cache:
            from .datasource import stats_from_batch

            segs = self.datasources.get(name)
            if not segs:
                return None
            sample = VectorBatch.concat(
                [s.batch.slice(0, 1 << 15) for s in segs])
            stats = stats_from_batch(sample)
            stats.row_count = float(sum(s.num_rows for s in segs))
            self._stats_cache[name] = stats
        return self._stats_cache[name]

    def schema(self, name: str) -> Optional[List[Tuple[str, str]]]:
        segs = self.datasources.get(name)
        if not segs:
            return None
        out = []
        for col, arr in segs[0].batch.cols.items():
            kind = arr.dtype.kind
            sql_t = {"i": "BIGINT", "u": "BIGINT", "f": "DOUBLE", "b": "BOOLEAN"}.get(
                kind, "STRING"
            )
            out.append((col, sql_t))
        return out


class DruidHandler(StorageHandler):
    name = "druid"

    def __init__(self, store: Optional[DruidStore] = None):
        self.store = store or DruidStore()

    @classmethod
    def from_props(cls, props: Dict[str, str]) -> "DruidHandler":
        return cls(DruidStore(int(props.get("segment_rows", 100_000))))

    # ---- scan path -------------------------------------------------------------
    def scan_builder(self, table: TableDesc, config=None) -> "DruidScanBuilder":
        return DruidScanBuilder(self, table, config)

    # ---- write path ------------------------------------------------------------
    def writer(self, table: TableDesc) -> "DruidWriter":
        return DruidWriter(self, table)

    # ---- schema inference / catalog surface -------------------------------------
    def infer_schema(self, props: Dict[str, str]):
        src = props.get("druid.datasource")
        return self.store.schema(src) if src else None

    def list_tables(self, schema: str) -> List[str]:
        return sorted(self.store.datasources)

    def discover(self, schema: str, table: str):
        return self.store.schema(table)

    def table_props(self, schema: str, table: str) -> Dict[str, str]:
        return {"druid.datasource": table}


class DruidScanBuilder(ScanBuilder):
    """Plan -> Druid JSON negotiation (paper §6.2, Figure 6)."""

    def __init__(self, handler: DruidHandler, table: TableDesc, config=None):
        super().__init__(handler, table, config)
        self._dfilters: List[dict] = []
        self._recorded = False

    def _segments(self) -> List[DruidSegment]:
        src = self.table.props.get("druid.datasource", self.table.name)
        return self.handler.store.datasources.get(src, [])

    def estimate_stats(self):
        src = self.table.props.get("druid.datasource", self.table.name)
        return self.handler.store.stats(src)

    # ---- negotiation ------------------------------------------------------
    def push_filters(self, conjuncts: List[A.Expr]) -> List[A.Expr]:
        residual = []
        for c in conjuncts:
            f = _one_filter(c)
            if f is None:
                residual.append(c)
            else:
                self.spec.filters.append(c)
                self._dfilters.append(f)
        return residual

    def push_projection(self, columns: List[str]) -> bool:
        self.spec.projection = list(columns)
        return True

    def push_aggregate(self, group_keys, aggs) -> str:
        druid_aggs = []
        for fn, arg, out in aggs:
            if fn == "count" and arg is None:
                druid_aggs.append({"type": "count", "name": out})
                continue
            ty = {"sum": "doubleSum", "min": "doubleMin", "max": "doubleMax",
                  "count": "count"}.get(fn)
            if ty is None or arg is None:
                return NONE
            druid_aggs.append({"type": ty, "name": out, "fieldName": arg})
        mode = PARTIAL if len(self._segments()) > 1 else FULL
        self.spec.agg = AggPush(list(group_keys), list(aggs), mode)
        self._druid_aggs = druid_aggs
        return mode

    def push_limit(self, n: int, sort) -> str:
        if self.spec.agg is not None and self.spec.agg.mode != FULL:
            return NONE  # per-segment partial aggregates can't be top-n'd
        # scan-type queries push sorted top-n too: each segment split issues
        # a sorted scan with a limitSpec, and with multiple segments the
        # local Sort+Limit stay as the merge (PARTIAL) instead of bailing to
        # a local-only sort over every remote row
        mode = FULL if len(self.to_splits()) <= 1 or self.spec.agg is not None \
            else PARTIAL
        self.spec.limit = int(n)
        self.spec.sort = list(sort)
        self.spec.limit_mode = mode
        return mode

    # ---- the native query -------------------------------------------------
    def native_query(self) -> dict:
        spec = self.spec
        src = self.table.props.get("druid.datasource", self.table.name)
        q: dict = {"queryType": "scan", "dataSource": src, "granularity": "all"}
        if self._dfilters:
            q["filter"] = (self._dfilters[0] if len(self._dfilters) == 1
                           else {"type": "and", "fields": list(self._dfilters)})
        if spec.agg is not None:
            q["queryType"] = "groupBy" if spec.agg.group_keys else "timeseries"
            q["dimensions"] = list(spec.agg.group_keys)
            q["aggregations"] = list(self._druid_aggs)
        else:
            q["columns"] = self.output_columns()
        if spec.limit is not None:
            names = self.output_columns()
            q["limitSpec"] = {
                "limit": spec.limit,
                "columns": [
                    {"dimension": names[pos],
                     "direction": "descending" if d else "ascending"}
                    for pos, d in spec.sort
                ],
            }
        return q

    # ---- execution --------------------------------------------------------
    def to_splits(self) -> List[object]:
        segs = self._segments()
        if (self.spec.agg is not None and self.spec.agg.mode == FULL) or \
                self.spec.limit_mode == FULL:
            return [("all", None)]
        return [("seg", i) for i in range(len(segs))] or [("all", None)]

    def read_split(self, split) -> Iterator[VectorBatch]:
        q = self.native_query()
        if not self._recorded:
            self.handler.store.queries_served.append(q)
            self._recorded = True
        segs = self._segments()
        if split is None or split[0] == "all":
            batch = (VectorBatch.concat([s.batch for s in segs])
                     if segs else VectorBatch({}))
        else:
            batch = segs[split[1]].batch
        out = self._run_query(batch, q)
        if out.cols:
            out = out.project(self.output_columns())
        batch_rows = int(self.config.get("exchange.batch_rows",
                                         DEFAULT_BATCH_ROWS) or DEFAULT_BATCH_ROWS)
        if out.num_rows == 0:
            yield out if out.cols else self.empty_batch()
            return
        yield from out.iter_chunks(batch_rows)

    # ---- execution of Druid JSON over a segment ----------------------------
    def _run_query(self, batch: VectorBatch, q: dict) -> VectorBatch:
        if not batch.cols:
            return batch
        if q.get("filter"):
            mask = _eval_druid_filter(batch, q["filter"])
            batch = batch.select(mask)
        if q["queryType"] in ("groupBy", "timeseries"):
            from ..optimizer.plan import AggSpec
            from ..runtime.exec import _agg_column, _group_codes

            dims = q.get("dimensions", [])
            codes, first = _group_codes(batch, dims) if dims else (
                np.zeros(batch.num_rows, dtype=np.int64),
                np.array([0] if batch.num_rows else [], dtype=np.int64),
            )
            ng = len(first) if dims else 1
            order_of_first = np.argsort(first) if dims else np.array([0])
            remap = np.empty(max(ng, 1), dtype=np.int64)
            remap[order_of_first] = np.arange(ng)
            codes = remap[codes] if batch.num_rows else codes
            out = {}
            for d in dims:
                out[d] = batch.cols[d][np.sort(first)]
            for agg in q.get("aggregations", []):
                fn = {"doubleSum": "sum", "floatSum": "sum", "longSum": "sum",
                      "count": "count", "doubleMin": "min", "doubleMax": "max",
                      "longMin": "min", "longMax": "max"}[agg["type"]]
                arg = batch.cols.get(agg.get("fieldName")) if agg.get("fieldName") else None
                spec = AggSpec(fn, A.Col("x") if arg is not None else None,
                               False, agg["name"])
                out[agg["name"]] = _agg_column(spec, arg, codes, ng)
            result = VectorBatch(out)
        elif q["queryType"] == "scan":
            cols = q.get("columns") or batch.column_names
            result = batch.project([c for c in cols if c in batch.cols])
        else:  # pragma: no cover - defensive
            raise ValueError(f"unsupported druid queryType {q['queryType']}")
        if q.get("limitSpec"):
            result = _apply_limitspec(result, q["limitSpec"])
        return result


class DruidWriter(Writer):
    def __init__(self, handler: DruidHandler, table: TableDesc):
        self.handler = handler
        self.table = table
        self._pending: List[VectorBatch] = []

    def write_batch(self, batch: VectorBatch) -> None:
        if batch.num_rows:
            self._pending.append(batch)

    def commit(self) -> None:
        if not self._pending:
            return
        src = self.table.props.get("druid.datasource", self.table.name)
        self.handler.store.append(src, VectorBatch.concat(self._pending))
        self._pending = []


# ---------------------------------------------------------------------------
# filter translation + evaluation
# ---------------------------------------------------------------------------
def _one_filter(c: A.Expr) -> Optional[dict]:
    """One raw-column conjunct -> Druid filter JSON; None if untranslatable."""
    if isinstance(c, A.BinOp) and c.op in ("=", "<", "<=", ">", ">=", "!="):
        col, lit, op = None, None, c.op
        if isinstance(c.left, A.Col) and isinstance(c.right, A.Lit):
            col, lit = c.left, c.right.value
        elif isinstance(c.right, A.Col) and isinstance(c.left, A.Lit):
            flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "=", "!=": "!="}
            col, lit, op = c.right, c.left.value, flip[c.op]
        if col is None or col.table is not None:
            return None
        dim = col.name
        if op == "=":
            return {"type": "selector", "dimension": dim, "value": lit}
        if op == "!=":
            return {"type": "not", "field": {"type": "selector", "dimension": dim, "value": lit}}
        bound = {"type": "bound", "dimension": dim, "ordering": "numeric"}
        if op in ("<", "<="):
            bound["upper"] = lit
            bound["upperStrict"] = op == "<"
        else:
            bound["lower"] = lit
            bound["lowerStrict"] = op == ">"
        return bound
    if isinstance(c, A.Between) and not c.negated and isinstance(c.expr, A.Col) \
            and c.expr.table is None:
        if not isinstance(c.low, A.Lit) or not isinstance(c.high, A.Lit):
            return None
        return {"type": "bound", "dimension": c.expr.name, "ordering": "numeric",
                "lower": c.low.value, "upper": c.high.value,
                "lowerStrict": False, "upperStrict": False}
    if isinstance(c, A.InList) and isinstance(c.expr, A.Col) and c.expr.table is None:
        f = {"type": "in", "dimension": c.expr.name,
             "values": [v.value for v in c.values if isinstance(v, A.Lit)]}
        return {"type": "not", "field": f} if c.negated else f
    return None


def _eval_druid_filter(batch: VectorBatch, f: dict) -> np.ndarray:
    n = batch.num_rows
    t = f["type"]
    if t == "and":
        m = np.ones(n, dtype=bool)
        for sub in f["fields"]:
            m &= _eval_druid_filter(batch, sub)
        return m
    if t == "not":
        return ~_eval_druid_filter(batch, f["field"])
    col = batch.cols[f["dimension"]]
    if t == "selector":
        v = f["value"]
        if col.dtype.kind in ("U", "S"):
            v = str(v)
        return col == v
    if t == "in":
        vals = f["values"]
        if col.dtype.kind in ("U", "S"):
            vals = [str(v) for v in vals]
        return np.isin(col, np.array(vals))
    if t == "bound":
        m = np.ones(n, dtype=bool)
        if "lower" in f:
            m &= (col > f["lower"]) if f.get("lowerStrict") else (col >= f["lower"])
        if "upper" in f:
            m &= (col < f["upper"]) if f.get("upperStrict") else (col <= f["upper"])
        return m
    raise ValueError(f"unknown druid filter {t}")


def _apply_limitspec(out: VectorBatch, spec: dict) -> VectorBatch:
    cols = spec.get("columns") or []
    if cols:
        out = out.sort_by([c["dimension"] for c in cols],
                          [c["direction"] == "descending" for c in cols])
    return out.slice(0, spec["limit"])
