"""Cardinality estimation & cost model (paper §4.1 "Statistics").

Estimates flow from HMS statistics: row counts, min/max ranges, and HLL++
NDV sketches.  Runtime-captured actuals (paper §4.2) can be layered on top as
``overrides`` keyed by plan-node digest — that is exactly what the
re-optimization path feeds back after an execution error.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

from ..metastore import Metastore
from ..sql import ast as A
from . import plan as P

DEFAULT_EQ_SELECTIVITY = 0.1
DEFAULT_RANGE_SELECTIVITY = 1.0 / 3.0
DEFAULT_LIKE_SELECTIVITY = 0.25


class ColumnInfo:
    __slots__ = ("ndv", "min", "max", "rows")

    def __init__(self, ndv=None, min=None, max=None, rows=None):
        self.ndv = ndv
        self.min = min
        self.max = max
        self.rows = rows


class Estimate:
    def __init__(self, rows: float, columns: Dict[str, ColumnInfo]):
        self.rows = max(rows, 0.0)
        self.columns = columns

    def col(self, name: str) -> ColumnInfo:
        return self.columns.get(name, ColumnInfo())

    def scaled(self, sel: float) -> "Estimate":
        rows = self.rows * sel
        cols = {
            k: ColumnInfo(
                ndv=min(v.ndv, rows) if v.ndv is not None else None,
                min=v.min, max=v.max, rows=rows,
            )
            for k, v in self.columns.items()
        }
        return Estimate(rows, cols)


class CostModel:
    def __init__(self, hms: Metastore,
                 overrides: Optional[Dict[str, float]] = None,
                 handler_resolver=None):
        self.hms = hms
        self.overrides = overrides or {}
        # resolves a TableDesc.handler name to a connector so federated
        # scans can be costed on the connector's remote row-count/NDV
        # estimates instead of the empty-stats default (§6)
        self.handler_resolver = handler_resolver
        self._stats_cache: Dict[str, object] = {}

    # -- public ---------------------------------------------------------------
    def estimate(self, node: P.PlanNode) -> Estimate:
        est = self._estimate(node)
        if node.digest() in self.overrides:  # runtime actuals win (§4.2)
            actual = self.overrides[node.digest()]
            if est.rows > 0:
                est = est.scaled(actual / est.rows)
            else:
                est = Estimate(actual, est.columns)
        return est

    def cost(self, node: P.PlanNode) -> float:
        """CPU+shuffle cost proxy: sum of intermediate result sizes."""
        total = self.estimate(node).rows
        for child in node.inputs:
            total += self.cost(child)
        if isinstance(node, P.Join):
            total += self.estimate(node.right).rows * 0.5  # build cost
        if isinstance(node, P.Sort):
            r = self.estimate(node.input).rows
            total += r * max(math.log2(max(r, 2)), 1) * 0.1
        return total

    # -- internals --------------------------------------------------------------
    def _table_stats(self, name: str, node: Optional[P.PlanNode] = None):
        if name not in self._stats_cache:
            from ..stats import TableStats

            try:
                stats = self.hms.get_stats(name)
            except KeyError:
                # catalog-mounted external table: no HMS stats (§6)
                stats = TableStats()
            if (isinstance(node, P.FederatedScan)
                    and not getattr(stats, "row_count", 0)):
                # external data never flowed through local writes, so HMS
                # stats are empty: ask the connector for remote estimates
                stats = self._remote_stats(node) or stats
            self._stats_cache[name] = stats
        return self._stats_cache[name]

    def _remote_stats(self, node: P.FederatedScan):
        if self.handler_resolver is None:
            return None
        try:
            handler = self.handler_resolver(node.table.handler)
            if handler is None:
                return None
            return handler.scan_builder(node.table, {}).estimate_stats()
        except Exception:  # noqa: BLE001 - stats must never break planning
            return None

    def _estimate(self, node: P.PlanNode) -> Estimate:
        if isinstance(node, (P.Scan, P.FederatedScan)):
            ts = self._table_stats(node.table.name, node)
            cols = {}
            for c, cs in ts.columns.items():
                cols[f"{node.alias}.{c}"] = ColumnInfo(
                    ndv=cs.ndv or None, min=cs.min_value, max=cs.max_value,
                    rows=ts.row_count,
                )
            est = Estimate(ts.row_count or 1.0, cols)
            pf = getattr(node, "pushed_filter", None)
            if pf is not None:
                est = est.scaled(self.selectivity(pf, est, alias=node.alias))
            pp = getattr(node, "partition_filter", None)
            if pp is not None:
                est = est.scaled(self.selectivity(pp, est, alias=node.alias))
            for rf in getattr(node, "runtime_filters", []) or []:
                est = est.scaled(0.5)
            return est
        if isinstance(node, P.Filter):
            child = self.estimate(node.input)
            return child.scaled(self.selectivity(node.predicate, child))
        if isinstance(node, P.Project):
            child = self.estimate(node.input)
            cols = {}
            for e, n in node.exprs:
                if isinstance(e, A.Col):
                    cols[n] = child.col(e.qualified)
                else:
                    cols[n] = ColumnInfo(rows=child.rows)
            return Estimate(child.rows, cols)
        if isinstance(node, P.Join):
            left = self.estimate(node.left)
            right = self.estimate(node.right)
            cols = {**left.columns, **right.columns}
            if node.kind == "cross" and not node.left_keys:
                return Estimate(left.rows * right.rows, cols)
            sel = 1.0
            for lk, rk in zip(node.left_keys, node.right_keys):
                nl = left.col(lk).ndv or max(left.rows * 0.1, 1)
                nr = right.col(rk).ndv or max(right.rows * 0.1, 1)
                sel /= max(nl, nr, 1.0)
            rows = left.rows * right.rows * sel
            if node.kind in ("semi", "anti"):
                match_frac = min(1.0, rows / max(left.rows, 1e-9))
                rows = left.rows * (
                    match_frac if node.kind == "semi" else (1 - match_frac)
                )
                cols = left.columns
            if node.kind == "left":
                rows = max(rows, left.rows)
            if node.residual is not None:
                rows *= DEFAULT_RANGE_SELECTIVITY
            return Estimate(rows, cols)
        if isinstance(node, P.Aggregate):
            child = self.estimate(node.input)
            if not node.group_keys:
                return Estimate(1.0, {a.out_name: ColumnInfo(rows=1) for a in node.aggs})
            ndv = 1.0
            for k in node.group_keys:
                ndv *= child.col(k).ndv or max(child.rows ** 0.5, 1)
            rows = min(ndv, child.rows)
            cols = {k: child.col(k) for k in node.group_keys}
            for a in node.aggs:
                cols[a.out_name] = ColumnInfo(rows=rows)
            if node.grouping_sets:
                rows *= len(node.grouping_sets)
            return Estimate(rows, cols)
        if isinstance(node, P.WindowOp):
            child = self.estimate(node.input)
            cols = dict(child.columns)
            for _, n in node.funcs:
                cols[n] = ColumnInfo(rows=child.rows)
            return Estimate(child.rows, cols)
        if isinstance(node, (P.Sort,)):
            return self.estimate(node.input)
        if isinstance(node, P.ShuffleRead):
            # one hash lane of the source stream: 1/N of its rows, so plans
            # stacked above partition-expanded consumers (an aggregation
            # over an expanded join) still cost on real cardinalities
            child = self.estimate(node.source)
            return child.scaled(1.0 / max(node.num_partitions, 1))
        if isinstance(node, P.Limit):
            child = self.estimate(node.input)
            return child.scaled(min(1.0, node.n / max(child.rows, 1)))
        if isinstance(node, P.Union):
            ests = [self.estimate(i) for i in node.inputs]
            rows = sum(e.rows for e in ests)
            return Estimate(rows, ests[0].columns if ests else {})
        if isinstance(node, P.ValuesNode):
            return Estimate(len(node.rows), {n: ColumnInfo() for n in node.names})
        return Estimate(1000.0, {})

    # -- selectivity -----------------------------------------------------------
    def selectivity(self, pred: A.Expr, est: Estimate, alias: Optional[str] = None) -> float:
        def colinfo(c: A.Col) -> ColumnInfo:
            name = c.qualified
            if c.table is None and alias is not None:
                name = f"{alias}.{c.name}"
            return est.col(name)

        def sel(e: A.Expr) -> float:
            if isinstance(e, A.BinOp):
                if e.op == "AND":
                    return sel(e.left) * sel(e.right)
                if e.op == "OR":
                    return min(1.0, sel(e.left) + sel(e.right))
                col, lit = None, None
                if isinstance(e.left, A.Col) and isinstance(e.right, A.Lit):
                    col, lit, op = e.left, e.right.value, e.op
                elif isinstance(e.right, A.Col) and isinstance(e.left, A.Lit):
                    flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
                            "=": "=", "!=": "!="}
                    col, lit, op = e.right, e.left.value, flip.get(e.op, e.op)
                if col is not None:
                    ci = colinfo(col)
                    if op == "=":
                        return 1.0 / ci.ndv if ci.ndv else DEFAULT_EQ_SELECTIVITY
                    if op == "!=":
                        return 1.0 - (1.0 / ci.ndv if ci.ndv else DEFAULT_EQ_SELECTIVITY)
                    if op in ("<", "<=", ">", ">=") and _numeric(ci.min) and _numeric(ci.max) and _numeric(lit):
                        span = float(ci.max) - float(ci.min)
                        if span <= 0:
                            return DEFAULT_RANGE_SELECTIVITY
                        if op in ("<", "<="):
                            return _clip((float(lit) - float(ci.min)) / span)
                        return _clip((float(ci.max) - float(lit)) / span)
                    return DEFAULT_RANGE_SELECTIVITY
                if e.op == "LIKE":
                    return DEFAULT_LIKE_SELECTIVITY
                return DEFAULT_RANGE_SELECTIVITY
            if isinstance(e, A.UnOp) and e.op == "NOT":
                return 1.0 - sel(e.operand)
            if isinstance(e, A.InList) and isinstance(e.expr, A.Col):
                ci = colinfo(e.expr)
                s = len(e.values) / ci.ndv if ci.ndv else DEFAULT_EQ_SELECTIVITY * len(e.values)
                s = _clip(s)
                return 1.0 - s if e.negated else s
            if isinstance(e, A.Between) and isinstance(e.expr, A.Col):
                ci = colinfo(e.expr)
                if (
                    _numeric(ci.min) and _numeric(ci.max)
                    and isinstance(e.low, A.Lit) and isinstance(e.high, A.Lit)
                    and _numeric(e.low.value) and _numeric(e.high.value)
                ):
                    span = float(ci.max) - float(ci.min)
                    if span > 0:
                        s = _clip((float(e.high.value) - float(e.low.value)) / span)
                        return 1.0 - s if e.negated else s
                return DEFAULT_RANGE_SELECTIVITY
            if isinstance(e, A.IsNull):
                return 0.05 if not e.negated else 0.95
            return DEFAULT_RANGE_SELECTIVITY

        return _clip(sel(pred))


def _numeric(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def _clip(x: float) -> float:
    return min(1.0, max(1e-6, x))
