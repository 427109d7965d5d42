"""Materialized view rewriting (paper §4.4, Figure 4).

Calcite-style SPJA unification: a query whose Select-Project-Join-Aggregate
core matches a registered materialized view is rewritten to read the MV
instead —

  * **full containment** (Fig 4b): the query's filter region is contained in
    the MV's; the rewrite scans the MV, applies the query's residual
    predicates, and re-aggregates (rollup) when the query groups more
    coarsely;
  * **partial containment** (Fig 4c): the query region exceeds the MV region
    along one column's range; the rewrite UNION ALLs the MV part with a
    recomputation over base tables restricted to the *complement* range, then
    re-aggregates on top.

The same machinery drives incremental MV maintenance (§4.4): a rebuild is a
partially-contained rewrite whose "complement" is the WriteId range above the
MV's build snapshot.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from ..metastore import Metastore
from ..sql import ast as A
from ..sql.binder import Binder, conjoin, split_conjuncts
from ..sql.parser import parse
from . import plan as P


# ===========================================================================
# SPJA descriptor extraction
# ===========================================================================
@dataclasses.dataclass
class Interval:
    lo: float = float("-inf")
    hi: float = float("inf")
    lo_open: bool = False
    hi_open: bool = False

    def contains(self, other: "Interval") -> bool:
        lo_ok = (self.lo < other.lo) or (
            self.lo == other.lo and (not self.lo_open or other.lo_open)
        )
        hi_ok = (self.hi > other.hi) or (
            self.hi == other.hi and (not self.hi_open or other.hi_open)
        )
        return lo_ok and hi_ok

    def is_universe(self) -> bool:
        return self.lo == float("-inf") and self.hi == float("inf")


@dataclasses.dataclass
class SPJA:
    tables: Dict[str, str]  # alias -> table name (each table used once)
    join_pairs: Set[frozenset]  # {frozenset({"t1.c1", "t2.c2"}), ...} table-name qualified
    intervals: Dict[str, Interval]  # table-qualified col -> interval constraint
    other_filters: List[str]  # canonical keys of non-interval conjuncts
    other_filter_exprs: List[A.Expr]
    group_keys: List[str]  # table-qualified cols (exprs unsupported -> bail)
    aggs: List[Tuple[str, str, bool]]  # (fn, canonical arg key | '*', distinct)
    agg_out: List[str]  # aggregate output names in the original plan
    group_out: List[str]  # group key output names in the original plan
    alias_of_table: Dict[str, str] = dataclasses.field(default_factory=dict)


def _canon(e: A.Expr, alias_to_table: Dict[str, str]) -> A.Expr:
    """Rewrite alias-qualified cols to table-name-qualified ones."""
    from ..sql.binder import _rebuild

    if isinstance(e, A.Col):
        t = alias_to_table.get(e.table, e.table)
        return A.Col(e.name, t)
    return _rebuild(e, [_canon(c, alias_to_table) for c in e.children()])


def extract_spja(plan: P.PlanNode) -> Optional[SPJA]:
    """Match Project?(Aggregate(Project?(Filter*(JoinTree(Scan*))))) cores."""
    node = plan
    while isinstance(node, (P.Sort, P.Limit, P.Project)):
        node = node.inputs[0]
    if not isinstance(node, P.Aggregate):
        return None
    agg: P.Aggregate = node

    # below the aggregate: optional pre-projection, filters, join tree of scans
    inner = agg.input
    pre_exprs: Dict[str, A.Expr] = {}
    if isinstance(inner, P.Project):
        pre_exprs = {n: e for e, n in inner.exprs}
        inner = inner.input
    filters: List[A.Expr] = []
    while isinstance(inner, P.Filter):
        filters.extend(split_conjuncts(inner.predicate))
        inner = inner.input

    tables: Dict[str, str] = {}
    join_pairs: Set[frozenset] = set()
    alias_to_table: Dict[str, str] = {}

    def collect(n: P.PlanNode) -> bool:
        if isinstance(n, P.Scan):
            if n.table.name in tables.values():
                return False  # self-joins unsupported by the matcher
            tables[n.alias] = n.table.name
            alias_to_table[n.alias] = n.table.name
            if n.pushed_filter is not None:
                from .rules import _retarget  # qualify with alias again

                for c in split_conjuncts(n.pushed_filter):
                    filters.append(_qualify_with(c, n.alias))
            if n.partition_filter is not None:
                filters.extend(split_conjuncts(n.partition_filter))
            return True
        if isinstance(n, P.Join) and n.kind in ("inner", "cross"):
            if n.residual is not None:
                return False
            if not collect(n.left) or not collect(n.right):
                return False
            for lk, rk in zip(n.left_keys, n.right_keys):
                join_pairs.add(
                    frozenset({_canon_name(lk, alias_to_table),
                               _canon_name(rk, alias_to_table)})
                )
            return True
        if isinstance(n, P.Filter):
            filters.extend(split_conjuncts(n.predicate))
            return collect(n.input)
        return False

    if not collect(inner):
        return None

    # classify filters into per-column intervals vs. opaque conjuncts
    intervals: Dict[str, Interval] = {}
    other: List[A.Expr] = []
    for f in filters:
        fc = _canon(f, alias_to_table)
        hit = _as_interval(fc)
        if hit is not None:
            col, iv = hit
            cur = intervals.setdefault(col, Interval())
            intervals[col] = _intersect(cur, iv)
        else:
            other.append(fc)

    group_keys: List[str] = []
    for k in agg.group_keys:
        e = pre_exprs.get(k, A.Col(_b(k), _q(k)))
        if not isinstance(e, A.Col):
            return None
        group_keys.append(_canon_name(e.qualified, alias_to_table))

    aggs: List[Tuple[str, str, bool]] = []
    for spec in agg.aggs:
        if spec.arg is None:
            aggs.append((spec.fn, "*", spec.distinct))
            continue
        arg = spec.arg
        if isinstance(arg, A.Col):
            arg = pre_exprs.get(arg.qualified, arg)
        aggs.append(
            (spec.fn, _canon(arg, alias_to_table).key(), spec.distinct)
        )

    return SPJA(
        tables=tables,
        join_pairs=join_pairs,
        intervals=intervals,
        other_filters=sorted(x.key() for x in other),
        other_filter_exprs=other,
        group_keys=group_keys,
        aggs=aggs,
        agg_out=[s.out_name for s in agg.aggs],
        group_out=list(agg.group_keys),
        alias_of_table={v: k for k, v in tables.items()},
    )


# ===========================================================================
# the rewriter
# ===========================================================================
class MVRewriter:
    def __init__(self, hms: Metastore):
        self.hms = hms

    def try_rewrite(self, plan: P.PlanNode, allow_stale: bool = False):
        """Return (new_plan, mv_name, mode) or None."""
        q = extract_spja(plan)
        if q is None:
            return None
        for mv in self.hms.list_mvs():
            if not allow_stale and not self._fresh(mv):
                continue
            try:
                mv_desc = self.hms.get_table(mv["name"])
            except KeyError:
                continue
            mv_plan = Binder(self.hms).bind(parse(mv["sql"]))
            m = extract_spja(mv_plan)
            if m is None:
                continue
            if set(q.tables.values()) != set(m.tables.values()):
                continue
            if q.join_pairs != m.join_pairs:
                continue
            if not set(q.group_keys) <= set(m.group_keys):
                continue
            # non-interval query filters over MV-exposed group keys can be
            # re-applied on the MV (e.g. d_moy IN (1,2,3) in Fig 4b); the
            # rest must match the MV's own opaque filters exactly
            extra_residual = [
                e for e in q.other_filter_exprs
                if _cols_of(e) <= set(m.group_keys)
            ]
            rest_keys = sorted(
                e.key() for e in q.other_filter_exprs if e not in extra_residual
            )
            if rest_keys != sorted(m.other_filters):
                continue
            agg_map = self._map_aggs(q, m)
            if agg_map is None:
                continue
            mode, residual, complement = self._containment(q, m)
            if mode is None:
                continue
            mv_out_cols = self._mv_output_columns(m, mv_desc)
            if mv_out_cols is None:
                continue
            if mode == "full":
                new = self._build_full(plan, q, m, mv_desc, agg_map,
                                       residual, mv_out_cols, extra_residual)
                if new is not None:
                    return new, mv["name"], "full"
            else:
                new = self._build_partial(plan, q, m, mv_desc, agg_map,
                                          residual, complement, mv_out_cols,
                                          extra_residual)
                if new is not None:
                    return new, mv["name"], "partial"
        return None

    # -- validity ---------------------------------------------------------------
    def _fresh(self, mv: dict) -> bool:
        import time

        snap = self.hms.get_snapshot()
        for t, wid in mv["build_snapshot"].items():
            cur = self.hms.writeid_list(t, snap)
            if cur.hwm != wid:
                # stale — allowed only within the declared staleness window
                window = mv.get("staleness_window") or 0
                if window and time.time() - (mv.get("last_rebuild_at") or 0) <= window:
                    continue
                return False
        return True

    # -- agg compatibility --------------------------------------------------------
    @staticmethod
    def _map_aggs(q: SPJA, m: SPJA) -> Optional[List[Tuple[str, int]]]:
        """For each query agg, (rollup_fn, index into MV aggs)."""
        out = []
        for fn, arg, distinct in q.aggs:
            if distinct and set(q.group_keys) != set(m.group_keys):
                return None
            try:
                idx = m.aggs.index((fn, arg, distinct))
            except ValueError:
                return None
            rollup = {"sum": "sum", "count": "sum", "min": "min", "max": "max"}.get(fn)
            if rollup is None:
                return None
            out.append((rollup, idx))
        return out

    # -- containment over interval regions -----------------------------------------
    @staticmethod
    def _containment(q: SPJA, m: SPJA):
        """Return (mode, residual_conjuncts, complement) where complement is
        (col, Interval) for the base-table recomputation branch."""
        residual: List[Tuple[str, Interval]] = []
        complement: Optional[Tuple[str, Interval]] = None
        for col in set(q.intervals) | set(m.intervals):
            qi = q.intervals.get(col, Interval())
            mi = m.intervals.get(col, Interval())
            if mi.contains(qi):
                if not qi.is_universe():
                    residual.append((col, qi))
                continue
            # MV does not cover the query on this column
            if complement is not None:
                return None, None, None  # only one overflowing column supported
            # complement = query minus MV region (must be one interval):
            # supported pattern: both are lower-bounded rays (Fig 4c)
            if (
                qi.hi == float("inf") and mi.hi == float("inf")
                and mi.lo > qi.lo
            ):
                comp = Interval(qi.lo, mi.lo, qi.lo_open, not mi.lo_open)
                complement = (col, comp)
                residual.append((col, qi))
            elif (
                qi.lo == float("-inf") and mi.lo == float("-inf")
                and mi.hi < qi.hi
            ):
                comp = Interval(mi.hi, qi.hi, not mi.hi_open, qi.hi_open)
                complement = (col, comp)
                residual.append((col, qi))
            else:
                return None, None, None
        mode = "partial" if complement is not None else "full"
        return mode, residual, complement

    # -- MV output schema mapping ----------------------------------------------------
    @staticmethod
    def _mv_output_columns(m: SPJA, mv_desc) -> Optional[Dict[str, str]]:
        """Map canonical group-key/agg identity -> MV table column name.

        MV tables are stored with the MV query's output names, in order:
        group keys first (matching m.group_out), then aggregates.
        """
        cols = [c for c, _ in mv_desc.schema]
        if len(cols) != len(m.group_keys) + len(m.aggs):
            return None
        out: Dict[str, str] = {}
        for gk, col in zip(m.group_keys, cols[: len(m.group_keys)]):
            out[f"key:{gk}"] = col
        for (fn, arg, d), col in zip(m.aggs, cols[len(m.group_keys):]):
            out[f"agg:{fn}:{arg}:{d}"] = col
        return out

    # -- plan construction --------------------------------------------------------------
    def _scan_mv(self, mv_desc) -> P.PlanNode:
        alias = "__mv__"
        if mv_desc.handler:
            return P.FederatedScan(mv_desc, alias, [c for c, _ in mv_desc.schema])
        return P.Scan(mv_desc, alias, [c for c, _ in mv_desc.schema])

    def _build_full(self, plan, q, m, mv_desc, agg_map, residual, mv_cols,
                    extra_residual=()):
        scan = self._scan_mv(mv_desc)
        alias = "__mv__"
        preds = []
        for e in extra_residual:
            sub = _remap_to_mv(e, mv_cols, alias)
            if sub is None:
                return None
            preds.append(sub)
        for col, iv in residual:
            mv_col = mv_cols.get(f"key:{col}")
            if mv_col is None:
                # filtered column not exposed by the MV: only OK when the MV
                # applies the *same* constraint (already checked containment
                # equality here)
                mi = m.intervals.get(col, Interval())
                qi = q.intervals.get(col, Interval())
                if (mi.lo, mi.hi, mi.lo_open, mi.hi_open) == (
                    qi.lo, qi.hi, qi.lo_open, qi.hi_open,
                ):
                    continue
                return None
            preds.extend(_interval_preds(A.Col(mv_col, alias), iv))
        node: P.PlanNode = scan
        if preds:
            node = P.Filter(node, conjoin(preds))
        return self._regroup(plan, q, m, node, alias, agg_map, mv_cols)

    def _build_partial(self, plan, q, m, mv_desc, agg_map, residual,
                       complement, mv_cols, extra_residual=()):
        comp_col, comp_iv = complement
        # branch A: the MV part (with the query's residual region)
        scan = self._scan_mv(mv_desc)
        alias = "__mv__"
        preds = []
        for e in extra_residual:
            sub = _remap_to_mv(e, mv_cols, alias)
            if sub is None:
                return None
            preds.append(sub)
        for col, iv in residual:
            mv_col = mv_cols.get(f"key:{col}")
            if mv_col is None:
                if col == comp_col:
                    continue  # MV region is implied for its own branch
                return None
            # intersect with MV region for branch A
            mi = m.intervals.get(col, Interval())
            preds.extend(_interval_preds(A.Col(mv_col, alias), _intersect(iv, mi)))
        branch_a: P.PlanNode = P.Filter(scan, conjoin(preds)) if preds else scan
        a_cols = [mv_cols[f"key:{gk}"] for gk in q.group_keys]
        a_aggs = [mv_cols[f"agg:{fn}:{arg}:{d}"] for fn, arg, d in q.aggs]
        proj_a = P.Project(
            branch_a,
            [(A.Col(c, alias), out) for c, out in zip(a_cols, q.group_out)]
            + [(A.Col(c, alias), out) for c, out in zip(a_aggs, q.agg_out)],
        )

        # branch B: recompute over base tables on the complement region
        agg_node = plan
        while not isinstance(agg_node, P.Aggregate):
            agg_node = agg_node.inputs[0]
        qalias = q.alias_of_table.get(_q(comp_col)) or _q(comp_col)
        comp_pred = conjoin(
            _interval_preds(A.Col(_b(comp_col), qalias), comp_iv)
        )
        branch_b_inner = P.Filter(agg_node.input, comp_pred)
        branch_b_agg = P.Aggregate(branch_b_inner, list(agg_node.group_keys),
                                   list(agg_node.aggs))
        proj_b = P.Project(
            branch_b_agg,
            [(A.Col(_b(n), _q(n)), out)
             for n, out in zip(agg_node.group_keys, q.group_out)]
            + [(A.Col(_b(s.out_name), _q(s.out_name)), out)
               for s, out in zip(agg_node.aggs, q.agg_out)],
        )

        union = P.Union([proj_a, proj_b], all=True)
        final = P.Aggregate(
            union,
            list(q.group_out),
            [
                P.AggSpec(rollup, A.Col(_b(out), _q(out)), False, out)
                for (rollup, _), out in zip(agg_map, q.agg_out)
            ],
        )
        return _replace_agg(plan, final)

    def _regroup(self, plan, q, m, mv_input, alias, agg_map, mv_cols):
        group_cols = [mv_cols[f"key:{gk}"] for gk in q.group_keys]
        specs = []
        for (rollup, mv_idx), out in zip(agg_map, q.agg_out):
            fn, arg, d = m.aggs[mv_idx]
            col = mv_cols[f"agg:{fn}:{arg}:{d}"]
            specs.append(P.AggSpec(rollup, A.Col(col, alias), False, out))
        pre = P.Project(
            mv_input,
            [(A.Col(c, alias), out) for c, out in zip(group_cols, q.group_out)]
            + [(A.Col(mv_cols[f"agg:{m.aggs[i][0]}:{m.aggs[i][1]}:{m.aggs[i][2]}"],
                      alias), f"__mva_{j}")
               for j, (_, i) in enumerate(agg_map)],
        )
        specs = [
            P.AggSpec(rollup, A.Col(f"__mva_{j}"), False, out)
            for j, ((rollup, _), out) in enumerate(zip(agg_map, q.agg_out))
        ]
        agg = P.Aggregate(pre, list(q.group_out), specs)
        return _replace_agg(plan, agg)


# ---------------------------------------------------------------------------
def _replace_agg(plan: P.PlanNode, replacement: P.PlanNode) -> P.PlanNode:
    """Swap the SPJA core (the Aggregate node) for the rewritten subtree."""
    if isinstance(plan, P.Aggregate):
        return replacement

    def visit(node):
        for i, c in enumerate(node.inputs):
            if isinstance(c, P.Aggregate):
                node.inputs[i] = replacement
                return True
            if visit(c):
                return True
        return False

    visit(plan)
    return plan


def _as_interval(e: A.Expr) -> Optional[Tuple[str, Interval]]:
    if isinstance(e, A.BinOp) and e.op in ("<", "<=", ">", ">=", "="):
        col, lit, op = None, None, e.op
        if isinstance(e.left, A.Col) and isinstance(e.right, A.Lit):
            col, lit = e.left, e.right.value
        elif isinstance(e.right, A.Col) and isinstance(e.left, A.Lit):
            flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "="}
            col, lit, op = e.right, e.left.value, flip[e.op]
        if col is None or not isinstance(lit, (int, float)) or isinstance(lit, bool):
            return None
        v = float(lit)
        if op == "=":
            return col.qualified, Interval(v, v)
        if op == "<":
            return col.qualified, Interval(hi=v, hi_open=True)
        if op == "<=":
            return col.qualified, Interval(hi=v)
        if op == ">":
            return col.qualified, Interval(lo=v, lo_open=True)
        if op == ">=":
            return col.qualified, Interval(lo=v)
    if isinstance(e, A.Between) and not e.negated and isinstance(e.expr, A.Col):
        if isinstance(e.low, A.Lit) and isinstance(e.high, A.Lit) and \
           isinstance(e.low.value, (int, float)) and isinstance(e.high.value, (int, float)):
            return e.expr.qualified, Interval(float(e.low.value), float(e.high.value))
    return None


def _intersect(a: Interval, b: Interval) -> Interval:
    lo, lo_open = max((a.lo, a.lo_open), (b.lo, b.lo_open))
    hi, hi_open = min((a.hi, not a.hi_open), (b.hi, not b.hi_open))
    return Interval(lo, hi, lo_open, not hi_open)


def _interval_preds(col: A.Col, iv: Interval) -> List[A.Expr]:
    preds = []
    if iv.lo == iv.hi and not iv.lo_open and not iv.hi_open and iv.lo != float("-inf"):
        return [A.BinOp("=", col, A.Lit(_maybe_int(iv.lo)))]
    if iv.lo != float("-inf"):
        preds.append(A.BinOp(">" if iv.lo_open else ">=", col, A.Lit(_maybe_int(iv.lo))))
    if iv.hi != float("inf"):
        preds.append(A.BinOp("<" if iv.hi_open else "<=", col, A.Lit(_maybe_int(iv.hi))))
    return preds


def _maybe_int(v: float):
    return int(v) if float(v).is_integer() else v


def _cols_of(e: A.Expr) -> set:
    return {n.qualified for n in A.walk(e) if isinstance(n, A.Col)}


def _remap_to_mv(e: A.Expr, mv_cols: Dict[str, str], alias: str) -> Optional[A.Expr]:
    """Rewrite canonical (table.col) refs onto the MV table's columns."""
    from ..sql.binder import _rebuild

    if isinstance(e, A.Col):
        mv_col = mv_cols.get(f"key:{e.qualified}")
        if mv_col is None:
            return None
        return A.Col(mv_col, alias)
    kids = []
    for c in e.children():
        k = _remap_to_mv(c, mv_cols, alias)
        if k is None:
            return None
        kids.append(k)
    return _rebuild(e, kids)


def _canon_name(qualified: str, alias_to_table: Dict[str, str]) -> str:
    t, c = qualified.split(".", 1)
    return f"{alias_to_table.get(t, t)}.{c}"


def _qualify_with(e: A.Expr, alias: str) -> A.Expr:
    from ..sql.binder import _rebuild

    if isinstance(e, A.Col) and e.table is None:
        return A.Col(e.name, alias)
    if isinstance(e, A.Col):
        return e
    return _rebuild(e, [_qualify_with(c, alias) for c in e.children()])


def _b(q: str) -> str:
    return q.split(".", 1)[1] if "." in q else q


def _q(q: str):
    return q.split(".", 1)[0] if "." in q else None
