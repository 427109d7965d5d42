"""Multi-stage rule & cost based optimizer (paper §4.1).

Mirrors Hive's Calcite integration: a sequence of optimization *stages*, each
pairing a planner discipline with a rule set:

  stage 1 (exhaustive/fixpoint): constant folding, predicate simplification
      and propagation (transitive inference over equi-joins), filter pushdown,
      partition pruning, projection (column) pruning;
  stage 2 (cost-based): join reordering over the extracted join graph and
      join-algorithm selection (broadcast "map join" vs shuffle) driven by the
      HMS statistics in ``CostModel``;
  stage 3+ (cost-based, separate modules): materialized-view rewriting
      (§4.4), dynamic semijoin reduction (§4.6); shared-work runs last against
      the physical plan (§4.5).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..metastore import Metastore
from ..sql import ast as A
from ..sql.binder import conjoin, split_conjuncts, _rebuild
from . import plan as P
from .cost import CostModel


# ===========================================================================
# expression utilities
# ===========================================================================
def expr_columns(e: Optional[A.Expr]) -> Set[str]:
    if e is None:
        return set()
    return {n.qualified for n in A.walk(e) if isinstance(n, A.Col)}


def fold_constants(e: A.Expr) -> A.Expr:
    kids = [fold_constants(c) for c in e.children()]
    e = _rebuild(e, kids)
    if isinstance(e, A.BinOp) and isinstance(e.left, A.Lit) and isinstance(e.right, A.Lit):
        l, r = e.left.value, e.right.value
        try:
            if e.op == "+":
                return A.Lit(l + r)
            if e.op == "-":
                return A.Lit(l - r)
            if e.op == "*":
                return A.Lit(l * r)
            if e.op == "/":
                return A.Lit(l / r)
            if e.op == "=":
                return A.Lit(l == r)
            if e.op == "!=":
                return A.Lit(l != r)
            if e.op == "<":
                return A.Lit(l < r)
            if e.op == "<=":
                return A.Lit(l <= r)
            if e.op == ">":
                return A.Lit(l > r)
            if e.op == ">=":
                return A.Lit(l >= r)
        except TypeError:
            return e
    if isinstance(e, A.BinOp) and e.op == "AND":
        if isinstance(e.left, A.Lit):
            return e.right if e.left.value else A.Lit(False)
        if isinstance(e.right, A.Lit):
            return e.left if e.right.value else A.Lit(False)
    if isinstance(e, A.BinOp) and e.op == "OR":
        if isinstance(e.left, A.Lit):
            return A.Lit(True) if e.left.value else e.right
        if isinstance(e.right, A.Lit):
            return A.Lit(True) if e.right.value else e.left
    if isinstance(e, A.UnOp) and e.op == "NOT" and isinstance(e.operand, A.Lit):
        return A.Lit(not e.operand.value)
    if isinstance(e, A.UnOp) and e.op == "-" and isinstance(e.operand, A.Lit):
        return A.Lit(-e.operand.value)
    return e


def substitute(e: A.Expr, mapping: Dict[str, A.Expr]) -> A.Expr:
    """Replace column refs by definition expressions (inverse projection)."""
    if isinstance(e, A.Col):
        return mapping.get(e.qualified, e)
    return _rebuild(e, [substitute(c, mapping) for c in e.children()])


def strip_alias(e: A.Expr) -> A.Expr:
    """alias.col -> col (for pushing into Scan.pushed_filter)."""
    if isinstance(e, A.Col):
        return A.Col(e.name)
    return _rebuild(e, [strip_alias(c) for c in e.children()])


# ===========================================================================
# the optimizer
# ===========================================================================
@dataclasses.dataclass
class OptimizerConfig:
    cbo: bool = True
    pushdown: bool = True
    prune_columns: bool = True
    join_reorder: bool = True
    transitive_inference: bool = True
    broadcast_threshold_rows: float = 200_000.0
    partition_pruning: bool = True


class Optimizer:
    def __init__(self, hms: Metastore, config: Optional[OptimizerConfig] = None,
                 runtime_overrides: Optional[Dict[str, float]] = None,
                 handler_resolver=None):
        self.hms = hms
        self.config = config or OptimizerConfig()
        self.cost_model = CostModel(hms, runtime_overrides,
                                    handler_resolver=handler_resolver)

    def optimize(self, plan: P.PlanNode) -> P.PlanNode:
        cfg = self.config
        if cfg.pushdown:
            for _ in range(5):  # fixpoint over the logical rewrites
                before = plan.key()
                plan = self.rewrite_filters(plan)
                if cfg.transitive_inference:
                    plan = self.infer_transitive(plan)
                plan = self.rewrite_filters(plan)
                if plan.key() == before:
                    break
        if cfg.prune_columns:
            plan = self.prune_columns(plan, set(plan.output_names()))
        if cfg.cbo and cfg.join_reorder:
            plan = self.reorder_joins(plan)
        if cfg.cbo:
            plan = self.choose_join_strategy(plan)
        return plan

    # ------------------------------------------------------------------ stage 1
    def rewrite_filters(self, node: P.PlanNode) -> P.PlanNode:
        node.inputs = [self.rewrite_filters(c) for c in node.inputs]
        if not isinstance(node, P.Filter):
            return node
        pred = fold_constants(node.predicate)
        if isinstance(pred, A.Lit):
            if pred.value:
                return node.input
            # FALSE filter: empty result; keep as unsatisfiable filter
            node.predicate = pred
            return node
        child = node.input

        # merge adjacent filters
        if isinstance(child, P.Filter):
            merged = conjoin(split_conjuncts(pred) + split_conjuncts(child.predicate))
            return self.rewrite_filters(P.Filter(child.input, merged))

        # push through Project (substituting definitions)
        if isinstance(child, P.Project):
            defs = {n: e for e, n in child.exprs}
            pushable, stuck = [], []
            for c in split_conjuncts(pred):
                sub = substitute(c, defs)
                if not any(isinstance(x, (A.Func, A.WindowFunc)) and
                           getattr(x, "name", "") in A.AGG_FUNCS
                           for x in A.walk(sub)):
                    pushable.append(sub)
                else:
                    stuck.append(c)
            if pushable:
                child.inputs = [P.Filter(child.input, conjoin(pushable))]
                child.inputs = [self.rewrite_filters(child.inputs[0])]
                return P.Filter(child, conjoin(stuck)) if stuck else child
            return node

        # push through Join: route conjuncts by referenced side
        if isinstance(child, P.Join):
            lnames = set(child.left.output_names())
            rnames = set(child.right.output_names())
            to_left, to_right, keep = [], [], []
            for c in split_conjuncts(pred):
                cols = expr_columns(c)
                if cols and cols <= lnames:
                    to_left.append(c)
                elif cols and cols <= rnames and child.kind in ("inner", "cross", "semi"):
                    to_right.append(c)
                elif cols and cols <= rnames and child.kind == "left":
                    keep.append(c)  # can't push below a null-producing side
                else:
                    keep.append(c)
            if to_left:
                child.inputs[0] = self.rewrite_filters(
                    P.Filter(child.left, conjoin(to_left)))
            if to_right:
                child.inputs[1] = self.rewrite_filters(
                    P.Filter(child.right, conjoin(to_right)))
            # two-side conjuncts on an inner/cross join: equi column pairs
            # become join keys (cross -> inner), the rest goes to the residual
            if keep and child.kind in ("inner", "cross"):
                rest = []
                for c in keep:
                    cols = expr_columns(c)
                    if not cols or not cols <= (lnames | rnames):
                        rest.append(c)
                        continue
                    if (
                        isinstance(c, A.BinOp) and c.op == "="
                        and isinstance(c.left, A.Col) and isinstance(c.right, A.Col)
                    ):
                        lq, rq = c.left.qualified, c.right.qualified
                        if lq in lnames and rq in rnames:
                            child.left_keys.append(lq)
                            child.right_keys.append(rq)
                            child.kind = "inner"
                            continue
                        if rq in lnames and lq in rnames:
                            child.left_keys.append(rq)
                            child.right_keys.append(lq)
                            child.kind = "inner"
                            continue
                    child.residual = conjoin(split_conjuncts(child.residual) + [c])
                    child.kind = "inner"
                keep = rest
            return P.Filter(child, conjoin(keep)) if keep else child

        # push through Union
        if isinstance(child, P.Union):
            names = child.output_names()
            for i, inp in enumerate(child.inputs):
                mapping = {n: A.Col(_b(c), _q(c)) for n, c in
                           zip(names, inp.output_names())}
                child.inputs[i] = self.rewrite_filters(
                    P.Filter(inp, substitute(pred, mapping)))
            return child

        # push through Aggregate when predicate only touches group keys
        if isinstance(child, P.Aggregate):
            gk = set(child.group_keys)
            pushable = [c for c in split_conjuncts(pred) if expr_columns(c) <= gk]
            stuck = [c for c in split_conjuncts(pred) if c not in pushable]
            if pushable and not child.grouping_sets:
                child.inputs = [self.rewrite_filters(
                    P.Filter(child.input, conjoin(pushable)))]
                return P.Filter(child, conjoin(stuck)) if stuck else child
            return node

        # land on a Scan: split into partition filter + pushed storage filter
        if isinstance(child, P.Scan):
            pcols = {f"{child.alias}.{c}" for c in child.table.partition_cols}
            part, data, keep = [], [], []
            for c in split_conjuncts(pred):
                cols = expr_columns(c)
                if not cols:
                    keep.append(c)
                elif cols <= pcols and self.config.partition_pruning:
                    part.append(c)
                else:
                    data.append(c)
            if part:
                child.partition_filter = conjoin(
                    split_conjuncts(child.partition_filter) + part
                )
            if data:
                stripped = [strip_alias(c) for c in data]
                child.pushed_filter = conjoin(
                    split_conjuncts(child.pushed_filter) + stripped
                )
            return P.Filter(child, conjoin(keep)) if keep else child

        if isinstance(child, P.Sort):
            child.inputs = [self.rewrite_filters(P.Filter(child.input, pred))]
            return child
        node.predicate = pred
        return node

    # transitive predicate inference over equi-join keys (§4.1)
    def infer_transitive(self, node: P.PlanNode) -> P.PlanNode:
        node.inputs = [self.infer_transitive(c) for c in node.inputs]
        if not isinstance(node, P.Join) or node.kind not in ("inner", "semi"):
            return node
        l_preds = _single_col_preds(node.left)
        r_preds = _single_col_preds(node.right)
        for lk, rk in zip(node.left_keys, node.right_keys):
            for (col, tmpl) in list(l_preds):
                if col == lk:
                    derived = _retarget(tmpl, rk)
                    if not _has_pred(node.right, derived):
                        node.inputs[1] = P.Filter(node.right, derived)
            for (col, tmpl) in list(r_preds):
                if col == rk and node.kind == "inner":
                    derived = _retarget(tmpl, lk)
                    if not _has_pred(node.left, derived):
                        node.inputs[0] = P.Filter(node.left, derived)
        return node

    # projection pruning: narrow scans & projects to required columns
    def prune_columns(self, node: P.PlanNode, required: Set[str]) -> P.PlanNode:
        if isinstance(node, P.Scan):
            pcols = set(node.table.partition_cols)
            needed_raw = {
                c for c in node.columns
                if f"{node.alias}.{c}" in required
            }
            needed_raw |= {c.name for c in
                           (A.walk(node.pushed_filter) if node.pushed_filter else [])
                           if isinstance(c, A.Col)}
            for rf in node.runtime_filters:
                needed_raw.add(rf.target_column)
            kept = [c for c in node.columns if c in needed_raw or c in pcols]
            if not kept and node.columns:
                kept = [node.columns[0]]  # COUNT(*): keep one column for cardinality
            node.columns = kept
            for rf in node.runtime_filters:
                rf.producer = self.prune_columns(
                    rf.producer, set(rf.producer.output_names()))
            return node
        if isinstance(node, P.FederatedScan):
            # narrow the logical column set; whether the narrowing reaches
            # the remote system is decided later by push_projection during
            # the capability negotiation
            if node.spec is None and node._output_cols is None:
                needed = [c for c in node.columns
                          if f"{node.alias}.{c}" in required]
                if needed:
                    node.columns = needed
            return node
        if isinstance(node, P.Project):
            node.exprs = [(e, n) for e, n in node.exprs if n in required] or \
                node.exprs[:1]
            child_req = set()
            for e, _ in node.exprs:
                child_req |= expr_columns(e)
            node.inputs = [self.prune_columns(node.input, child_req)]
            return node
        if isinstance(node, P.Filter):
            child_req = required | expr_columns(node.predicate)
            node.inputs = [self.prune_columns(node.input, child_req)]
            return node
        if isinstance(node, P.Join):
            child_req = set(required)
            child_req |= set(node.left_keys) | set(node.right_keys)
            child_req |= expr_columns(node.residual)
            lnames = set(node.left.output_names())
            rnames = set(node.right.output_names())
            node.inputs[0] = self.prune_columns(node.left, child_req & lnames)
            node.inputs[1] = self.prune_columns(node.right, child_req & rnames)
            return node
        if isinstance(node, P.Aggregate):
            child_req = set(node.group_keys)
            for a in node.aggs:
                child_req |= expr_columns(a.arg)
            node.inputs = [self.prune_columns(node.input, child_req)]
            return node
        if isinstance(node, P.WindowOp):
            child_req = set(required)
            for wf, _ in node.funcs:
                child_req |= expr_columns(wf)
            node.inputs = [self.prune_columns(
                node.input, child_req & set(node.input.output_names()))]
            return node
        if isinstance(node, P.Sort):
            child_req = required | {k for k, _ in node.keys}
            node.inputs = [self.prune_columns(node.input, child_req)]
            return node
        if isinstance(node, (P.Limit,)):
            node.inputs = [self.prune_columns(node.input, required)]
            return node
        if isinstance(node, P.Union):
            names = node.output_names()
            for i, inp in enumerate(node.inputs):
                mapping = dict(zip(names, inp.output_names()))
                node.inputs[i] = self.prune_columns(
                    inp, {mapping[n] for n in names})
            return node
        node.inputs = [self.prune_columns(c, set(c.output_names()))
                       for c in node.inputs]
        return node

    # ------------------------------------------------------------------ stage 2
    def reorder_joins(self, node: P.PlanNode) -> P.PlanNode:
        node.inputs = [self.reorder_joins(c) for c in node.inputs]
        if not isinstance(node, P.Join) or node.kind != "inner":
            return node
        rels, edges, residuals = [], [], []
        if not _collect_join_tree(node, rels, edges, residuals):
            return node
        if len(rels) < 3:
            return node
        return self._greedy_join_order(rels, edges, residuals,
                                       node.output_names())

    def _greedy_join_order(self, rels, edges, residuals, out_names):
        remaining = list(range(len(rels)))
        plans: Dict[int, P.PlanNode] = {i: r for i, r in enumerate(rels)}
        groups: Dict[int, Set[int]] = {i: {i} for i in remaining}

        def edge_between(ga: Set[int], gb: Set[int]):
            keys_l, keys_r = [], []
            for (i, lk, j, rk) in edges:
                if i in ga and j in gb:
                    keys_l.append(lk)
                    keys_r.append(rk)
                elif j in ga and i in gb:
                    keys_l.append(rk)
                    keys_r.append(lk)
            return keys_l, keys_r

        while len(remaining) > 1:
            best = None
            for ai in range(len(remaining)):
                for bi in range(ai + 1, len(remaining)):
                    a, b = remaining[ai], remaining[bi]
                    kl, kr = edge_between(groups[a], groups[b])
                    if not kl:
                        continue
                    cand = P.Join(plans[a], plans[b], "inner", kl, kr)
                    rows = self.cost_model.estimate(cand).rows
                    if best is None or rows < best[0]:
                        best = (rows, a, b, cand)
            if best is None:  # only cross joins left: pick smallest pair
                a, b = remaining[0], remaining[1]
                cand = P.Join(plans[a], plans[b], "cross", [], [])
                best = (0, a, b, cand)
            _, a, b, joined = best
            plans[a] = joined
            groups[a] |= groups[b]
            remaining.remove(b)
        plan = plans[remaining[0]]
        if residuals:
            plan = P.Filter(plan, conjoin(residuals))
        # restore the original column order expected by parents
        if plan.output_names() != out_names and set(out_names) <= set(plan.output_names()):
            plan = P.Project(plan, [(A.Col(_b(n), _q(n)), n) for n in out_names])
        return plan

    def choose_join_strategy(self, node: P.PlanNode) -> P.PlanNode:
        node.inputs = [self.choose_join_strategy(c) for c in node.inputs]
        if isinstance(node, P.Join) and node.kind in ("inner", "semi", "anti", "left"):
            left_rows = self.cost_model.estimate(node.left).rows
            right_rows = self.cost_model.estimate(node.right).rows
            # orient the smaller side as build (right) when legal
            if node.kind == "inner" and left_rows < right_rows:
                node.inputs = [node.right, node.left]
                node.left_keys, node.right_keys = node.right_keys, node.left_keys
                left_rows, right_rows = right_rows, left_rows
                # output order changes; re-project to original order
                # (callers read columns by name, order only matters at the top)
            node.strategy = (
                "broadcast"
                if right_rows <= self.config.broadcast_threshold_rows
                else "shuffle"
            )
        return node


# ---------------------------------------------------------------------------
def _b(qualified: str) -> str:
    return qualified.split(".", 1)[1] if "." in qualified else qualified


def _q(qualified: str):
    return qualified.split(".", 1)[0] if "." in qualified else None


def _single_col_preds(node: P.PlanNode) -> List[Tuple[str, A.Expr]]:
    """Collect (column, predicate) pairs filtering a single column under node."""
    out = []
    if isinstance(node, P.Filter):
        for c in split_conjuncts(node.predicate):
            cols = expr_columns(c)
            if len(cols) == 1 and _is_value_pred(c):
                out.append((next(iter(cols)), c))
        out.extend(_single_col_preds(node.input))
    elif isinstance(node, P.Scan):
        for src in (node.pushed_filter, node.partition_filter):
            if src is not None:
                for c in split_conjuncts(src):
                    cols = expr_columns(c)
                    if len(cols) == 1 and _is_value_pred(c):
                        col = next(iter(cols))
                        if "." not in col:
                            col = f"{node.alias}.{col}"
                            c = _retarget(c, col)
                        out.append((col, c))
    return out


def _is_value_pred(e: A.Expr) -> bool:
    if isinstance(e, A.BinOp) and e.op in ("=", "<", "<=", ">", ">=", "!="):
        return isinstance(e.left, A.Lit) or isinstance(e.right, A.Lit)
    if isinstance(e, (A.InList, A.Between)):
        return True
    return False


def _retarget(e: A.Expr, new_col: str) -> A.Expr:
    if isinstance(e, A.Col):
        return A.Col(_b(new_col), _q(new_col))
    return _rebuild(e, [_retarget(c, new_col) for c in e.children()])


def _has_pred(node: P.PlanNode, pred: A.Expr) -> bool:
    key = pred.key()
    for n in P.walk_plan(node):
        if isinstance(n, P.Filter):
            if any(c.key() == key for c in split_conjuncts(n.predicate)):
                return True
        if isinstance(n, P.Scan):
            for src in (n.pushed_filter, n.partition_filter):
                if src is not None:
                    stripped_key = strip_alias(pred).key()
                    if any(c.key() in (key, stripped_key)
                           for c in split_conjuncts(src)):
                        return True
    return False


def _collect_join_tree(node, rels: list, edges: list, residuals: list) -> bool:
    """Flatten a tree of inner joins into relations + equi edges.

    Returns False if the subtree contains anything but inner joins (outer
    joins constrain ordering and are left untouched).
    """
    if isinstance(node, P.Join) and node.kind == "inner":
        if node.residual is not None:
            residuals.extend(split_conjuncts(node.residual))
        ok_l = _collect_join_tree(node.left, rels, edges, residuals)
        if not ok_l:
            return False
        # record which relation indices each side covers BEFORE adding right
        left_count = len(rels)
        ok_r = _collect_join_tree(node.right, rels, edges, residuals)
        if not ok_r:
            return False
        name_to_rel = {}
        for idx, r in enumerate(rels):
            for n in r.output_names():
                name_to_rel[n] = idx
        for lk, rk in zip(node.left_keys, node.right_keys):
            if lk in name_to_rel and rk in name_to_rel:
                edges.append((name_to_rel[lk], lk, name_to_rel[rk], rk))
        return True
    rels.append(node)
    return True
