"""Semantic analysis: AST -> bound logical plan (paper §2, Fig. 2 "logical plan").

Responsibilities:
  * name resolution against the metastore catalog (incl. scope chains for
    correlated subqueries),
  * subquery unnesting: IN / EXISTS / scalar subqueries — correlated or not —
    become semi/anti/left joins (Calcite's subquery-remove rules; paper §3.1
    counts correlated subqueries among the SQL features added to Hive),
  * aggregate extraction (incl. AVG -> SUM/COUNT decomposition, which also
    enables materialized-view rewrites over AVG),
  * window functions, grouping sets, set operations, DISTINCT.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from ..metastore import Metastore
from ..optimizer import plan as P
from . import ast as A


class BindError(Exception):
    pass


class Scope:
    def __init__(self, tables: Dict[str, List[str]], parent: Optional["Scope"] = None):
        # alias -> list of raw column names
        self.tables = tables
        self.parent = parent
        self.correlated_uses: List[str] = []  # qualified outer columns we touched

    def resolve(self, col: A.Col) -> Tuple[str, int]:
        """Return (qualified_name, level); level 0 = local, 1+ = outer."""
        if col.table is not None:
            level = 0
            scope = self
            while scope is not None:
                if col.table in scope.tables:
                    if col.name in scope.tables[col.table]:
                        return f"{col.table}.{col.name}", level
                    raise BindError(f"column {col.name} not in {col.table}")
                scope, level = scope.parent, level + 1
            raise BindError(f"unknown table alias {col.table}")
        level = 0
        scope = self
        while scope is not None:
            hits = [t for t, cols in scope.tables.items() if col.name in cols]
            if len(hits) > 1:
                raise BindError(f"ambiguous column {col.name} ({hits})")
            if hits:
                return f"{hits[0]}.{col.name}", level
            scope, level = scope.parent, level + 1
        raise BindError(f"unknown column {col.name}")

    def all_columns(self, alias: Optional[str] = None) -> List[str]:
        out = []
        for t, cols in self.tables.items():
            if alias is None or t == alias:
                out.extend(f"{t}.{c}" for c in cols)
        return out


def split_conjuncts(e: Optional[A.Expr]) -> List[A.Expr]:
    if e is None:
        return []
    if isinstance(e, A.BinOp) and e.op == "AND":
        return split_conjuncts(e.left) + split_conjuncts(e.right)
    return [e]


def conjoin(es: Sequence[A.Expr]) -> Optional[A.Expr]:
    es = list(es)
    if not es:
        return None
    out = es[0]
    for e in es[1:]:
        out = A.BinOp("AND", out, e)
    return out


class Binder:
    def __init__(self, hms: Metastore, catalogs=None):
        self.hms = hms
        self.catalogs = catalogs  # CatalogRegistry (three-part names, §6)
        self._counter = itertools.count()

    def _fresh(self, prefix: str) -> str:
        return f"{prefix}_{next(self._counter)}"

    # ======================================================================
    # statements
    # ======================================================================
    def bind(self, stmt) -> P.PlanNode:
        if isinstance(stmt, A.Select):
            plan, _ = self.bind_select(stmt, None)
        elif isinstance(stmt, A.SetOp):
            plan, _ = self.bind_setop(stmt, None)
        else:
            raise BindError(f"cannot bind {type(stmt).__name__} as a query")
        # attach the typed schema contract (tolerant: EXPLAIN/compile
        # re-annotate after rewrites; the strict check is schema_check)
        from ..schema import annotate_plan

        annotate_plan(plan)
        return plan

    def bind_setop(self, s: A.SetOp, outer: Optional[Scope]):
        lplan, lnames = self._bind_query(s.left, outer)
        rplan, rnames = self._bind_query(s.right, outer)
        if len(lnames) != len(rnames):
            raise BindError("set operands have different arity")
        # align right column names to left
        if lplan.output_names() != rplan.output_names():
            rplan = P.Project(
                rplan,
                [(A.Col(_base(rn), _qual(rn)), ln)
                 for rn, ln in zip(rplan.output_names(), lplan.output_names())],
            )
        if s.kind == "union":
            plan = P.Union([lplan, rplan], all=s.all)
            if not s.all:
                plan = self._distinct(plan)
        elif s.kind == "intersect":
            plan = P.Join(
                self._distinct(lplan), self._distinct(rplan), "semi",
                lplan.output_names(), lplan.output_names(),
            )
        elif s.kind == "except":
            plan = P.Join(
                self._distinct(lplan), self._distinct(rplan), "anti",
                lplan.output_names(), lplan.output_names(),
            )
        else:
            raise BindError(f"unknown set op {s.kind}")
        if s.order_by:
            keys = []
            for e, desc in s.order_by:
                if isinstance(e, A.Lit) and isinstance(e.value, int):
                    keys.append((plan.output_names()[e.value - 1], desc))
                else:
                    raise BindError("set-op ORDER BY supports positional keys")
            plan = P.Sort(plan, keys)
        if s.limit is not None:
            plan = P.Limit(plan, s.limit)
        return plan, plan.output_names()

    def _bind_query(self, q, outer):
        if isinstance(q, A.Select):
            return self.bind_select(q, outer)
        return self.bind_setop(q, outer)

    def _distinct(self, plan: P.PlanNode) -> P.PlanNode:
        return P.Aggregate(plan, plan.output_names(), [])

    # ======================================================================
    # SELECT
    # ======================================================================
    def bind_select(self, sel: A.Select, outer: Optional[Scope]):
        if sel.from_ is None:
            # SELECT <consts>
            names, row = [], []
            for i, (e, alias) in enumerate(sel.projections):
                names.append(alias or f"_c{i}")
                row.append(e)
            return P.ValuesNode(names, [row]), names

        plan, scope = self._bind_from(sel.from_, outer)

        # ---- WHERE (with subquery unnesting) --------------------------------
        if sel.where is not None:
            plan, residual = self._apply_predicate(plan, scope, sel.where)
            if residual is not None:
                plan = P.Filter(plan, residual)

        # ---- star expansion --------------------------------------------------
        projections: List[Tuple[A.Expr, Optional[str]]] = []
        for e, alias in sel.projections:
            if isinstance(e, A.Star):
                for q in scope.all_columns(e.table):
                    projections.append((A.Col(_base(q), _qual(q)), _base(q)))
            else:
                projections.append((e, alias))

        # bind all output expressions (also unnests scalar subqueries in them)
        bound_projs: List[Tuple[A.Expr, str]] = []
        for i, (e, alias) in enumerate(projections):
            plan, be = self._bind_expr_unnesting(plan, scope, e)
            bound_projs.append((be, alias or _derive_name(be, i)))

        having = None
        if sel.having is not None:
            plan, having = self._bind_expr_unnesting(plan, scope, sel.having)

        order_bound: List[Tuple[A.Expr, bool]] = []
        for e, desc in sel.order_by:
            if isinstance(e, A.Lit) and isinstance(e.value, int):
                order_bound.append((bound_projs[e.value - 1][0], desc))
            else:
                # ORDER BY may reference projection aliases (§7.1: "order by
                # unselected columns" is also allowed -> falls through to expr)
                matched = None
                if isinstance(e, A.Col) and e.table is None:
                    for be, name in bound_projs:
                        if name == e.name:
                            matched = be
                            break
                if matched is None:
                    plan, matched = self._bind_expr_unnesting(plan, scope, e)
                order_bound.append((matched, desc))

        group_bound: List[A.Expr] = []
        for e in sel.group_by:
            if isinstance(e, A.Lit) and isinstance(e.value, int):
                group_bound.append(bound_projs[e.value - 1][0])
            else:
                plan, be = self._bind_expr_unnesting(plan, scope, e)
                group_bound.append(be)

        # ---- aggregation ------------------------------------------------------
        need_agg = bool(group_bound) or any(
            A.contains_aggregate(be) for be, _ in bound_projs
        ) or (having is not None and A.contains_aggregate(having))

        if need_agg:
            plan, rewrite = self._build_aggregate(
                plan, group_bound, bound_projs, having, order_bound,
                sel.grouping_sets, scope,
            )
            bound_projs = [(rewrite(be), n) for be, n in bound_projs]
            having = rewrite(having) if having is not None else None
            order_bound = [(rewrite(be), d) for be, d in order_bound]

        if having is not None:
            plan = P.Filter(plan, having)

        # ---- window functions -------------------------------------------------
        win_map: Dict[str, str] = {}
        win_funcs: List[Tuple[A.WindowFunc, str]] = []
        for be, _ in bound_projs + [(e, None) for e, _ in order_bound]:
            for node in A.walk(be):
                if isinstance(node, A.WindowFunc) and node.key() not in win_map:
                    name = self._fresh("w")
                    win_map[node.key()] = name
                    win_funcs.append((node, name))
        if win_funcs:
            plan = P.WindowOp(plan, win_funcs)
            repl = lambda e: _replace_by_key(e, win_map)
            bound_projs = [(repl(be), n) for be, n in bound_projs]
            order_bound = [(repl(be), d) for be, d in order_bound]

        # ---- final projection / distinct / order / limit -----------------------
        out_names = _uniquify([n for _, n in bound_projs])
        proj_exprs = [(be, n) for (be, _), n in zip(bound_projs, out_names)]

        # sort keys that aren't plain output columns ride along as hidden cols
        sort_keys: List[Tuple[str, bool]] = []
        hidden: List[Tuple[A.Expr, str]] = []
        for be, desc in order_bound:
            name = None
            for e2, n2 in proj_exprs:
                if e2.key() == be.key():
                    name = n2
                    break
            if name is None:
                name = self._fresh("sk")
                hidden.append((be, name))
            sort_keys.append((name, desc))

        plan = P.Project(plan, proj_exprs + hidden)
        if sel.distinct:
            if hidden:
                raise BindError("DISTINCT with non-projected ORDER BY keys")
            plan = self._distinct(plan)
        if sort_keys:
            plan = P.Sort(plan, sort_keys)
        if sel.limit is not None:
            plan = P.Limit(plan, sel.limit)
        if hidden:
            plan = P.Project(
                plan, [(A.Col(_base(n), _qual(n)) if "." in n else A.Col(n), n)
                       for n in out_names]
            )
        return plan, out_names

    # ======================================================================
    # FROM clause
    # ======================================================================
    def _bind_from(self, node, outer: Optional[Scope]):
        if isinstance(node, A.TableRef):
            if node.catalog is not None:
                # catalog.schema.table: resolve through the mounted catalog's
                # connector with lazy remote-schema discovery (paper §6)
                if self.catalogs is None:
                    raise BindError(
                        f"no catalog registry to resolve "
                        f"{node.catalog}.{node.name}"
                    )
                cat = self.catalogs.get(node.catalog)
                if cat is None:
                    raise BindError(f"unknown catalog {node.catalog!r}")
                try:
                    desc = cat.table_desc(node.schema, node.name)
                except KeyError as exc:
                    raise BindError(str(exc)) from exc
                alias = node.alias or node.name
                cols = [c for c, _ in desc.schema]
                return (P.FederatedScan(desc, alias, cols),
                        Scope({alias: cols}, outer))
            desc = self.hms.get_table(node.name)
            alias = node.alias or node.name
            if desc.is_mv and desc.mv_sql is None:
                raise BindError(f"materialized view {node.name} has no definition")
            cols = [c for c, _ in desc.schema]
            scan: P.PlanNode
            if desc.handler:
                scan = P.FederatedScan(desc, alias, cols)
            else:
                scan = P.Scan(desc, alias, cols)
            return scan, Scope({alias: cols}, outer)
        if isinstance(node, A.SubqueryRef):
            subplan, names = self._bind_query(node.query, outer)
            base_names = [_base(n) for n in names]
            proj = P.Project(
                subplan,
                [(A.Col(_base(n), _qual(n)) if "." in n else A.Col(n),
                  f"{node.alias}.{b}") for n, b in zip(names, base_names)],
            )
            return proj, Scope({node.alias: base_names}, outer)
        if isinstance(node, A.JoinRef):
            lplan, lscope = self._bind_from(node.left, outer)
            rplan, rscope = self._bind_from(node.right, outer)
            merged = Scope({**lscope.tables, **rscope.tables}, outer)
            if node.condition is None:
                return (
                    P.Join(lplan, rplan, "cross" if node.kind == "cross" else "inner",
                           [], []),
                    merged,
                )
            cond = self._bind_expr(node.condition, merged)
            lnames, rnames = set(lplan.output_names()), set(rplan.output_names())
            keys_l, keys_r, residual = _classify_join_condition(cond, lnames, rnames)
            kind = node.kind
            if kind == "right":  # normalize RIGHT to LEFT by swapping inputs
                lplan, rplan = rplan, lplan
                keys_l, keys_r = keys_r, keys_l
                kind = "left"
            return P.Join(lplan, rplan, kind, keys_l, keys_r, residual), merged
        raise BindError(f"unsupported FROM element {type(node).__name__}")

    # ======================================================================
    # predicates & subquery unnesting
    # ======================================================================
    def _apply_predicate(self, plan, scope, where):
        conjuncts = split_conjuncts(where)
        plain: List[A.Expr] = []
        for c in conjuncts:
            sub = _find_subquery(c)
            if sub is None:
                plain.append(self._bind_expr(c, scope))
            else:
                plan = self._unnest_predicate_subquery(plan, scope, c, sub)
        return plan, conjoin(plain)

    def _unnest_predicate_subquery(self, plan, scope, conjunct, sub: A.SubqueryExpr):
        subscope_parent = scope
        subplan, subnames = self._bind_query(sub.query, subscope_parent)
        # correlation: equality conjuncts referencing outer columns were bound
        # inside subplan Filters; extract them into join keys.
        subplan, corr_pairs = _extract_correlation(subplan, scope)

        if sub.kind in ("in", "exists"):
            lkeys, rkeys = [c[0] for c in corr_pairs], [c[1] for c in corr_pairs]
            if sub.kind == "in":
                lhs = self._bind_expr(sub.expr, scope)
                if not isinstance(lhs, A.Col):
                    raise BindError("IN subquery LHS must be a column")
                lkeys = [lhs.qualified] + lkeys
                rkeys = [subnames[0]] + rkeys
            kind = "anti" if sub.negated else "semi"
            if conjunct is not sub and not (
                isinstance(conjunct, A.SubqueryExpr)
                or (isinstance(conjunct, A.UnOp) and conjunct.op == "NOT")
            ):
                raise BindError("subquery must be a top-level conjunct")
            if isinstance(conjunct, A.UnOp) and conjunct.op == "NOT":
                kind = "semi" if kind == "anti" else "anti"
            build = self._distinct(P.Project(
                subplan,
                [(A.Col(_base(n), _qual(n)), n) for n in rkeys],
            )) if rkeys else subplan
            return P.Join(plan, build, kind, lkeys, rkeys)

        if sub.kind == "scalar":
            # comparison against a (possibly correlated) scalar subquery
            return self._join_scalar_subquery(
                plan, scope, conjunct, sub, subplan, subnames, corr_pairs,
                as_filter=True,
            )
        raise BindError(f"unsupported subquery kind {sub.kind}")

    def _join_scalar_subquery(self, plan, scope, expr, sub, subplan, subnames,
                              corr_pairs, as_filter: bool):
        val_col = subnames[0]
        out_name = self._fresh("sq")
        if corr_pairs:
            keys_inner = [p[1] for p in corr_pairs]
            gk = keys_inner
            sub_agg = P.Project(
                subplan,
                [(A.Col(_base(n), _qual(n)), n) for n in gk + [val_col]],
            )
            # subquery must be scalar per group; binder trusts aggregate shape
            joined = P.Join(plan, sub_agg, "left",
                            [p[0] for p in corr_pairs], keys_inner)
        else:
            joined = P.Join(plan, subplan, "cross", [], [])
        rename = P.Project(
            joined,
            [(A.Col(_base(n), _qual(n)) if "." in n else A.Col(n), n)
             for n in plan.output_names()]
            + [(A.Col(_base(val_col), _qual(val_col)) if "." in val_col
                else A.Col(val_col), out_name)],
        )
        if as_filter:
            pred = _replace_subquery(expr, sub, A.Col(out_name))
            pred = self._bind_expr(pred, _scope_of(rename))
            return P.Filter(rename, pred)
        return rename, A.Col(out_name)

    def _bind_expr_unnesting(self, plan, scope, e):
        sub = _find_subquery(e)
        if sub is None:
            return plan, self._bind_expr(e, scope)
        if sub.kind != "scalar":
            raise BindError("only scalar subqueries allowed in this context")
        subplan, subnames = self._bind_query(sub.query, scope)
        subplan, corr = _extract_correlation(subplan, scope)
        plan2, ref = self._join_scalar_subquery(
            plan, scope, e, sub, subplan, subnames, corr, as_filter=False
        )
        new_e = _replace_subquery(e, sub, ref)
        # rebind remaining structure (ref resolves via plan outputs)
        return plan2, self._bind_expr_loose(new_e, plan2, scope)

    def _bind_expr_loose(self, e, plan, scope):
        """Bind against scope but let already-qualified synthetic cols pass."""
        outputs = set(plan.output_names())

        def rec(x):
            if isinstance(x, A.Col):
                if x.qualified in outputs or (x.table is None and x.name in outputs):
                    return A.Col(x.name, x.table)
                q, _ = scope.resolve(x)
                return A.Col(_base(q), _qual(q))
            return _rebuild(x, [rec(c) for c in x.children()])

        return rec(e)

    # ---- plain expression binding -------------------------------------------
    def _bind_expr(self, e: A.Expr, scope: Scope) -> A.Expr:
        if isinstance(e, A.Col):
            q, level = scope.resolve(e)
            if level > 0:
                scope.correlated_uses.append(q)
                return A.Col(_base(q), _qual(q))  # outer ref, same shape
            return A.Col(_base(q), _qual(q))
        if isinstance(e, A.SubqueryExpr):
            return e  # handled by unnesting paths
        if isinstance(e, A.Param):
            return e  # bound at execution time from ExecContext.params
        return _rebuild(e, [self._bind_expr(c, scope) for c in e.children()])

    # ======================================================================
    # aggregation builder
    # ======================================================================
    def _build_aggregate(self, plan, group_bound, bound_projs, having,
                         order_bound, grouping_sets, scope):
        # collect aggregate calls from every post-agg expression
        agg_calls: Dict[str, A.Func] = {}

        def collect(e):
            if e is None:
                return
            for node in A.walk(e):
                if isinstance(node, A.WindowFunc):
                    continue
                if isinstance(node, A.Func) and node.name in A.AGG_FUNCS:
                    agg_calls.setdefault(node.key(), node)

        for be, _ in bound_projs:
            collect(be)
        collect(having)
        for be, _ in order_bound:
            collect(be)

        # AVG -> SUM/COUNT so rollups & MV rewrites stay additive
        decomposed: Dict[str, A.Expr] = {}
        final_calls: Dict[str, A.Func] = {}
        for k, f in agg_calls.items():
            if f.name == "avg":
                s = A.Func("sum", f.args, f.distinct)
                c = A.Func("count", f.args, f.distinct)
                decomposed[k] = A.BinOp("/", s, c)
                final_calls.setdefault(s.key(), s)
                final_calls.setdefault(c.key(), c)
            else:
                final_calls.setdefault(k, f)

        # pre-aggregation projection: group keys + aggregate arguments
        pre_exprs: List[Tuple[A.Expr, str]] = []
        group_names: List[str] = []
        group_map: Dict[str, str] = {}
        for g in group_bound:
            if isinstance(g, A.Col):
                name = g.qualified
            else:
                name = self._fresh("gk")
            group_map[g.key()] = name
            group_names.append(name)
            pre_exprs.append((g, name))

        specs: List[P.AggSpec] = []
        agg_out: Dict[str, str] = {}
        for k, f in final_calls.items():
            arg = None
            if f.args and not isinstance(f.args[0], A.Star):
                arg = f.args[0]
            out = self._fresh("agg")
            agg_out[k] = out
            if arg is not None:
                arg_name = arg.qualified if isinstance(arg, A.Col) else self._fresh("aa")
                if arg_name not in [n for _, n in pre_exprs]:
                    pre_exprs.append((arg, arg_name))
                specs.append(P.AggSpec(f.name, A.Col(_base(arg_name), _qual(arg_name)),
                                       f.distinct, out))
            else:
                specs.append(P.AggSpec(f.name, None, f.distinct, out))

        pre = P.Project(plan, pre_exprs) if pre_exprs else plan
        gsets = None
        if grouping_sets is not None:
            gsets = []
            for s in grouping_sets:
                names = []
                for e in s:
                    be = self._bind_expr(e, scope)
                    names.append(group_map[be.key()])
                gsets.append(names)
        agg = P.Aggregate(pre, group_names, specs, gsets)

        replace_map = dict(group_map)

        def rewrite(e):
            if e is None:
                return None
            if e.key() in replace_map:
                n = replace_map[e.key()]
                return A.Col(_base(n), _qual(n))
            if isinstance(e, A.Func) and e.name in A.AGG_FUNCS:
                if e.key() in decomposed:
                    return rewrite(decomposed[e.key()])
                n = agg_out[e.key()]
                return A.Col(_base(n), _qual(n))
            if isinstance(e, A.WindowFunc):
                return A.WindowFunc(
                    rewrite(e.func), tuple(rewrite(x) for x in e.partition_by),
                    tuple((rewrite(x), d) for x, d in e.order_by),
                )
            return _rebuild(e, [rewrite(c) for c in e.children()])

        return agg, rewrite


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _base(qualified: str) -> str:
    return qualified.split(".", 1)[1] if "." in qualified else qualified


def _qual(qualified: str) -> Optional[str]:
    return qualified.split(".", 1)[0] if "." in qualified else None


def _uniquify(names: List[str]) -> List[str]:
    seen: Dict[str, int] = {}
    out = []
    for n in names:
        if n in seen:
            seen[n] += 1
            out.append(f"{n}_{seen[n]}")
        else:
            seen[n] = 0
            out.append(n)
    return out


def _derive_name(e: A.Expr, i: int) -> str:
    if isinstance(e, A.Col):
        return e.name
    if isinstance(e, A.Func):
        return f"{e.name}_{i}"
    return f"_c{i}"


def _rebuild(e: A.Expr, new_children: List[A.Expr]) -> A.Expr:
    """Reconstruct a frozen expr dataclass with replaced Expr children."""
    import dataclasses as dc

    it = iter(new_children)
    kwargs = {}
    for f in dc.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, A.Expr):
            kwargs[f.name] = next(it)
        elif isinstance(v, tuple) and v and all(isinstance(x, A.Expr) for x in v):
            kwargs[f.name] = tuple(next(it) for _ in v)
        elif (
            isinstance(v, tuple) and v
            and all(isinstance(x, tuple) and len(x) == 2 for x in v)
            and all(isinstance(x[0], A.Expr) for x in v)
        ):
            if all(isinstance(x[1], A.Expr) for x in v):  # Case.whens
                kwargs[f.name] = tuple((next(it), next(it)) for _ in v)
            else:  # WindowFunc.order_by: (expr, bool)
                kwargs[f.name] = tuple((next(it), x[1]) for x in v)
        else:
            kwargs[f.name] = v
    return type(e)(**kwargs)


def _find_subquery(e: A.Expr) -> Optional[A.SubqueryExpr]:
    for node in A.walk(e):
        if isinstance(node, A.SubqueryExpr):
            return node
    return None


def _replace_subquery(e: A.Expr, target: A.SubqueryExpr, repl: A.Expr) -> A.Expr:
    if e is target:
        return repl
    if isinstance(e, A.SubqueryExpr):
        return e
    kids = [_replace_subquery(c, target, repl) for c in e.children()]
    return _rebuild(e, kids)


def _classify_join_condition(cond, lnames, rnames):
    keys_l, keys_r, residual = [], [], []
    for c in split_conjuncts(cond):
        if (
            isinstance(c, A.BinOp) and c.op == "="
            and isinstance(c.left, A.Col) and isinstance(c.right, A.Col)
        ):
            lq, rq = c.left.qualified, c.right.qualified
            if lq in lnames and rq in rnames:
                keys_l.append(lq)
                keys_r.append(rq)
                continue
            if rq in lnames and lq in rnames:
                keys_l.append(rq)
                keys_r.append(lq)
                continue
        residual.append(c)
    return keys_l, keys_r, conjoin(residual)


def _extract_correlation(subplan: P.PlanNode, outer_scope: Scope):
    """Pull equality conjuncts that reference outer columns out of the
    subquery plan's filters; return (new_plan, [(outer_q, inner_q), ...])."""
    outer_cols = set()
    scope = outer_scope
    while scope is not None:
        outer_cols.update(scope.all_columns())
        scope = scope.parent

    pairs: List[Tuple[str, str]] = []

    def visit(node: P.PlanNode) -> P.PlanNode:
        for i, child in enumerate(node.inputs):
            node.inputs[i] = visit(child)
        if isinstance(node, P.Filter):
            inner_names = set(node.input.output_names())
            keep = []
            for c in split_conjuncts(node.predicate):
                if (
                    isinstance(c, A.BinOp) and c.op == "="
                    and isinstance(c.left, A.Col) and isinstance(c.right, A.Col)
                ):
                    lq, rq = c.left.qualified, c.right.qualified
                    if lq in outer_cols and rq in inner_names and lq not in inner_names:
                        pairs.append((lq, rq))
                        continue
                    if rq in outer_cols and lq in inner_names and rq not in inner_names:
                        pairs.append((rq, lq))
                        continue
                keep.append(c)
            if not keep:
                return node.input
            node.predicate = conjoin(keep)
        return node

    newplan = visit(subplan)

    # Correlated aggregates: if the subquery aggregates globally but we pulled
    # correlation keys out, re-group by the inner correlation keys so the join
    # preserves per-outer-row semantics.
    if pairs:
        inner_keys = [p[1] for p in pairs]

        def fix_agg(node):
            for i, child in enumerate(node.inputs):
                node.inputs[i] = fix_agg(child)
            if isinstance(node, P.Aggregate) and not node.group_keys:
                avail = set(node.input.output_names())
                missing = [k for k in inner_keys if k not in avail]
                if missing and isinstance(node.input, P.Project):
                    src = node.input
                    src_avail = set(src.input.output_names())
                    if all(k in src_avail for k in missing):
                        src.exprs = src.exprs + [
                            (A.Col(_base(k), _qual(k)), k) for k in missing
                        ]
                        avail = set(src.output_names())
                if all(k in avail for k in inner_keys):
                    node.group_keys = list(inner_keys)
            if isinstance(node, P.Project):
                # ensure correlation keys survive the projection above the agg
                have = {n for _, n in node.exprs}
                child_names = set(node.input.output_names())
                for k in inner_keys:
                    if k not in have and k in child_names:
                        node.exprs = node.exprs + [(A.Col(_base(k), _qual(k)), k)]
            return node

        newplan = fix_agg(newplan)
    return newplan, pairs


def _replace_by_key(e: A.Expr, mapping: Dict[str, str]) -> A.Expr:
    if e is None:
        return None
    if e.key() in mapping:
        return A.Col(mapping[e.key()])
    return _rebuild(e, [_replace_by_key(c, mapping) for c in e.children()])


def _scope_of(plan: P.PlanNode) -> Scope:
    tables: Dict[str, List[str]] = {}
    loose = []
    for n in plan.output_names():
        if "." in n:
            t, c = n.split(".", 1)
            tables.setdefault(t, []).append(c)
        else:
            loose.append(n)
    if loose:
        tables[""] = loose

    class _LooseScope(Scope):
        def resolve(self, col: A.Col):
            try:
                return super().resolve(col)
            except BindError:
                if col.table is None and "" in self.tables and col.name in self.tables[""]:
                    return col.name, 0
                raise

    return _LooseScope(tables)
