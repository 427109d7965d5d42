"""Static schema-flow checker for plans and compiled task DAGs (SCH001-006).

``repro_torch.core.schema`` defines the typed contract — ``ColumnType``/``Schema``
plus the per-node inference rules mirroring the executor's dtype semantics.
This module is the verification pass over that contract: it re-infers every
vertex's output schema in topological order (placeholders seeded from their
producer's inferred schema) and reports *definite* contradictions as rule-
coded findings.  Unknowable types degrade to ``any`` and are never flagged.

Rule codes:

=======  ==================================================================
SCH001   a column reference does not resolve against its input schema
SCH002   UNION / ShuffleRead branch schemas disagree (arity or dtypes with
         no common promotion)
SCH003   aggregate partial state and its merging fold disagree on the state
         dtype (a split/collapse or federated merge rewrite would silently
         change the result type — e.g. a float32 MIN partial re-folded
         through SUM)
SCH004   join or shuffle-partition key dtypes disagree across sides/lanes
         (the bitcast FNV ``hash_partition`` kernel routes string and
         numeric keys through different bit patterns, so mixed-family keys
         co-partition wrongly)
SCH005   a federated residual operator references a column the pushed
         projection/aggregate dropped from the connector's output
SCH006   a DAG edge placeholder disagrees with its producer vertex's output
         schema (names or declared dtypes)
=======  ==================================================================

Like the structural validator, this runs on every compiled (and adaptively
mutated) DAG when ``REPRO_VALIDATE_PLANS`` / ``debug.validate_plans`` is on:
``plan_validator.check_dag`` calls :func:`validate_dag_schemas` after its
structural pass, so the pipeline hook and the adaptive ``_adopt`` chokepoint
both get schema checking for free.
"""
from __future__ import annotations

from typing import Dict, List, Optional

RULES = {
    "SCH001": "unresolved column reference",
    "SCH002": "union/shuffle branch schema mismatch",
    "SCH003": "aggregate partial/merge fold state dtype mismatch",
    "SCH004": "join or shuffle-partition key dtype mismatch",
    "SCH005": "federated residual references a non-surviving column",
    "SCH006": "edge placeholder/producer schema disagreement",
}


def _classify(node, exc) -> str:
    """Map an inference failure on ``node`` to its rule code."""
    from ..core.optimizer import plan as P
    from ..core.schema import UnresolvedColumnError

    if isinstance(exc, UnresolvedColumnError):
        if _over_federated(node):
            return "SCH005"
        return "SCH001"
    if isinstance(node, (P.Union, P.ShuffleRead)):
        return "SCH002"
    if isinstance(node, P.Join):
        return "SCH004"
    return "SCH001"


def _over_federated(node) -> bool:
    """True when ``node`` is a residual operator directly over a pushed
    FederatedScan (walking through unary residual ops only)."""
    from ..core.optimizer import plan as P

    cur = node
    while cur.inputs:
        child = cur.inputs[0]
        if isinstance(child, P.FederatedScan):
            return child.spec is not None
        if not isinstance(child, (P.Filter, P.Project, P.Sort, P.Limit,
                                  P.Aggregate)):
            return False
        cur = child
    return False


def _check_merge_folds(node, src_schema, violations: List[str]) -> None:
    """SCH003: a merging-fold Aggregate (the shape split/collapse rewrites
    and federated partial-agg merges emit — each spec re-aggregates a
    partial-state column into itself) must preserve the state dtype."""
    from ..core.optimizer import plan as P
    from ..core.runtime.dag import MaterializedNode
    from ..core.schema import agg_result_type
    from ..core.sql import ast as A

    if not isinstance(node.input, (P.Union, P.Aggregate, MaterializedNode)):
        return
    for spec in node.aggs:
        if not (isinstance(spec.arg, A.Col) and spec.arg.table is None
                and spec.arg.name == spec.out_name
                and spec.arg.name in src_schema):
            continue  # not a self-fold over a partial-state column
        state = src_schema.get(spec.arg.name)
        folded = agg_result_type(spec.fn, state)
        if "any" in (state.token, folded.token):
            continue
        if folded.token != state.token:
            violations.append(
                f"SCH003: {node.describe()}: merging fold "
                f"{spec.fn}({spec.out_name}) changes the partial state "
                f"dtype {state.render()} -> {folded.render()}")


def _infer_collect(node, violations: List[str], memo: Dict[int, object],
                   where: str = ""):
    """Infer ``node``'s schema, recording rule-coded findings instead of
    raising; a subtree that already failed returns None (no cascades)."""
    from ..core.schema import SchemaMismatchError, infer_node

    if id(node) in memo:
        return memo[id(node)]
    ins = [_infer_collect(c, violations, memo, where) for c in node.inputs]
    out = None
    if not any(s is None for s in ins):
        try:
            out = infer_node(node, ins)
            from ..core.optimizer import plan as P

            if isinstance(node, P.Aggregate):
                _check_merge_folds(node, ins[0], violations)
        except SchemaMismatchError as exc:
            code = _classify(node, exc)
            violations.append(f"{code}: {where}{node.describe()}: {exc}")
    memo[id(node)] = out
    return out


def validate_plan_schema(plan) -> List[str]:
    """Schema-flow findings for one (pre-compile) plan tree."""
    violations: List[str] = []
    _infer_collect(plan, violations, {})
    return violations


def validate_dag_schemas(dag) -> List[str]:
    """Schema-flow findings for a compiled task DAG.

    Vertices are re-inferred in topo order; each ``MaterializedNode``
    placeholder is seeded with its producer vertex's inferred output schema
    (so drift across edges is caught), then checked against the
    placeholder's own declared names/schema (SCH006) and its lane keys
    (SCH004)."""
    from ..core.runtime.dag import _walk_materialized
    from ..core.schema import Schema

    violations: List[str] = []
    vertex_schema: Dict[str, Optional[Schema]] = {}
    try:
        order = dag.topo_order()
    except (KeyError, RecursionError):
        return []  # structurally broken; the structural pass reports it
    for vid in set(dag.vertices) - set(order):
        order.append(vid)  # staged/orphan vertices still get checked
    for vid in order:
        vert = dag.vertices[vid]
        memo: Dict[int, object] = {}
        for mn in _walk_materialized(vert.plan):
            produced = vertex_schema.get(mn.tag)
            if produced is None:
                declared = getattr(mn, "schema", None)
                memo[id(mn)] = declared if declared is not None \
                    else Schema.any_of(mn.names)
                continue
            _check_placeholder(vid, mn, produced, violations)
            memo[id(mn)] = produced.project(mn.names) \
                if set(mn.names) <= set(produced.names()) \
                else Schema.any_of(mn.names)
        vertex_schema[vid] = _infer_collect(vert.plan, violations, memo,
                                            where=f"{vid}: ")
    return violations


def _check_placeholder(vid, mn, produced, violations: List[str]) -> None:
    from ..core.schema import Schema

    if list(mn.names) != produced.names():
        violations.append(
            f"SCH006: {vid}: edge {mn.tag!r} placeholder declares columns "
            f"{list(mn.names)[:8]} but the producer emits "
            f"{produced.names()[:8]}")
        return
    declared: Optional[Schema] = getattr(mn, "schema", None)
    if declared is not None:
        for name, ty in declared:
            got = produced.get(name)
            if got is None or "any" in (ty.token, got.token):
                continue
            if got.token != ty.token and not ty.accepts(got.np_dtype()):
                violations.append(
                    f"SCH006: {vid}: edge {mn.tag!r} column {name!r} "
                    f"declared {ty.render()} but the producer emits "
                    f"{got.render()}")
    for key in mn.partition_keys:
        try:
            produced.resolve(key)
        except Exception:
            violations.append(
                f"SCH004: {vid}: edge {mn.tag!r} partition key {key!r} "
                f"does not resolve in the producer schema "
                f"{produced.names()[:8]} — lanes would hash a missing "
                f"column")
