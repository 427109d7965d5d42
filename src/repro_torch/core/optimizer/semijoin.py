"""Dynamic semijoin reduction (paper §4.6).

For star joins ``fact JOIN dim ON fact.k = dim.k`` where the dimension side
carries a selective filter, the optimizer attaches a *semijoin reducer* to
the fact-table scan:

  * **dynamic partition pruning** when the fact table is partitioned by the
    join column — partition directories are skipped while the query runs;
  * **index semijoin** otherwise — a min/max range + Bloom filter built from
    the dimension values is pushed into the fact scan, skipping whole row
    groups (ORC-style) and filtering rows.

The reducer's producer subplan is executed first by the DAG scheduler (it
becomes an upstream vertex), exactly like Hive/Tez ships bloom filters from
the dimension vertex to fact-table mappers.
"""
from __future__ import annotations

from typing import Optional, Tuple

from ..sql import ast as A
from . import plan as P
from .cost import CostModel


class SemijoinConfig:
    def __init__(self, enabled: bool = True, max_producer_rows: float = 500_000.0,
                 min_fact_ratio: float = 2.0):
        self.enabled = enabled
        self.max_producer_rows = max_producer_rows
        self.min_fact_ratio = min_fact_ratio


def insert_semijoin_reducers(
    plan: P.PlanNode, cost_model: CostModel, cfg: Optional[SemijoinConfig] = None
) -> int:
    """Mutates the plan, attaching RuntimeFilterSpecs; returns #reducers added."""
    cfg = cfg or SemijoinConfig()
    if not cfg.enabled:
        return 0
    added = 0

    for node in list(P.walk_plan(plan)):
        if not isinstance(node, P.Join) or node.kind not in ("inner", "semi"):
            continue
        for lk, rk, fact_side, dim_side in _both_orientations(node):
            dim_est = cost_model.estimate(dim_side)
            fact_est = cost_model.estimate(fact_side)
            if dim_est.rows > cfg.max_producer_rows:
                continue
            if fact_est.rows < dim_est.rows * cfg.min_fact_ratio:
                continue
            if not _is_selective(dim_side):
                continue
            hit = _resolve_to_scan(fact_side, lk)
            if hit is None:
                continue
            scan, raw_col = hit
            producer = _producer_plan(dim_side, rk)
            if producer is None:
                continue
            kind = (
                "partition"
                if raw_col in scan.table.partition_cols
                else "index"
            )
            spec = P.RuntimeFilterSpec(producer, rk, raw_col, kind)
            if any(r.key() == spec.key() for r in scan.runtime_filters):
                continue
            scan.runtime_filters.append(spec)
            added += 1
    return added


def _both_orientations(join: P.Join):
    for lk, rk in zip(join.left_keys, join.right_keys):
        yield lk, rk, join.left, join.right
        yield rk, lk, join.right, join.left


def _is_selective(node: P.PlanNode) -> bool:
    """The dimension side must actually be filtered for a reducer to help."""
    for n in P.walk_plan(node):
        if isinstance(n, P.Filter):
            return True
        if isinstance(n, P.Scan) and (n.pushed_filter or n.partition_filter):
            return True
        if isinstance(n, P.Aggregate):
            return True
    return False


def _resolve_to_scan(node: P.PlanNode, qualified: str) -> Optional[Tuple[P.Scan, str]]:
    """Trace a qualified column down to the Scan producing it."""
    if isinstance(node, P.Scan):
        alias_prefix = node.alias + "."
        if qualified.startswith(alias_prefix):
            raw = qualified[len(alias_prefix):]
            if raw in node.columns or raw in node.table.partition_cols:
                return node, raw
        return None
    if isinstance(node, P.Project):
        for e, n in node.exprs:
            if n == qualified:
                if isinstance(e, A.Col):
                    return _resolve_to_scan(node.input, e.qualified)
                return None
        return None
    if isinstance(node, P.Join):
        for side in node.inputs:
            if qualified in side.output_names():
                return _resolve_to_scan(side, qualified)
        return None
    if isinstance(node, (P.Filter, P.Sort, P.Limit)):
        return _resolve_to_scan(node.inputs[0], qualified)
    return None


def _producer_plan(dim_side: P.PlanNode, key: str) -> Optional[P.PlanNode]:
    if key not in dim_side.output_names():
        return None
    from ..sql.binder import _base, _qual

    proj = P.Project(dim_side, [(A.Col(_base(key), _qual(key)), key)])
    return P.Aggregate(proj, [key], [])  # distinct values only
