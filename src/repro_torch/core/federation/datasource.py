"""Capability-negotiated DataSource scan/write contract (paper §6, redesigned).

The old federation surface was all-or-nothing: the optimizer handed a whole
plan prefix to ``StorageHandler.try_pushdown`` and either the handler
absorbed everything or nothing, and ``read()`` materialized the external
table into one batch.  This module replaces that with a *negotiation*:

  * the optimizer builds a :class:`ScanBuilder` for each federated scan and
    offers work piecewise — ``push_filters(conjuncts)`` returns the
    *residual* conjuncts the connector cannot evaluate (kept as a local
    Filter), ``push_projection(cols)`` narrows the remote read,
    ``push_aggregate(...)`` may be absorbed fully, *partially* (the
    connector returns per-split partial aggregates and the local Aggregate
    is rewritten into a merging fold), or not at all, and
    ``push_limit(n, sort)`` likewise supports per-split top-n with a local
    merge;
  * the negotiated state is recorded as a plain-data :class:`ScanSpec` on
    the plan's ``FederatedScan`` node (deep-copyable, plan-cache safe);
    execution rebuilds the builder and replays the spec;
  * ``ScanBuilder.to_splits()`` enumerates parallel work units whose
    readers are *generators* yielding ``VectorBatch`` morsels, so external
    reads stream through the exchange layer like native scans;
  * writes go through :class:`Writer` (``write_batch``/``commit``) instead
    of a one-shot ``write``.

``EXPLAIN`` shows the outcome: the ``FederatedScan`` node describes what was
pushed, and whatever the connector declined remains visible as ordinary
Filter/Project/Aggregate/Sort/Limit nodes above it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..optimizer import plan as P
from ..sql import ast as A
from ..sql.binder import conjoin, split_conjuncts
from ..runtime.vector import VectorBatch

# how a pushed-down partial aggregate folds in the local merging Aggregate
FOLD_FN = {"sum": "sum", "count": "sum", "min": "min", "max": "max"}

# pushdown outcome for aggregates and limits
NONE, PARTIAL, FULL = "none", "partial", "full"


# ===========================================================================
# the negotiated scan description (plain data; lives on the plan node)
# ===========================================================================
@dataclasses.dataclass
class AggPush:
    """A pushed aggregation, in the connector's raw column terms."""

    group_keys: List[str]                      # raw column names
    aggs: List[Tuple[str, Optional[str], str]]  # (fn, raw_arg|None, out_name)
    mode: str = FULL                           # 'partial' | 'full'

    def key(self) -> str:
        a = ",".join(f"{fn}({arg or '*'})->{out}" for fn, arg, out in self.aggs)
        return f"agg[{','.join(self.group_keys)}|{a}|{self.mode}]"


@dataclasses.dataclass
class ScanSpec:
    """Everything the connector agreed to take, in raw-column terms."""

    filters: List[A.Expr] = dataclasses.field(default_factory=list)
    projection: Optional[List[str]] = None      # raw columns (None = all)
    agg: Optional[AggPush] = None
    limit: Optional[int] = None
    limit_mode: str = NONE                      # 'partial' | 'full' when set
    sort: List[Tuple[int, bool]] = dataclasses.field(default_factory=list)
    # ``sort`` keys are positions into the scan's output columns

    def key(self) -> str:
        parts = []
        if self.filters:
            parts.append("f[" + ",".join(c.key() for c in self.filters) + "]")
        if self.projection is not None:
            parts.append("p[" + ",".join(self.projection) + "]")
        if self.agg is not None:
            parts.append(self.agg.key())
        if self.limit is not None:
            parts.append(f"l[{self.limit}|{self.limit_mode}|{self.sort}]")
        return ";".join(parts)

    def summary(self) -> Dict[str, object]:
        out: Dict[str, object] = {}
        if self.filters:
            out["filters"] = len(self.filters)
        if self.projection is not None:
            out["projection"] = list(self.projection)
        if self.agg is not None:
            out["aggregate"] = self.agg.mode
        if self.limit is not None:
            out["limit"] = self.limit_mode
        return out


# ===========================================================================
# the connector-side contract
# ===========================================================================
class ScanBuilder:
    """Per-scan negotiation + split enumeration for one external table.

    Negotiation methods mutate ``self.spec`` when (part of) the offer is
    accepted; each returns what the optimizer must keep locally.  The base
    class declines everything, so a minimal connector only implements
    ``read_split`` (and optionally ``to_splits``).
    """

    def __init__(self, handler, table, config: Optional[dict] = None):
        self.handler = handler
        self.table = table
        self.config = config or {}
        self.spec = ScanSpec()

    # ---- negotiation ------------------------------------------------------
    def push_filters(self, conjuncts: List[A.Expr]) -> List[A.Expr]:
        """Offer raw-column filter conjuncts; return the residuals."""
        return list(conjuncts)

    def push_projection(self, columns: List[str]) -> bool:
        return False

    def push_aggregate(self, group_keys: List[str],
                       aggs: List[Tuple[str, Optional[str], str]]) -> str:
        return NONE

    def push_limit(self, n: int, sort: List[Tuple[int, bool]]) -> str:
        return NONE

    # ---- statistics -------------------------------------------------------
    def estimate_stats(self) -> Optional["RemoteTableStats"]:
        """Remote row-count/NDV estimates for the CBO; None = unknown."""
        return None

    # ---- execution --------------------------------------------------------
    def output_columns(self) -> List[str]:
        """Raw names of the columns each read batch carries, in order."""
        if self.spec.agg is not None:
            return list(self.spec.agg.group_keys) + [
                out for _, _, out in self.spec.agg.aggs
            ]
        if self.spec.projection is not None:
            return list(self.spec.projection)
        return [c for c, _ in self.table.schema]

    def to_splits(self) -> List[object]:
        """Parallel work units; default: one whole-table split."""
        return [None]

    def read_split(self, split) -> Iterator[VectorBatch]:
        raise NotImplementedError

    def empty_batch(self) -> VectorBatch:
        """Schema-carrying empty batch in ``output_columns`` order."""
        from ..acid import _np_dtype

        dtypes = dict(self.table.schema)
        cols = {}
        for c in self.output_columns():
            ty = dtypes.get(c)
            cols[c] = np.empty(0, dtype=_np_dtype(ty) if ty else np.float64)
        return VectorBatch(cols)


def apply_spec(builder: ScanBuilder, spec: Optional[ScanSpec]) -> None:
    """Replay a negotiated spec onto a fresh builder (compile/exec time)."""
    if spec is None:
        return
    if spec.filters:
        residual = builder.push_filters(list(spec.filters))
        if residual:
            raise RuntimeError(
                f"connector {builder.handler.name} no longer accepts a "
                f"previously negotiated filter: {[c.key() for c in residual]}"
            )
    if spec.projection is not None:
        builder.push_projection(list(spec.projection))
    if spec.agg is not None:
        mode = builder.push_aggregate(list(spec.agg.group_keys),
                                      list(spec.agg.aggs))
        if mode == NONE:
            raise RuntimeError(
                f"connector {builder.handler.name} no longer accepts a "
                f"previously negotiated aggregate pushdown"
            )
        # the plan's shape (local merging Aggregate present or not) was
        # fixed at negotiation time; replay honors it — connectors consult
        # spec.agg.mode when enumerating splits, so a FULL plan reads one
        # global split even if the remote side gained parallelism since
        builder.spec.agg.mode = spec.agg.mode
    if spec.limit is not None:
        builder.push_limit(spec.limit, list(spec.sort))
        builder.spec.limit = spec.limit
        builder.spec.sort = list(spec.sort)
        builder.spec.limit_mode = spec.limit_mode


@dataclasses.dataclass
class RemoteColumnStats:
    """Connector-estimated per-column statistics (CostModel-compatible)."""

    ndv: int = 0
    min_value: Optional[object] = None
    max_value: Optional[object] = None


@dataclasses.dataclass
class RemoteTableStats:
    """Connector-estimated table statistics: the shape
    :class:`~repro_torch.core.optimizer.cost.CostModel` reads (``row_count`` +
    per-column ``ndv``/``min_value``/``max_value``), so federated join
    order, broadcast choices, and ``shuffle.partitions: auto`` are costed
    on remote estimates instead of the empty-stats default."""

    row_count: float = 0.0
    columns: Dict[str, RemoteColumnStats] = dataclasses.field(
        default_factory=dict)


def stats_from_batch(batch: VectorBatch,
                     sample_rows: int = 1 << 17) -> RemoteTableStats:
    """Estimate RemoteTableStats from an in-memory batch (shared by the
    embedded connectors): NDV from a bounded sample, min/max for numerics."""
    n = batch.num_rows
    out = RemoteTableStats(row_count=float(n))
    for name, col in batch.cols.items():
        sample = col[:sample_rows]
        ndv = int(len(np.unique(sample)))
        if len(sample) < n and ndv == len(sample):
            ndv = n  # looks unique in the sample: assume a key column
        cs = RemoteColumnStats(ndv=ndv)
        if col.dtype.kind in "iuf" and n:
            cs.min_value = col.min().item()
            cs.max_value = col.max().item()
        out.columns[name] = cs
    return out


class Writer:
    """Batched write channel to an external system (replaces one-shot
    ``StorageHandler.write``): stream morsels in, make them visible on
    ``commit``."""

    def write_batch(self, batch: VectorBatch) -> None:
        raise NotImplementedError

    def commit(self) -> None:
        raise NotImplementedError

    def abort(self) -> None:  # pragma: no cover - connectors may override
        pass


# ===========================================================================
# optimizer-side negotiation
# ===========================================================================
def _to_raw(e: A.Expr, alias: str, proj_defs: Dict[str, A.Expr]) -> Optional[A.Expr]:
    """Rewrite a bound expr over the scan's qualified columns into raw
    column names; None when it references anything else.

    A column defined by a *computed* projection expression (the binder's
    synthetic ``aa_N``/``gk_N`` names) is NOT a remote column — it must
    resolve to None so the aggregate/filter stays local instead of pushing
    a nonexistent column name to the connector.
    """
    if isinstance(e, A.Col):
        q = e.qualified
        d = proj_defs.get(q)
        if d is not None and d.key() != e.key():
            if isinstance(d, A.Col):
                return _to_raw(d, alias, proj_defs)
            return None  # computed projection output, not a remote column
        if q.startswith(alias + "."):
            return A.Col(q[len(alias) + 1:])
        return None
    if isinstance(e, A.SubqueryExpr):
        return None
    kids = [_to_raw(c, alias, proj_defs) for c in e.children()]
    if any(k is None for k in kids):
        return None
    from ..sql.binder import _rebuild

    return _rebuild(e, kids)


@dataclasses.dataclass
class _Chain:
    """The single-input plan prefix above one FederatedScan, top-down."""

    limit: Optional[P.Limit] = None
    sort: Optional[P.Sort] = None
    rename: Optional[P.Project] = None   # pure-Col rename above the aggregate
    agg: Optional[P.Aggregate] = None
    proj: Optional[P.Project] = None
    filter: Optional[P.Filter] = None
    scan: Optional[P.FederatedScan] = None


def _match_chain(node: P.PlanNode) -> Optional[_Chain]:
    c = _Chain()
    if isinstance(node, P.Limit):
        c.limit = node
        node = node.input
    if isinstance(node, P.Sort):
        c.sort = node
        node = node.input
    if isinstance(node, P.Project) and all(
        isinstance(e, A.Col) for e, _ in node.exprs
    ) and isinstance(node.input, P.Aggregate):
        c.rename = node
        node = node.input
    if isinstance(node, P.Aggregate):
        c.agg = node
        node = node.input
    if isinstance(node, P.Project):
        c.proj = node
        node = node.input
    if isinstance(node, P.Filter):
        c.filter = node
        node = node.input
    if not isinstance(node, P.FederatedScan) or node.spec is not None:
        return None
    c.scan = node
    return c


def negotiate_federated(plan: P.PlanNode, resolve_handler: Callable,
                        config: dict) -> Tuple[P.PlanNode, Dict[str, dict]]:
    """Negotiate pushdown for every federated scan in ``plan``.

    Returns ``(new_plan, summary)`` where ``summary`` maps table name to a
    pushed-vs-residual report (surfaced as ``info['federated_pushdown']``
    and visible in EXPLAIN through the rewritten plan itself).
    """
    out: Dict[str, dict] = {}

    def try_at(node: P.PlanNode, parent: Optional[P.PlanNode],
               idx: int) -> None:
        chain = _match_chain(node)
        if chain is not None:
            handler = resolve_handler(chain.scan.table.handler)
            if handler is not None:
                new_top, summary = _negotiate_chain(chain, handler, config)
                out[chain.scan.table.name] = summary
                if parent is None:
                    nonlocal plan
                    plan = new_top
                else:
                    parent.inputs[idx] = new_top
                return
        for i, child in enumerate(node.inputs):
            try_at(child, node, i)

    try_at(plan, None, 0)
    return plan, out


def _negotiate_chain(c: _Chain, handler, config: dict) -> Tuple[P.PlanNode, dict]:
    scan = c.scan
    alias = scan.alias
    proj_defs: Dict[str, A.Expr] = (
        {n: e for e, n in c.proj.exprs} if c.proj is not None else {}
    )
    builder = handler.scan_builder(scan.table, config)

    # ---- filters: partial pushdown, untranslatable/declined stay local ----
    pushed_filters: List[A.Expr] = []
    residual_filters: List[A.Expr] = []
    if c.filter is not None:
        conjuncts = split_conjuncts(c.filter.predicate)
        if config.get("federation.push_filters", True):
            offer, originals = [], []
            for conj in conjuncts:
                raw = _to_raw(conj, alias, proj_defs)
                if raw is None:
                    residual_filters.append(conj)
                else:
                    offer.append(raw)
                    originals.append(conj)
            declined = builder.push_filters(offer) if offer else []
            declined_keys = {d.key() for d in declined}
            for raw, orig in zip(offer, originals):
                if raw.key() in declined_keys:
                    residual_filters.append(orig)
                else:
                    pushed_filters.append(raw)
        else:
            residual_filters = list(conjuncts)

    # ---- aggregate: full / partial / none ---------------------------------
    agg_mode = NONE
    if (
        c.agg is not None
        and not c.agg.grouping_sets
        and not residual_filters
        and config.get("federation.push_aggregate", True)
        and all(s.fn in FOLD_FN and not s.distinct for s in c.agg.aggs)
    ):
        raw_keys, raw_aggs, ok = [], [], True
        for k in c.agg.group_keys:
            raw = _to_raw(A.Col(_base(k), _qual(k)), alias, proj_defs)
            if not isinstance(raw, A.Col):
                ok = False
                break
            raw_keys.append(raw.name)
        if ok:
            for s in c.agg.aggs:
                if s.arg is None:
                    raw_aggs.append((s.fn, None, s.out_name))
                    continue
                raw = _to_raw(s.arg, alias, proj_defs)
                if not isinstance(raw, A.Col):
                    ok = False
                    break
                raw_aggs.append((s.fn, raw.name, s.out_name))
        if ok:
            agg_mode = builder.push_aggregate(raw_keys, raw_aggs)

    # ---- projection (when the aggregate stays local) ----------------------
    projection_pushed = False
    if agg_mode == NONE and config.get("federation.push_projection", True):
        needed: List[str] = []
        seen = set()

        def need(e: Optional[A.Expr]):
            if e is None:
                return
            raw = _to_raw(e, alias, {})
            for col in (A.walk(raw) if raw is not None else ()):
                if isinstance(col, A.Col) and col.name not in seen:
                    seen.add(col.name)
                    needed.append(col.name)

        consumers: List[A.Expr] = []
        if c.proj is not None:
            consumers.extend(e for e, _ in c.proj.exprs)
        if c.agg is not None:
            consumers.extend(A.Col(_base(k), _qual(k)) for k in c.agg.group_keys)
            consumers.extend(s.arg for s in c.agg.aggs if s.arg is not None)
        if c.proj is None and c.agg is None:
            consumers.extend(
                A.Col(_base(n), _qual(n)) for n in scan.output_names())
        for e in consumers:
            need(e)
        for e in residual_filters:
            need(e)
        table_cols = [col for col, _ in scan.table.schema]
        if (needed and all(n in table_cols for n in needed)
                and set(needed) != set(table_cols)):
            projection_pushed = builder.push_projection(needed)

    # ---- scan output naming ----------------------------------------------
    if agg_mode in (PARTIAL, FULL):
        output_cols = c.agg.output_names()
    elif projection_pushed:
        output_cols = [f"{alias}.{n}" for n in builder.output_columns()]
    else:
        output_cols = [f"{alias}.{col}" for col, _ in scan.table.schema]

    # ---- sort + limit -----------------------------------------------------
    # LIMIT commutes through row-wise Projects, so it is pushable whenever
    # the filter was fully absorbed and the aggregate (if any) was absorbed
    # FULL; a sort must additionally translate its keys down to scan-output
    # positions (through the rename/projection definitions), else both stay.
    limit_mode = NONE
    absorbed_below = not residual_filters and (c.agg is None or agg_mode == FULL)
    if (
        c.limit is not None and absorbed_below
        and config.get("federation.push_limit", True)
    ):
        sort_pos: Optional[List[Tuple[int, bool]]] = []
        if c.sort is not None:
            for key, desc in c.sort.keys:
                pos = _sort_position(key, c, output_cols)
                if pos is None:
                    sort_pos = None
                    break
                sort_pos.append((pos, desc))
        if sort_pos is not None:
            limit_mode = builder.push_limit(int(c.limit.n), sort_pos)

    # ---- rebuild the local chain over the negotiated scan -----------------
    new_scan = P.FederatedScan(
        scan.table, alias, scan.columns,
        spec=builder.spec, output_cols=output_cols,
    )
    sub: P.PlanNode = new_scan
    if residual_filters:
        c.filter.inputs = [sub]
        c.filter.predicate = conjoin(residual_filters)
        sub = c.filter
    if agg_mode == NONE and c.proj is not None:
        c.proj.inputs = [sub]
        sub = c.proj
    if agg_mode in (NONE, PARTIAL) and c.agg is not None:
        if agg_mode == PARTIAL:
            # the connector returns per-split partials; the local aggregate
            # becomes the merging fold (COUNT partials re-combine with SUM)
            c.agg.aggs = [
                P.AggSpec(FOLD_FN[s.fn], A.Col(s.out_name), False, s.out_name)
                for s in c.agg.aggs
            ]
        c.agg.inputs = [sub]
        sub = c.agg
    if c.rename is not None:
        c.rename.inputs = [sub]
        sub = c.rename
    if c.sort is not None and limit_mode != FULL:
        c.sort.inputs = [sub]
        sub = c.sort
    if c.limit is not None and limit_mode != FULL:
        c.limit.inputs = [sub]
        sub = c.limit

    summary = {
        "pushed": builder.spec.summary(),
        "residual": {
            k: v for k, v in {
                "filters": len(residual_filters),
                "aggregate": (
                    "merge" if agg_mode == PARTIAL
                    else "local" if (c.agg is not None and agg_mode == NONE)
                    else None),
                "limit": ("merge" if (c.limit is not None
                                      and limit_mode == PARTIAL)
                          else "local" if (c.limit is not None
                                           and limit_mode == NONE)
                          else None),
            }.items() if v
        },
    }
    return sub, summary


# ===========================================================================
# split expansion (compile time, after plan-cache deepcopy)
# ===========================================================================
def expand_federated_splits(plan: P.PlanNode, resolve_handler: Callable,
                            config: dict) -> P.PlanNode:
    """Fan each federated scan out over its connector's splits.

    A multi-split scan becomes ``UNION ALL`` of per-split scans; the DAG
    compiler turns every ``FederatedScan`` into its own vertex, so splits
    execute in parallel and stream through the exchange layer.
    """

    def visit(node: P.PlanNode, parent: Optional[P.PlanNode], idx: int):
        for i, child in enumerate(list(node.inputs)):
            visit(child, node, i)
        if not isinstance(node, P.FederatedScan) or node.split is not None:
            return
        handler = resolve_handler(node.table.handler)
        if handler is None:
            return
        builder = handler.scan_builder(node.table, config)
        apply_spec(builder, node.spec)
        splits = builder.to_splits() or [None]
        if len(splits) <= 1:
            node.split = splits[0]
            node.total_splits = 1
            return
        parts = [
            P.FederatedScan(node.table, node.alias, node.columns,
                            spec=node.spec, output_cols=node._output_cols,
                            split=s, total_splits=len(splits))
            for s in splits
        ]
        union = P.Union(parts, all=True)
        if parent is None:
            nonlocal plan
            plan = union
        else:
            parent.inputs[idx] = union

    visit(plan, None, 0)
    return plan


def _sort_position(key: str, c: _Chain,
                   output_cols: List[str]) -> Optional[int]:
    """Map a sort key (an output name of the node below the Sort) to a
    position in the scan's output columns, chasing pure-Col definitions
    through the rename/projection nodes kept locally."""
    if key in output_cols:
        return output_cols.index(key)
    for prj in (c.rename, c.proj):
        if prj is None:
            continue
        defs = {n: e for e, n in prj.exprs}
        e = defs.get(key)
        if isinstance(e, A.Col) and e.qualified in output_cols:
            return output_cols.index(e.qualified)
    return None


def _base(qualified: str) -> str:
    return qualified.split(".", 1)[1] if "." in qualified else qualified


def _qual(qualified: str) -> Optional[str]:
    return qualified.split(".", 1)[0] if "." in qualified else None
