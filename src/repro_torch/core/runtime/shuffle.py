"""Partitioned shuffle service (paper §4/§5: MPP-style shuffle edges).

Tez fans a SHUFFLE edge out across executors: the producer hash-partitions
its output on the consumer's keys and every downstream task owns one
partition, so pipeline breakers (join build+probe, grouped aggregation,
DISTINCT state) scale with workers instead of running on one lane.  This
module is that layer for our DAG runtime:

  * :func:`expand_shuffle_partitions` — compile-time plan transform: every
    eligible pipeline-breaker consumer (shuffle hash join, grouped
    aggregation, global DISTINCT aggregate) is cloned once per partition;
    each clone reads one :class:`~repro_torch.core.optimizer.plan.ShuffleRead`
    lane of the shared producer subtree and the clones merge back through a
    UNION ALL (or a merging-fold Aggregate for global partials);
  * :class:`ShuffleWriter` — the producer side of a partitioned edge: a
    lane array of spill-aware :class:`Exchange` buffers, each with its own
    slice of the edge budget.  Every morsel is bucket-assigned by the
    ``hash_partition`` kernel (``engine: cuda|ref``; the numpy host path
    computes the identical hash bit-for-bit) and routed to its lane;
  * :func:`partition_select` — the barrier-mode equivalent (filter a
    materialized batch down to one partition).

Partition count comes from the ``shuffle.partitions`` session config
(``auto`` derives it from CBO row estimates); per-lane rows/bytes/spill are
surfaced through ``stats()['lanes']`` into ``poll()`` so skew is observable,
and every lane inherits the exchange cancel/spill semantics, keeping
kill latency bounded by one morsel.
"""
from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...kernels.registry import engine_device, host_call, resolve
from ..optimizer import plan as P
from ..sql import ast as A
from .exchange import Exchange, ExchangeConfig
from .exec import _FOLD_FN
from .vector import VectorBatch

# auto mode: one lane per this many estimated input rows, capped at the
# host's core count (lanes beyond the cores just pay routing overhead).
# Both thresholds are declared config keys (shuffle.auto_rows_per_partition
# / shuffle.auto_scan_fed_rows_per_partition) — the module constants are
# only the registry defaults' mirrors for callers without a config.
AUTO_ROWS_PER_PARTITION = 32_768
AUTO_MAX_PARTITIONS = 8


def auto_partition_cap() -> int:
    import os

    return max(2, min(AUTO_MAX_PARTITIONS, os.cpu_count() or 4))

# mirror of the kernel constants (repro_torch.kernels.hash_partition)
_FNV_PRIME = np.uint32(16777619)
_MIX1 = np.uint32(0x7FEB352D)
_MIX2 = np.uint32(0x846CA68B)


# ===========================================================================
# bucket assignment
# ===========================================================================
def _numeric_words(col: np.ndarray) -> np.ndarray:
    """Canonical uint32 hash word per value: the float32 bit pattern (with
    -0.0 normalized), so equal values agree across int/float sides and
    across the kernel and host paths."""
    v = col.astype(np.float32) + np.float32(0.0)
    return np.ascontiguousarray(v).view(np.uint32)


def _string_words(col: np.ndarray) -> np.ndarray:
    s = col.astype(str)
    uniq, inv = np.unique(s, return_inverse=True)
    words = np.fromiter((zlib.crc32(u.encode("utf-8")) for u in uniq),
                        dtype=np.uint32, count=len(uniq))
    return words[inv]


def _avalanche(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint32(16))
    h = h * _MIX1
    h = h ^ (h >> np.uint32(15))
    h = h * _MIX2
    return h ^ (h >> np.uint32(16))


def partition_codes(batch: VectorBatch, keys: Sequence[str],
                    num_partitions: int, engine: str = "auto") -> np.ndarray:
    """Bucket id in ``[0, num_partitions)`` per row of ``batch``.

    Under ``engine: cuda|ref`` all-numeric key sets dispatch through the
    ``hash_partition`` kernel on the engine's device; the numpy path
    computes the identical hash, so lanes agree even when one edge of a
    join is kernel-shaped and the other is not.  The keys become float32 on
    the host on both paths, so NaN (NULL) payloads agree too.
    """
    n = batch.num_rows
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    cols = [batch.cols[k] for k in keys]
    if engine != "auto" and all(c.dtype.kind in "iufb" for c in cols):
        fn = host_call(resolve("hash_partition", engine),
                       engine_device(engine))
        f32 = tuple(c.astype(np.float32) for c in cols)
        return fn(f32, int(num_partitions)).astype(np.int64)
    h = np.zeros(n, dtype=np.uint32)
    for c in cols:
        words = (_numeric_words(c) if c.dtype.kind in "iufb"
                 else _string_words(c))
        h = h * _FNV_PRIME ^ words
    h = _avalanche(h)
    return (h % np.uint32(num_partitions)).astype(np.int64)


def partition_select(batch: VectorBatch, keys: Sequence[str], partition: int,
                     num_partitions: int, engine: str = "auto") -> VectorBatch:
    """Rows of ``batch`` that belong to ``partition`` (barrier mode)."""
    if batch.num_rows == 0 or num_partitions <= 1:
        return batch
    codes = partition_codes(batch, keys, num_partitions, engine)
    return batch.select(codes == partition)


# ===========================================================================
# the producer side of a partitioned edge
# ===========================================================================
class ShuffleWriter:
    """Duck-types the scheduler's producer-side :class:`Exchange` surface
    (``put``/``close``/``stats``/``discard``/``retain``) over N per-partition
    lanes, hash-routing every morsel as it streams through.

    Routed rows are *coalesced* per lane up to ``batch_rows`` before they hit
    the lane exchange: naive routing would hand every consumer clone N×
    more, N×-smaller morsels, multiplying the per-morsel operator overhead
    that full-size morsels amortize."""

    def __init__(self, tag: str, cfg: ExchangeConfig, num_partitions: int,
                 keys: Sequence[str], engine: str = "auto",
                 batch_rows: int = 8192):
        self.tag = tag
        self.cfg = cfg
        self.num_partitions = int(num_partitions)
        self.keys = list(keys)
        self.engine = engine
        self.batch_rows = max(int(batch_rows), 1)
        # every lane owns a full edge budget (the Tez per-partition buffer
        # model): a hot lane under key skew spills on its own budget without
        # starving siblings, and per-lane spill counters expose exactly which
        # lane went hot
        self.lanes = [
            Exchange(f"{tag}.p{i}", cfg,
                     buffer_rows=cfg.buffer_rows,
                     buffer_bytes=cfg.buffer_bytes)
            for i in range(self.num_partitions)
        ]
        self._proto: Optional[VectorBatch] = None
        self._seen = [False] * self.num_partitions
        self._pending: List[List[VectorBatch]] = [
            [] for _ in range(self.num_partitions)
        ]
        self._pending_rows = [0] * self.num_partitions
        # adaptive execution: a lane split mid-stream by the hot-lane
        # mitigation routes its *remaining* rows round-robin over fresh
        # sub-lane exchanges (round-robin, not sub-hash: a single hot key
        # would land every row in one sub-hash bucket).  Splits happen on
        # the producer thread only (inside the put -> on_progress callback),
        # so routing state needs no lock; consumers address sub-lanes
        # through :meth:`sub_lane_reader` global indices.
        self._subs: List[Exchange] = []
        self._split: Dict[int, Tuple[int, int]] = {}  # lane -> (start, ways)
        self._rr: Dict[int, int] = {}
        self.on_progress = None  # callable(writer) | None, set by adaptive
        # declared edge schema — shared by every lane (and propagated to
        # adaptive sub-lane exchanges as they are created)
        self.schema = None

    def declare_schema(self, schema) -> None:
        self.schema = schema
        for lane in self.lanes:
            lane.declare_schema(schema)
        for ex in self._subs:
            ex.declare_schema(schema)

    # ------------------------------------------------------------ producer
    def put(self, batch: VectorBatch) -> None:
        if self._proto is None:
            self._proto = batch.slice(0, 0)
        if batch.num_rows == 0:
            return  # lanes get a schema-carrying empty morsel at close()
        codes = partition_codes(batch, self.keys, self.num_partitions,
                                self.engine)
        for p in range(self.num_partitions):
            part = batch.select(codes == p)
            if not part.num_rows:
                continue
            split = self._split.get(p)
            if split is not None:
                start, ways = split
                j = start + self._rr[p] % ways
                self._rr[p] += 1
                self._subs[j].put(part)
                continue
            self._pending[p].append(part)
            self._pending_rows[p] += part.num_rows
            if self._pending_rows[p] >= self.batch_rows:
                self._flush(p)
        if self.on_progress is not None:
            # adaptive telemetry hook: runs on the producer thread so a
            # split decision mutates routing state without a lock
            self.on_progress(self)

    def _flush(self, p: int) -> None:
        parts = self._pending[p]
        if not parts:
            return
        self._pending[p] = []
        self._pending_rows[p] = 0
        self.lanes[p].put(parts[0] if len(parts) == 1
                          else VectorBatch.concat(parts))
        self._seen[p] = True

    def split_lane(self, p: int, ways: int) -> List[int]:
        """Split lane ``p``'s *remaining* stream across ``ways`` fresh
        sub-lane exchanges (hot-lane skew mitigation).

        Producer-thread only.  The already-buffered prefix stays in lane
        ``p`` (its exchange closes now, bounding the original consumer),
        and every subsequent routed morsel round-robins over the sub-lanes.
        Returns the global sub-lane indices for :meth:`sub_lane_reader`."""
        assert p not in self._split and 0 <= p < self.num_partitions
        ways = max(int(ways), 2)
        self._flush(p)
        if not self._seen[p] and self._proto is not None:
            self.lanes[p].put(self._proto)
            self._seen[p] = True
        self.lanes[p].close()
        start = len(self._subs)
        for j in range(ways):
            ex = Exchange(f"{self.tag}.p{p}.s{j}", self.cfg,
                          buffer_rows=self.cfg.buffer_rows,
                          buffer_bytes=self.cfg.buffer_bytes)
            ex.retain = False  # exactly one adaptive consumer per sub-lane
            ex.declare_schema(self.schema)
            self._subs.append(ex)
        self._split[p] = (start, ways)
        self._rr[p] = 0
        return list(range(start, start + ways))

    def close(self, error: Optional[BaseException] = None) -> None:
        if error is None:
            for p in range(self.num_partitions):
                if p not in self._split:
                    self._flush(p)
            if self._proto is not None:
                # operators downstream rely on at least one (possibly empty)
                # schema-carrying morsel per stream
                for p, seen in enumerate(self._seen):
                    if not seen:
                        self.lanes[p].put(self._proto)
                for ex in self._subs:
                    if ex.total_rows == 0:
                        ex.put(self._proto)
        for lane in self.lanes:
            lane.close(error=error)
        for ex in self._subs:
            ex.close(error=error)

    # ------------------------------------------------------------ consumers
    def lane_reader(self, partition: int):
        return self.lanes[partition].reader()

    def sub_lane_reader(self, idx: int):
        """Reader over one adaptive sub-lane created by :meth:`split_lane`."""
        return self._subs[idx].reader()

    def reader(self):
        """Full-stream replay (lane by lane) for an unpartitioned consumer
        sharing this producer (shared-work reuse); row order across lanes is
        not the producer order, which UNION ALL semantics tolerate."""
        for lane in self.lanes:
            yield from lane.reader()

    def read_all(self) -> VectorBatch:
        chunks = [b for lane in self.lanes for b in lane.reader()]
        return VectorBatch.concat(chunks) if chunks else VectorBatch({})

    # ------------------------------------------------------------ lifecycle
    @property
    def retain(self) -> bool:
        return any(lane.retain for lane in self.lanes)

    @retain.setter
    def retain(self, value: bool) -> None:
        for lane in self.lanes:
            lane.retain = value

    def configure_retention(self, lane_readers: List[int],
                            full_readers: int) -> None:
        """Single-reader lanes free chunks as consumed, like single-consumer
        FORWARD edges; a full-stream reader forces retention everywhere."""
        for p, lane in enumerate(self.lanes):
            lane.retain = full_readers > 0 or lane_readers[p] != 1

    def lane_rows(self) -> List[int]:
        """Live per-lane routed row counts (pending + exchanged), including
        sub-lane rows credited to their parent lane — the adaptive layer's
        skew signal."""
        rows = [lane.total_rows + self._pending_rows[p]
                for p, lane in enumerate(self.lanes)]
        for p, (start, ways) in list(self._split.items()):
            rows[p] += sum(self._subs[j].total_rows
                           for j in range(start, start + ways))
        return rows

    def stats(self) -> Dict[str, object]:
        per_lane = [lane.stats() for lane in self.lanes]
        per_sub = [ex.stats() for ex in list(self._subs)]
        agg = {
            "rows": sum(s["rows"] for s in per_lane + per_sub),
            "spilled_rows": sum(s["spilled_rows"] for s in per_lane + per_sub),
            "spilled_bytes": sum(s["spilled_bytes"]
                                 for s in per_lane + per_sub),
            "spilled_chunks": sum(s["spilled_chunks"]
                                  for s in per_lane + per_sub),
            "peak_buffered_rows": sum(s["peak_buffered_rows"]
                                      for s in per_lane + per_sub),
            "freed_chunks": sum(s["freed_chunks"] for s in per_lane + per_sub),
        }
        agg["lanes"] = [
            {"rows": s["rows"], "spilled_rows": s["spilled_rows"],
             "spilled_bytes": s["spilled_bytes"]}
            for s in per_lane
        ]
        if self._split:
            agg["splits"] = {p: ways
                             for p, (_, ways) in sorted(self._split.items())}
        return agg

    def discard(self) -> None:
        for lane in self.lanes:
            lane.discard()
        for ex in list(self._subs):
            ex.discard()


# ===========================================================================
# compile-time partition expansion
# ===========================================================================
# how a per-partition partial folds in the global merging Aggregate — the
# executor's incremental-merge map (COUNT partials re-combine with SUM)
_MERGE_FOLD = _FOLD_FN


# lane-payoff threshold for *scan-fed* consumers (BENCH_PR5 regression
# fix): when the consumer's input is a pure scan pipeline, the single-lane
# plan fuses the scan straight into the consumer vertex with no exchange at
# all — fanning out then ADDS a routing hop, which only pays off once the
# per-lane share of work is much larger than for consumers that already sit
# behind a SHUFFLE edge
AUTO_SCAN_FED_ROWS_PER_PARTITION = 262_144


def resolve_partition_count(cfg_value, est_rows: Optional[float],
                            rows_per_partition: int = AUTO_ROWS_PER_PARTITION
                            ) -> int:
    """``shuffle.partitions``: an int, or ``auto`` (CBO-derived)."""
    if cfg_value in (None, "", 0, 1, "1"):
        return 1
    if cfg_value == "auto":
        if not est_rows or est_rows <= rows_per_partition:
            return 1
        n = int(-(-est_rows // rows_per_partition))  # ceil
        return max(1, min(n, auto_partition_cap()))
    return max(int(cfg_value), 1)


def _scan_fed(node: P.PlanNode) -> bool:
    """True when ``node``'s subtree is a pure scan pipeline (no pipeline
    breaker below), i.e. a single-lane plan would fuse it into the consumer
    vertex without any exchange."""
    breakers = (P.Join, P.Aggregate, P.Sort, P.Union, P.WindowOp,
                P.FederatedScan, P.ShuffleRead)
    return not any(isinstance(n, breakers) for n in P.walk_plan(node))


def _expandable_join(node: P.PlanNode) -> bool:
    return (isinstance(node, P.Join) and node.strategy == "shuffle"
            and node.kind in ("inner", "left", "full", "semi", "anti")
            and bool(node.left_keys))


def _distinct_partition_col(node: P.Aggregate) -> Optional[str]:
    """For a *global* aggregate with DISTINCT specs: the single column every
    DISTINCT argument references (the partitioning key), or None."""
    col = None
    for s in node.aggs:
        if not s.distinct:
            continue
        if not isinstance(s.arg, A.Col):
            return None
        if col is not None and s.arg.qualified != col:
            return None
        col = s.arg.qualified
    return col


def _copartition_lanes(agg: P.Aggregate,
                       union: P.PlanNode) -> Optional[List[P.PlanNode]]:
    """Lane-join list when ``agg`` can reuse ``union``'s shuffle lanes.

    ``union`` is the already-expanded lane Union of a shuffle join.  When
    the aggregate's group keys cover the join's shuffle keys on a side
    whose rows survive the join intact, every group lives wholly inside
    one lane (same shuffle-key values -> same hash -> same lane, including
    null-extended outer rows), so the aggregate can run per-lane on the
    join's lanes and elide its own shuffle hop entirely."""
    if not (isinstance(union, P.Union) and union.all
            and len(union.inputs) >= 2):
        return None
    lanes = union.inputs
    gk = set(agg.group_keys)
    for i, j in enumerate(lanes):
        if not (isinstance(j, P.Join) and j.strategy == "shuffle"
                and isinstance(j.left, P.ShuffleRead)
                and isinstance(j.right, P.ShuffleRead)
                and j.left.partition == i
                and j.left.num_partitions == len(lanes)
                and j.right.partition == i
                and j.right.num_partitions == len(lanes)):
            return None
        # coverage must come from a side whose key columns reach the join
        # output unmodified: the left side for every supported kind (outer
        # rows keep their left keys), the right side only for inner joins
        left_cover = (set(j.left_keys) <= gk
                      and j.kind in ("inner", "left", "semi", "anti"))
        right_cover = set(j.right_keys) <= gk and j.kind == "inner"
        if not (left_cover or right_cover):
            return None
    return list(lanes)


def expand_shuffle_partitions(plan: P.PlanNode, config: dict,
                              cost_model=None,
                              events: Optional[list] = None) -> P.PlanNode:
    """Clone pipeline-breaker consumers per partition (compile time).

    Runs after federated split expansion and after shared-work detection —
    clone keys embed their ``ShuffleRead`` lane, so clones are never
    mistaken for shared subplans.  Runtime-filter producer subtrees are left
    untouched (they execute inline inside scan vertices).

    Compile-time adaptive decisions (co-partition shuffle elision) are
    appended to ``events`` so they surface in ``poll()["adaptive"]`` and
    EXPLAIN ANALYZE alongside the runtime ones.
    """
    cfg_value = config.get("shuffle.partitions", 1)
    if cfg_value in (None, "", 0, 1, "1"):
        return plan
    auto_rows = int(config.get("shuffle.auto_rows_per_partition",
                               AUTO_ROWS_PER_PARTITION))
    auto_scan_fed = int(config.get("shuffle.auto_scan_fed_rows_per_partition",
                                   AUTO_SCAN_FED_ROWS_PER_PARTITION))
    elide = bool(config.get("adaptive.elide_copartition", True))
    replaced: Dict[int, P.PlanNode] = {}
    visited: set = set()

    def partitions_for(node: P.PlanNode) -> Tuple[int, Optional[float]]:
        """(lane count, CBO row estimate the count was derived from)."""
        if cfg_value != "auto":
            return resolve_partition_count(cfg_value, None), None
        if cost_model is None:
            return 1, None
        try:
            if isinstance(node, P.Join):
                rows = max(cost_model.estimate(node.left).rows,
                           cost_model.estimate(node.right).rows)
            else:
                rows = cost_model.estimate(node.inputs[0]).rows
        except Exception:  # noqa: BLE001 - estimation must never break compile
            return 1, None
        # scan-fed consumers (aggregate/DISTINCT straight over a scan) pay
        # for an exchange hop the single-lane plan doesn't have: demand a
        # much larger per-lane share before fanning out (the BENCH_PR5
        # partitioned-DISTINCT regression)
        per_lane = auto_rows
        if not isinstance(node, P.Join) and _scan_fed(node.inputs[0]):
            per_lane = auto_scan_fed
        return resolve_partition_count("auto", rows,
                                       rows_per_partition=per_lane), rows

    def expand(node: P.PlanNode) -> Optional[P.PlanNode]:
        if isinstance(node, P.Join) and _expandable_join(node):
            n, rows = partitions_for(node)
            if n <= 1:
                return None
            left, right = node.left, node.right
            clones: List[P.PlanNode] = []
            for p in range(n):
                clones.append(P.Join(
                    P.ShuffleRead(left, node.left_keys, p, n,
                                  est_rows=rows),
                    P.ShuffleRead(right, node.right_keys, p, n,
                                  est_rows=rows),
                    node.kind, list(node.left_keys), list(node.right_keys),
                    residual=node.residual, strategy="shuffle",
                ))
            return P.Union(clones, all=True)
        if isinstance(node, P.Aggregate) and node.grouping_sets is None:
            source = node.input
            if node.group_keys:
                if elide:
                    # co-partition elision: the input was already expanded
                    # (post-order visit) — if it is the lane Union of a
                    # shuffle join whose keys the group keys cover, reuse
                    # those lanes and skip this aggregate's own shuffle hop.
                    # A pruning Project between the aggregate and the join
                    # is pushed into each lane (column projection is
                    # per-row, so it commutes with the lane partition).
                    inner, wrap = source, None
                    if isinstance(inner, P.Project) and all(
                            isinstance(e, A.Col) and e.qualified == name
                            for e, name in inner.exprs):
                        # identity pruning only: a renaming projection would
                        # break the key-name coverage check below
                        inner, wrap = inner.input, inner
                    lanes = _copartition_lanes(node, inner)
                    if lanes is not None:
                        if events is not None:
                            events.append({
                                "kind": "elided_shuffle",
                                "at": "compile",
                                "lanes": len(lanes),
                                "group_keys": list(node.group_keys),
                                "join_keys": list(lanes[0].left_keys),
                            })
                        if wrap is not None:
                            lanes = [P.Project(lane, list(wrap.exprs))
                                     for lane in lanes]
                        return P.Union(
                            [P.Aggregate(lane, list(node.group_keys),
                                         list(node.aggs))
                             for lane in lanes],
                            all=True)
                # groups are disjoint across lanes: UNION ALL merges exactly
                n, rows = partitions_for(node)
                if n <= 1:
                    return None
                clones = [
                    P.Aggregate(
                        P.ShuffleRead(source, node.group_keys, p, n,
                                      est_rows=rows),
                        list(node.group_keys), list(node.aggs))
                    for p in range(n)
                ]
                return P.Union(clones, all=True)
            dcol = _distinct_partition_col(node)
            if dcol is not None and all(s.fn in _MERGE_FOLD
                                        for s in node.aggs):
                # global DISTINCT: partition on the DISTINCT argument so each
                # lane owns a disjoint value range; per-lane partials fold in
                # a global merging Aggregate (COUNT partials re-SUM)
                n, rows = partitions_for(node)
                if n <= 1:
                    return None
                clones = [
                    P.Aggregate(P.ShuffleRead(source, [dcol], p, n,
                                              est_rows=rows),
                                [], list(node.aggs))
                    for p in range(n)
                ]
                folds = [
                    P.AggSpec(_MERGE_FOLD[s.fn], A.Col(s.out_name), False,
                              s.out_name)
                    for s in node.aggs
                ]
                return P.Aggregate(P.Union(clones, all=True), [], folds)
        return None

    def visit(node: P.PlanNode) -> P.PlanNode:
        if id(node) in replaced:
            return replaced[id(node)]
        if id(node) in visited:
            return node
        visited.add(id(node))
        node.inputs = [visit(c) for c in node.inputs]
        new = expand(node)
        if new is not None:
            replaced[id(node)] = new
            return new
        return node

    return visit(plan)
