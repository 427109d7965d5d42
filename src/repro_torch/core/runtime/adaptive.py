"""Adaptive query execution: live-telemetry replanning (paper §4.2).

Static plans commit to a lane fan-out, a partitioning, and a vertex
placement before the first row is read; this module re-plans a *running*
pipelined DAG from the shuffle service's live telemetry:

  * **hot-lane split** — a shuffle lane whose observed rows exceed
    ``adaptive.skew_ratio`` over the lane median gets its *remaining*
    stream re-partitioned round-robin across fresh sub-lanes, each drained
    by a cloned consumer; the merge vertex is rebound with a merging-fold
    Aggregate so partials for the same group re-combine exactly;
  * **payoff-gated fan-out collapse** — per-lane consumers of an ``auto``
    fan-out hold at a gate until the producer's live row count proves the
    CBO estimate that chose the lane count; if the producer closes below
    the payoff threshold the lanes collapse to a single full-stream
    consumer (the BENCH_PR5 mis-estimate regression, fixed at run time);
  * **pipelined straggler speculation** (``adaptive.speculation``) — a
    lane consumer running far past the median of its finished siblings is
    cloned into a fresh exchange *under the pipelined scheduler*, and the
    merge's reader swaps to the first finisher atomically (before it has
    committed to the original's stream).

Every mid-query DAG mutation flows through :meth:`AdaptiveManager._adopt`,
which applies the mutation, runs ``repro_torch.analysis.check_dag`` on the
result, and rolls the mutation back (recording a ``declined`` event) if
validation fails — the scheduler never executes an unvalidated shape.
Lint rule REP005 enforces the chokepoint statically: adopted-DAG mutations
outside this module are findings.

Decisions are appended to an event list surfaced through
``poll()["adaptive"]`` and EXPLAIN ANALYZE.
"""
from __future__ import annotations

import copy
import os
import threading
import time
from typing import Dict, List, Optional

from ...analysis.lockdep import make_condition
from ...analysis.plan_validator import PlanValidationError, check_dag
from ..obs import clock
from ..obs.trace import emit_event
from ..optimizer import plan as P
from ..sql import ast as A
from .dag import FORWARD, SHUFFLE, MaterializedNode, Vertex, \
    _walk_materialized
from .exchange import Exchange
from .shuffle import _MERGE_FOLD, AUTO_ROWS_PER_PARTITION, ShuffleWriter


def _median(xs: List[float]) -> float:
    return sorted(xs)[len(xs) // 2] if xs else 0.0


class SwappableSource:
    """A merge-side edge reader that can be atomically re-pointed at a
    speculation clone's exchange until the moment it *commits* to the
    original (claims its first available chunk).

    The commit point is claiming availability, not blocking on the
    original — the drain polls :meth:`Exchange.available` and only steps
    the underlying reader when it cannot block, so a swap request always
    finds the reader either uncommitted (swap wins) or already committed
    (swap refused, original's stream is authoritative)."""

    def __init__(self, tag: str, orig: Exchange):
        self.tag = tag
        self._orig = orig
        self._winner: Optional[Exchange] = None
        self._committed = False
        self._resolved = False  # True once no swap can ever arrive
        self._cond = make_condition(name="adaptive.swap")

    # ------------------------------------------------------------ manager
    def try_swap(self, winner: Exchange) -> bool:
        """Point the reader at ``winner`` unless it already committed."""
        with self._cond:
            if self._committed:
                return False
            self._winner = winner
            self._cond.notify_all()
            return True

    def resolve(self) -> None:
        """No swap will arrive anymore (speculation lost or query ending)."""
        with self._cond:
            self._resolved = True
            self._cond.notify_all()

    @property
    def committed(self) -> bool:
        with self._cond:
            return self._committed

    # ------------------------------------------------------------ consumer
    def reader(self):
        it = self._orig.reader()
        i = 0
        while True:
            with self._cond:
                if self._winner is not None and not self._committed:
                    break
                ready = self._orig.available(i)
                if ready and not self._committed and not self._resolved \
                        and self._orig.failed():
                    # the original died before we claimed it: hold out for
                    # a first-finisher swap instead of surfacing the error
                    self._cond.wait(0.05)
                    continue
                if ready:
                    self._committed = True
            if not ready:
                with self._cond:
                    if self._winner is None and not self._resolved:
                        self._cond.wait(0.02)
                continue
            try:
                chunk = next(it)
            except StopIteration:
                return
            i += 1
            yield chunk
        yield from self._winner.reader()


class _AggEdge:
    """One adaptive shuffle edge: a ShuffleWriter producer fanning out to
    per-lane grouped-Aggregate clones merged by a UNION ALL vertex."""

    def __init__(self, producer: str, writer: ShuffleWriter,
                 clones: Dict[int, str], merge: str, union: P.Union,
                 group_keys: List[str], aggs: List[P.AggSpec],
                 est_rows: Optional[float], payoff_threshold: int):
        self.producer = producer
        self.writer = writer
        self.clones = dict(clones)      # lane -> clone vid
        self.merge = merge
        self.union = union
        self.group_keys = list(group_keys)
        self.aggs = list(aggs)
        self.est_rows = est_rows
        self.payoff_threshold = payoff_threshold
        self.payoff_gated = False       # clones held at the gate?
        self.folded = False             # merge wrapped in a fold Aggregate?
        self.split_lanes: List[int] = []
        self.done = False               # producer closed
        self.collapsed = False
        self.progress_total = 0         # rows seen at last skew evaluation


class AdaptiveManager:
    """Replans one running pipelined DAG from live telemetry.

    Created per query by the execute stage (``adaptive.enabled`` and
    pipelined mode only) and handed to :class:`~.dag.DAGScheduler`; the
    scheduler calls ``begin`` / ``on_vertex_start`` / ``source_for`` /
    ``note_vertex_done`` / ``note_vertex_error`` / ``wait`` / ``finish``.
    All manager state is guarded by one condition (`adaptive.manager`);
    the lock order is manager -> swap -> exchange, never reversed."""

    def __init__(self, config: dict, events: Optional[list] = None,
                 on_event=None, plan_cache=None, trace=None):
        self.config = config
        self.events = events if events is not None else []
        self.on_event = on_event
        self.trace = trace  # QueryTrace (None = tracing off, PR 10)
        self.plan_cache = plan_cache
        self.skew_ratio = float(config.get("adaptive.skew_ratio", 4.0))
        self.split_min_rows = int(config.get("adaptive.split_min_rows",
                                             65_536))
        self.split_ways = int(config.get("adaptive.split_ways", 0) or 0)
        # telemetry callback throttle: re-evaluate skew only after the
        # stream grows by this many rows (the verdict can't flip sooner)
        self._progress_step = max(self.split_min_rows // 8, 4096)
        self.speculation = bool(config.get("adaptive.speculation", False))
        self.straggler_factor = float(
            config.get("adaptive.straggler_factor", 4.0))
        self.straggler_min_s = float(
            config.get("adaptive.straggler_min_s", 0.2))
        self.payoff_threshold = int(
            config.get("shuffle.auto_rows_per_partition",
                       AUTO_ROWS_PER_PARTITION))
        self._auto = config.get("shuffle.partitions", 1) == "auto"
        self._cond = make_condition(name="adaptive.manager")
        self._edges: Dict[str, _AggEdge] = {}        # producer vid -> edge
        self._gated: Dict[str, str] = {}             # vid -> gate kind
        self._skip: set = set()
        self._abandoned: set = set()
        self._staged: set = set()                    # un-adopted spec clones
        self._started: Dict[str, float] = {}
        self._done: Dict[str, float] = {}            # vid -> duration
        self._swappables: Dict[str, SwappableSource] = {}
        self._spec_groups: Dict[str, List[str]] = {}  # producer -> clone vids
        self._spec_clone_of: Dict[str, str] = {}     # clone vid -> original
        self._spec_of: Dict[str, str] = {}           # original -> clone vid
        self._spec_merge: Dict[str, str] = {}        # original -> merge vid
        self._threads: List[threading.Thread] = []
        self._monitor: Optional[threading.Thread] = None
        self._counter = 0
        self._finished = False
        self.dag = None

    # ================================================================ setup
    def begin(self, dag, ctx, exchanges, lane_spec, run_vertex,
              cancel_token=None) -> None:
        self.dag = dag
        self.ctx = ctx
        self.exchanges = exchanges
        self.run_vertex = run_vertex
        self.cancel_token = cancel_token
        self.excfg = exchanges[dag.root].cfg
        # lane consumers per ShuffleWriter producer
        lane_consumers: Dict[str, Dict[int, str]] = {}
        merge_of: Dict[str, str] = {}  # clone vid -> consumer vid
        for vid, vert in dag.vertices.items():
            for mn in _walk_materialized(vert.plan):
                if mn.partition is not None \
                        and isinstance(exchanges.get(mn.tag), ShuffleWriter):
                    lane_consumers.setdefault(mn.tag, {})
                    lane_consumers[mn.tag].setdefault(mn.partition, vid)
        for tag, clones in lane_consumers.items():
            edge = self._eligible_agg_edge(tag, clones)
            if edge is not None:
                self._edges[tag] = edge
                # the merge only sees data once the producer closes (its
                # inputs are grouped aggregates over full lanes), so gating
                # it until the split/collapse decision is free
                self._gated[edge.merge] = "merge"
                # gate only inside the estimate's uncertainty band: when
                # the CBO claims several times the fan-out threshold, even
                # a big overestimate still leaves the lanes worthwhile, and
                # holding consumers at the gate just costs overlap
                if self._auto and edge.est_rows is not None \
                        and edge.est_rows < 4 * self.payoff_threshold:
                    edge.payoff_gated = True
                    for cvid in edge.clones.values():
                        self._gated[cvid] = "payoff"
                edge.writer.on_progress = self._on_writer_progress
            if self.speculation:
                merge = self._single_consumer_of(set(clones.values()))
                if merge is None:
                    continue
                self.exchanges[tag].retain = True  # clones re-read lanes
                group = []
                for cvid in clones.values():
                    self._swappables[cvid] = SwappableSource(
                        cvid, exchanges[cvid])
                    self._spec_merge[cvid] = merge
                    group.append(cvid)
                self._spec_groups[tag] = group
        if self.speculation and self._spec_groups:
            self._monitor = threading.Thread(
                target=self._monitor_stragglers,
                name="adaptive-monitor", daemon=True)
            self._monitor.start()

    def _eligible_agg_edge(self, tag: str,
                           clones: Dict[int, str]) -> Optional[_AggEdge]:
        """Edge state when every lane clone is the same splittable grouped
        aggregate (foldable, non-DISTINCT) merged by one UNION ALL vertex."""
        writer = self.exchanges[tag]
        if sorted(clones) != list(range(writer.num_partitions)):
            return None
        plans = []
        for p, cvid in clones.items():
            plan = self.dag.vertices[cvid].plan
            if not (isinstance(plan, P.Aggregate) and plan.group_keys
                    and plan.grouping_sets is None):
                return None
            if any(s.distinct or s.fn not in _MERGE_FOLD for s in plan.aggs):
                return None
            mns = list(_walk_materialized(plan))
            if len(mns) != 1 or mns[0].tag != tag \
                    or mns[0].partition != p:
                return None
            plans.append(plan)
        gk = plans[0].group_keys
        if any(pl.group_keys != gk for pl in plans):
            return None
        merge = self._single_consumer_of(set(clones.values()))
        if merge is None:
            return None
        union = self.dag.vertices[merge].plan
        if not (isinstance(union, P.Union) and union.all):
            return None
        tags = [c.tag for c in union.inputs
                if isinstance(c, MaterializedNode)]
        if len(tags) != len(union.inputs) or set(tags) != set(clones.values()):
            return None
        est = list(_walk_materialized(plans[0]))[0].est_rows
        return _AggEdge(tag, writer, clones, merge, union, gk,
                        plans[0].aggs, est, self.payoff_threshold)

    def _single_consumer_of(self, vids: set) -> Optional[str]:
        """The one vertex whose placeholders read every vid in ``vids``."""
        consumer = None
        for vid, vert in self.dag.vertices.items():
            read = {mn.tag for mn in _walk_materialized(vert.plan)}
            if read & vids:
                if consumer is not None or not vids <= read:
                    return None
                consumer = vid
        return consumer

    # ======================================================= scheduler hooks
    def on_vertex_start(self, vid: str) -> str:
        """Gate point: block while a replanning decision for ``vid`` is
        pending; ``skip`` means the vertex was replanned away."""
        with self._cond:
            self._started[vid] = clock.monotonic()
            while vid in self._gated and not self._finished:
                self._cond.wait(0.05)
                if self.cancel_token is not None:
                    self.cancel_token.check()
            if vid in self._skip:
                return "skip"
        return "run"

    def source_for(self, vid: str, mn: MaterializedNode, src):
        """The source a consumer binds for one edge — a swappable wrapper
        on speculation-eligible merge edges, the raw exchange otherwise."""
        sw = self._swappables.get(mn.tag)
        if sw is not None and mn.partition is None \
                and self._spec_merge.get(mn.tag) == vid:
            return sw
        return src

    def note_vertex_done(self, vid: str, rows: int, seconds: float) -> None:
        with self._cond:
            self._done[vid] = seconds
            edge = self._edges.get(vid)
            if edge is not None and not edge.done:
                edge.done = True
                edge.writer.on_progress = None
                if edge.payoff_gated:
                    self._decide_payoff(edge)
                self._release(edge.merge)
            self._resolve_speculation(vid)
            self._cond.notify_all()

    def note_vertex_error(self, vid: str, exc: BaseException) -> bool:
        """True when the failure is absorbed (the vertex was replanned away
        or lost a speculation race and nothing reads its exchange)."""
        with self._cond:
            if vid in self._abandoned or vid in self._skip:
                return True
            # a failing original whose live speculation clone can still win:
            # abandon the original and let the clone's stream swap in
            svid = self._spec_of.get(vid)
            if svid is not None and svid not in self._done \
                    and svid not in self._abandoned \
                    and not self._swappables[vid].committed:
                self._abandoned.add(vid)
                return True
            edge = self._edges.get(vid)
            if edge is not None and not edge.done:
                # producer failed: nothing to decide anymore — release
                # every gate so consumers observe the error promptly
                edge.done = True
                edge.writer.on_progress = None
                edge.payoff_gated = False
                for cvid in edge.clones.values():
                    self._release(cvid)
                self._release(edge.merge)
            self._cond.notify_all()
            return False

    def wait(self) -> None:
        """Join adaptive vertex threads (the query isn't done until the
        replanned vertices are)."""
        while True:
            with self._cond:
                threads = [t for t in self._threads if t.is_alive()]
            if not threads:
                return
            for t in threads:
                t.join()

    def finish(self) -> None:
        with self._cond:
            self._finished = True
            for edge in self._edges.values():
                edge.writer.on_progress = None
            for sw in self._swappables.values():
                sw.resolve()
            self._cond.notify_all()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
        for t in list(self._threads):
            t.join(timeout=5.0)

    # ============================================================== internals
    def _record(self, event: dict) -> None:
        self.events.append(event)
        emit_event(self.trace, f"adaptive:{event.get('kind')}", "adaptive",
                   **event)
        if self.on_event is not None:
            try:
                self.on_event(event)
            except Exception:  # noqa: BLE001 - telemetry must not kill a query
                pass

    def _release(self, vid: str) -> None:
        self._gated.pop(vid, None)

    def _new_vid(self) -> str:
        self._counter += 1
        return f"adp{self._counter}"

    def _spawn(self, vid: str) -> None:
        t = threading.Thread(target=self.run_vertex, args=(vid,),
                             name=f"adaptive-{vid}", daemon=True)
        self._threads.append(t)
        t.start()

    def _adopt(self, apply, undo, event: Optional[dict]) -> bool:
        """The validating adopt-helper: every adopted-DAG mutation runs
        through here (REP005's one allowed chokepoint).  The mutation is
        applied, the whole DAG re-validated with ``check_dag``, and rolled
        back — recording a ``declined`` event — on any violation.  A
        ``None`` event adopts (or declines) silently."""
        apply()
        try:
            check_dag(self.dag, self.plan_cache, staged=self._staged)
        except PlanValidationError as exc:
            undo()
            if event is not None:
                self._record({"kind": "declined",
                              "wanted": event.get("kind"),
                              "edge": event.get("edge"),
                              "reason": exc.violations[0]})
            return False
        if event is not None:
            self._record(event)
        return True

    # ------------------------------------------------------ payoff fan-out
    def _decide_payoff(self, edge: _AggEdge) -> None:
        """Producer closed with the clones still gated: keep the fan-out
        only if the observed rows justify it (vs the CBO estimate that
        chose the lane count)."""
        edge.payoff_gated = False
        total = sum(edge.writer.lane_rows())
        if total >= edge.payoff_threshold or edge.split_lanes:
            for cvid in edge.clones.values():
                self._release(cvid)
            return
        self._collapse(edge, total)

    def _collapse(self, edge: _AggEdge, total: int) -> None:
        """Fan-out won't pay: replace the per-lane clones with one
        full-stream consumer reading every lane of the producer."""
        dag = self.dag
        vid_new = self._new_vid()
        clone0 = dag.vertices[edge.clones[0]]
        plan = copy.deepcopy(clone0.plan)
        for mn in _walk_materialized(plan):
            mn.partition = None
            mn.num_partitions = None
        names = clone0.plan.output_names()
        merge = dag.vertices[edge.merge]
        saved = (dict(dag.vertices), list(merge.deps),
                 dict(merge.edge_types), list(edge.union.inputs))

        def apply():
            for cvid in edge.clones.values():
                dag.vertices.pop(cvid, None)
            dag.vertices[vid_new] = Vertex(
                vid_new, plan, deps=[edge.producer],
                edge_types={edge.producer: SHUFFLE})
            edge.union.inputs = [MaterializedNode(list(names), vid_new)]
            merge.deps = [d for d in merge.deps
                          if d not in edge.clones.values()] + [vid_new]
            for cvid in edge.clones.values():
                merge.edge_types.pop(cvid, None)
            merge.edge_types[vid_new] = FORWARD

        def undo():
            dag.vertices.clear()
            dag.vertices.update(saved[0])
            merge.deps = saved[1]
            merge.edge_types = saved[2]
            edge.union.inputs = saved[3]

        ok = self._adopt(apply, undo, {
            "kind": "collapsed_fanout", "edge": edge.producer,
            "lanes": edge.writer.num_partitions, "rows": total,
            "est_rows": edge.est_rows, "threshold": edge.payoff_threshold,
        })
        if not ok:
            for cvid in edge.clones.values():
                self._release(cvid)
            return
        edge.collapsed = True
        ex = Exchange(vid_new, self.excfg)
        ex.retain = False  # single consumer: the merge
        ex.declare_schema(
            getattr(self.dag.vertices[vid_new].plan, "schema", None))
        self.exchanges[vid_new] = ex
        for cvid in edge.clones.values():
            self._skip.add(cvid)
            self._release(cvid)
        self._spawn(vid_new)

    # -------------------------------------------------------- hot-lane split
    def _on_writer_progress(self, writer: ShuffleWriter) -> None:
        # producer thread: routing state is same-thread, manager state locked
        edge = self._edges.get(writer.tag)
        if edge is None:
            return
        rows = writer.lane_rows()
        total = sum(rows)
        # unlocked throttle: the callback fires on every producer batch, but
        # a skew verdict cannot change until the stream has grown by a
        # meaningful step — skip the lock (and the per-lane medians) until
        # it has.  A gated payoff edge bypasses the throttle so its clones
        # are released the moment live rows prove the fan-out.
        if not edge.payoff_gated and \
                total - edge.progress_total < self._progress_step:
            return
        with self._cond:
            if self._finished or edge.done or edge.collapsed:
                return
            edge.progress_total = total
            if edge.payoff_gated and (
                    total >= edge.payoff_threshold
                    or max(rows) >= self.excfg.buffer_rows):
                # live rows prove the fan-out — or a lane hit its in-memory
                # budget, where holding the gate would pay spill I/O just to
                # defer the decision: release the lane clones so they
                # overlap with the rest of the producer's stream
                edge.payoff_gated = False
                for cvid in edge.clones.values():
                    self._release(cvid)
                self._cond.notify_all()
            for p, r in enumerate(rows):
                if p in writer._split:
                    continue
                # skew is measured against the *sibling* lanes: with few
                # lanes a hot lane dominates the overall median and would
                # mask itself
                med = _median([x for i, x in enumerate(rows) if i != p])
                if r >= self.split_min_rows and r > self.skew_ratio \
                        * max(med, 1.0):
                    self._split_lane(edge, writer, p, r, med)
                    break  # at most one split per progress callback

    def _split_lane(self, edge: _AggEdge, writer: ShuffleWriter,
                    p: int, lane_rows: int, lane_median: float) -> None:
        dag = self.dag
        ways = self.split_ways if self.split_ways >= 2 \
            else max(2, min(4, os.cpu_count() or 4))
        start = len(writer._subs)  # sub_lane_reader indices after the split
        clone = dag.vertices[edge.clones[p]]
        sub_vids, sub_vertices, sub_mns = [], [], []
        for j in range(ways):
            svid = self._new_vid()
            splan = copy.deepcopy(clone.plan)
            for mn in _walk_materialized(splan):
                mn.partition = None
                mn.num_partitions = None
                mn.sub_lane = start + j
            sub_vids.append(svid)
            sub_vertices.append(Vertex(
                svid, splan, deps=[edge.producer],
                edge_types={edge.producer: SHUFFLE}))
            sub_mns.append(MaterializedNode(
                list(clone.plan.output_names()), svid))
        merge = dag.vertices[edge.merge]
        saved = (list(merge.deps), dict(merge.edge_types),
                 list(edge.union.inputs), merge.plan, edge.folded)

        def apply():
            for v in sub_vertices:
                dag.vertices[v.vid] = v
            edge.union.inputs = edge.union.inputs + sub_mns
            merge.deps = merge.deps + sub_vids
            for svid in sub_vids:
                merge.edge_types[svid] = FORWARD
            if not edge.folded:
                # the split lane's groups now span its prefix consumer and
                # the sub-lane consumers: re-combine partials with the
                # merging fold (COUNT partials re-SUM, like global DISTINCT)
                folds = [P.AggSpec(_MERGE_FOLD[s.fn], A.Col(s.out_name),
                                   False, s.out_name) for s in edge.aggs]
                merge.plan = P.Aggregate(edge.union, list(edge.group_keys),
                                         folds)
                edge.folded = True

        def undo():
            for svid in sub_vids:
                dag.vertices.pop(svid, None)
            merge.deps = saved[0]
            merge.edge_types = saved[1]
            edge.union.inputs = saved[2]
            merge.plan = saved[3]
            edge.folded = saved[4]

        ok = self._adopt(apply, undo, {
            "kind": "lane_split", "edge": edge.producer, "lane": p,
            "ways": ways, "lane_rows": lane_rows,
            "lane_median": lane_median,
        })
        if not ok:
            return
        edge.split_lanes.append(p)
        if edge.payoff_gated:
            # a split implies real volume; never collapse after splitting
            edge.payoff_gated = False
            for cvid in edge.clones.values():
                self._release(cvid)
        for svid in sub_vids:
            ex = Exchange(svid, self.excfg)
            ex.retain = False
            ex.declare_schema(
                getattr(self.dag.vertices[svid].plan, "schema", None))
            self.exchanges[svid] = ex
        writer.split_lane(p, ways)
        for svid in sub_vids:
            self._spawn(svid)
        self._cond.notify_all()

    # ---------------------------------------------------------- speculation
    def _monitor_stragglers(self) -> None:
        while True:
            time.sleep(0.05)
            with self._cond:
                if self._finished:
                    return
                now = clock.monotonic()
                for group in self._spec_groups.values():
                    durations = [self._done[v] for v in group
                                 if v in self._done]
                    if not durations:
                        continue
                    med = _median(durations)
                    cutoff = max(self.straggler_min_s,
                                 self.straggler_factor * med)
                    for vid in group:
                        if vid in self._done or vid in self._spec_of \
                                or vid in self._abandoned \
                                or vid in self._skip \
                                or vid not in self._started \
                                or vid not in self.dag.vertices:
                            continue
                        if now - self._started[vid] > cutoff:
                            self._speculate(vid)

    def _speculate(self, vid: str) -> None:
        """Stage a clone of straggler ``vid`` into a fresh exchange; the
        DAG adoption happens only if the clone finishes first."""
        svid = self._new_vid()
        vert = self.dag.vertices[vid]
        plan = copy.deepcopy(vert.plan)
        clone = Vertex(svid, plan, deps=list(vert.deps),
                       edge_types=dict(vert.edge_types))
        dag = self.dag

        def apply():
            dag.vertices[svid] = clone

        def undo():
            dag.vertices.pop(svid, None)

        self._staged.add(svid)
        if not self._adopt(apply, undo, {
                "kind": "speculated", "vertex": vid, "clone": svid,
                "elapsed_s": round(
                    clock.monotonic() - self._started[vid], 3)}):
            self._staged.discard(svid)
            return
        ex = Exchange(svid, self.excfg)
        ex.declare_schema(
            getattr(self.dag.vertices[svid].plan, "schema", None))
        self.exchanges[svid] = ex
        self._spec_of[vid] = svid
        self._spec_clone_of[svid] = vid
        self._spawn(svid)

    def _resolve_speculation(self, vid: str) -> None:
        """First-finisher resolution, called (under the manager lock) when
        any vertex finishes."""
        dag = self.dag
        orig = self._spec_clone_of.get(vid)
        if orig is not None:
            # a clone finished: swap the merge's reader unless the original
            # already committed
            if orig in self._abandoned or orig not in dag.vertices:
                pass
            elif vid in self._abandoned:
                return
            sw = self._swappables[orig]
            if not sw.try_swap(self.exchanges[vid]):
                self._abandoned.add(vid)
                self._retire_clone(vid)
                self._record({"kind": "speculation_lost", "vertex": orig,
                              "clone": vid})
                return
            merge = dag.vertices[self._spec_merge[orig]]
            saved_vertices = dict(dag.vertices)
            saved = (list(merge.deps), dict(merge.edge_types))
            swapped_mns = []

            def apply():
                dag.vertices.pop(orig, None)
                for mn in _walk_materialized(merge.plan):
                    if mn.tag == orig:
                        mn.tag = vid
                        swapped_mns.append(mn)
                merge.deps = [vid if d == orig else d for d in merge.deps]
                et = merge.edge_types.pop(orig, None)
                if et is not None:
                    merge.edge_types[vid] = et

            def undo():
                dag.vertices.clear()
                dag.vertices.update(saved_vertices)
                for mn in swapped_mns:
                    mn.tag = orig
                merge.deps = saved[0]
                merge.edge_types = saved[1]

            if self._adopt(apply, undo, {
                    "kind": "speculation_swap", "vertex": orig,
                    "clone": vid}):
                self._abandoned.add(orig)
                self._staged.discard(vid)
            return
        svid = self._spec_of.get(vid)
        if svid is not None and vid not in self._abandoned:
            # the original finished first: the clone lost
            sw = self._swappables[vid]
            sw.resolve()
            if svid not in self._done:
                self._abandoned.add(svid)
                self._retire_clone(svid)
                self._record({"kind": "speculation_lost", "vertex": vid,
                              "clone": svid})

    def _retire_clone(self, svid: str) -> None:
        """Drop a losing speculation clone from the DAG (validated like any
        other mid-query mutation; no event of its own — the caller records
        ``speculation_lost``)."""
        dag = self.dag
        saved = dag.vertices.get(svid)

        def apply():
            dag.vertices.pop(svid, None)

        def undo():
            if saved is not None:
                dag.vertices[svid] = saved

        if self._adopt(apply, undo, None):
            self._staged.discard(svid)
