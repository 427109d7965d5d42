"""Tez-style DAG task compiler & scheduler (paper §2, §5).

The task compiler breaks the physical operator tree into a DAG of executable
tasks: pipelineable unary operators (filter/project/limit) fuse into their
producer vertex; blocking operators (join, aggregate, sort, union, window)
start new vertices.  Edges carry the data-movement type the engine would use
(FORWARD / BROADCAST / SHUFFLE), which is what a distributed runtime maps
onto collectives.

Scheduling runs vertices in dependency order on either throwaway "container"
threads or the persistent LLAP executor pool (§5.1), with optional
speculative re-execution of stragglers (the classic MapReduce/Tez
mitigation; here a code path exercised in tests via an injectable delay).
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set

import numpy as np

from ...analysis.lockdep import make_lock
from ..obs import clock
from ..obs.trace import close_vertex_frame, emit_event, open_vertex_frame
from ..optimizer import plan as P
from .exec import ExecContext, Executor
from .vector import VectorBatch

FORWARD, BROADCAST, SHUFFLE = "FORWARD", "BROADCAST", "SHUFFLE"


class MaterializedNode(P.PlanNode):
    """Vertex-input placeholder for one DAG edge.

    In barrier (materialized) mode the upstream vertex's whole output batch
    is assigned to ``batch``; in pipelined mode ``source`` points at the
    upstream vertex's spill-aware :class:`~repro_torch.core.runtime.exchange.Exchange`
    and every consumer replays its chunk stream through a fresh reader.

    A *partitioned* placeholder (lowered from a
    :class:`~repro_torch.core.optimizer.plan.ShuffleRead`) reads one hash lane of
    the producer's partitioned shuffle edge: in pipelined mode ``source`` is
    the producer's :class:`~repro_torch.core.runtime.shuffle.ShuffleWriter` (or a
    plain exchange, filtered at read time when partitioned and full readers
    mix); in barrier mode the materialized batch is filtered to the lane."""

    _counter = [0]

    def __init__(self, names: List[str], tag: str,
                 partition: Optional[int] = None,
                 num_partitions: Optional[int] = None,
                 partition_keys: Optional[List[str]] = None,
                 sub_lane: Optional[int] = None,
                 est_rows: Optional[float] = None,
                 schema=None):
        self.names = names
        self.tag = tag
        # the producer's inferred output schema (repro_torch.core.schema.Schema),
        # copied from the plan node this edge replaced at compile time
        self.schema = schema
        self.partition = partition
        self.num_partitions = num_partitions
        self.partition_keys = partition_keys or []
        # adaptive hot-lane split: a placeholder reading one *sub-lane* of a
        # producer's split shuffle lane (ShuffleWriter.sub_lane_reader index)
        self.sub_lane = sub_lane
        # the CBO row estimate the lane count was derived from (None under a
        # fixed shuffle.partitions) — the adaptive payoff gate compares it
        # against live producer rows
        self.est_rows = est_rows
        self.batch: Optional[VectorBatch] = None
        self.source = None  # Exchange / ShuffleWriter (pipelined scheduling)
        self.inputs = []

    def __deepcopy__(self, memo):
        # adaptive replanning clones vertex plans (speculation clones,
        # sub-lane consumers, collapse targets); the clone must NOT drag the
        # bound runtime state along — batch/source rebind at vertex start
        clone = MaterializedNode(
            list(self.names), self.tag, partition=self.partition,
            num_partitions=self.num_partitions,
            partition_keys=list(self.partition_keys),
            sub_lane=self.sub_lane, est_rows=self.est_rows,
            schema=self.schema)
        memo[id(self)] = clone
        return clone

    def output_names(self):
        return list(self.names)

    def key(self):
        if self.sub_lane is not None:
            return f"materialized({self.tag}#s{self.sub_lane})"
        if self.partition is not None:
            return (f"materialized({self.tag}"
                    f"#p{self.partition}/{self.num_partitions})")
        return f"materialized({self.tag})"

    def describe(self):
        if self.sub_lane is not None:
            return f"MaterializedEdge[{self.tag} sub-lane {self.sub_lane}]"
        if self.partition is not None:
            return (f"MaterializedEdge[{self.tag} "
                    f"lane {self.partition}/{self.num_partitions}]")
        return f"MaterializedEdge[{self.tag}]"


@dataclass
class Vertex:
    vid: str
    plan: P.PlanNode
    deps: List[str] = field(default_factory=list)
    edge_types: Dict[str, str] = field(default_factory=dict)  # dep vid -> type
    feeds: Dict[str, MaterializedNode] = field(default_factory=dict)


@dataclass
class TaskDAG:
    vertices: Dict[str, Vertex]
    root: str

    def topo_order(self) -> List[str]:
        out, seen = [], set()

        def visit(v):
            if v in seen:
                return
            seen.add(v)
            for d in self.vertices[v].deps:
                visit(d)
            out.append(v)

        visit(self.root)
        return out

    def edge_summary(self) -> Dict[str, int]:
        counts = {FORWARD: 0, BROADCAST: 0, SHUFFLE: 0}
        for v in self.vertices.values():
            for t in v.edge_types.values():
                counts[t] += 1
        return counts


# FederatedScan counts as a vertex boundary so compile-time split expansion
# (UNION ALL of per-split scans) fans external reads out across concurrently
# scheduled vertices — splits stream through exchanges in parallel.
_BLOCKING = (P.Join, P.Aggregate, P.Sort, P.Union, P.WindowOp, P.FederatedScan)


def compile_dag(plan: P.PlanNode) -> TaskDAG:
    """Break the operator tree into vertices.

    Plans can be DAGs (shared-work reuse, semijoin producers referencing the
    dimension subtree), so vertex construction is memoized per node object
    and boundary placeholders are filled by tag at run time.
    """
    # (re-)infer output schemas on the final optimized tree: optimizer
    # rewrites (projection pushdown, shuffle expansion) invalidate any
    # bind-time annotation, and edge placeholders/exchange declarations
    # below copy node.schema — a stale schema here would make the runtime
    # sanitizer reject correct morsels
    from ..schema import annotate_plan

    annotate_plan(plan)
    vertices: Dict[str, Vertex] = {}
    built: Dict[int, str] = {}
    counter = [0]

    def new_vid() -> str:
        counter[0] += 1
        return f"v{counter[0]}"

    def _edge_type(parent: P.PlanNode, input_idx: int) -> str:
        if isinstance(parent, P.Join):
            if parent.strategy == "broadcast" and input_idx == 1:
                return BROADCAST
            return SHUFFLE if parent.strategy == "shuffle" else FORWARD
        if isinstance(parent, (P.Aggregate, P.Sort, P.WindowOp)):
            return SHUFFLE
        return FORWARD

    def build(node: P.PlanNode) -> str:
        if id(node) in built:
            return built[id(node)]
        vid = new_vid()
        built[id(node)] = vid
        vertex = Vertex(vid, node)
        vertices[vid] = vertex
        split(node, vertex, set())
        # dependencies: every placeholder reachable in this vertex's subtree
        deps = {}
        for mn in _walk_materialized(node):
            deps[mn.tag] = True
        for rf_dep in vertex.feeds:
            deps[rf_dep] = True
        vertex.deps = list(deps)
        return vid

    def split(node: P.PlanNode, vertex: Vertex, visited) -> None:
        if id(node) in visited or isinstance(node, MaterializedNode):
            return
        visited.add(id(node))
        if isinstance(node, P.Scan):
            # runtime-filter producers become upstream BROADCAST vertices
            for rf in node.runtime_filters:
                dep = build(rf.producer)
                vertex.edge_types[dep] = BROADCAST
                vertex.feeds[dep] = None  # dependency only; executed inline
            return
        for i, child in enumerate(node.inputs):
            if isinstance(child, MaterializedNode):
                vertex.edge_types.setdefault(child.tag, _edge_type(node, i))
                continue
            if isinstance(child, P.ShuffleRead):
                # one hash lane of the shared producer subtree: the producer
                # compiles once (memoized) and every per-partition clone
                # reads its own lane of the partitioned SHUFFLE edge
                dep = build(child.source)
                placeholder = MaterializedNode(
                    child.output_names(), dep,
                    partition=child.partition,
                    num_partitions=child.num_partitions,
                    partition_keys=list(child.keys),
                    est_rows=child.est_rows,
                    schema=child.schema,
                )
                node.inputs[i] = placeholder
                vertex.edge_types[dep] = SHUFFLE
                continue
            if isinstance(child, _BLOCKING) or isinstance(node, P.Join):
                dep = build(child)
                placeholder = MaterializedNode(child.output_names(), dep,
                                               schema=child.schema)
                node.inputs[i] = placeholder
                vertex.edge_types[dep] = _edge_type(node, i)
            else:
                split(child, vertex, visited)

    root = build(plan)
    return TaskDAG(vertices, root)


def _walk_materialized(node: P.PlanNode, seen=None):
    seen = seen if seen is not None else set()
    if id(node) in seen:
        return
    seen.add(id(node))
    if isinstance(node, MaterializedNode):
        yield node
        return
    for c in node.inputs:
        yield from _walk_materialized(c, seen)
    if isinstance(node, P.Scan):
        for rf in node.runtime_filters:
            yield from _walk_materialized(rf.producer, seen)


def partitioned_edges(dag: TaskDAG) -> Dict[str, tuple]:
    """Producer vids whose partitioned readers agree on one
    ``(num_partitions, keys)`` spec — these edges get lane arrays; a
    producer read with conflicting specs (or only full-stream readers)
    stays a single exchange and partitioned readers filter at read time."""
    spec: Dict[str, tuple] = {}
    conflicted = set()
    for v in dag.vertices.values():
        for mn in _walk_materialized(v.plan):
            if mn.partition is None:
                continue
            this = (mn.num_partitions, tuple(mn.partition_keys))
            if mn.tag in spec and spec[mn.tag] != this:
                conflicted.add(mn.tag)
            spec.setdefault(mn.tag, this)
    return {tag: (n, list(keys)) for tag, (n, keys) in spec.items()
            if tag not in conflicted}


def describe_exchanges(dag: TaskDAG) -> List[str]:
    """One line per DAG edge: producer -> consumer, movement kind, and the
    lane count on partitioned shuffle boundaries (EXPLAIN rendering)."""
    lanes = partitioned_edges(dag)
    lines = []
    for vid in dag.topo_order():
        v = dag.vertices[vid]
        for dep in sorted(v.deps):
            kind = v.edge_types.get(dep, FORWARD)
            extra = ""
            if dep in lanes:
                n, keys = lanes[dep]
                extra = f" partitions={n} keys={keys}"
            sch = getattr(dag.vertices[dep].plan, "schema", None)
            if sch is not None:
                extra += f" schema=[{sch.describe()}]"
            lines.append(f"  {dep} -> {vid}: {kind}{extra}")
    return lines


@dataclass
class VertexMetrics:
    vid: str
    rows: int
    seconds: float
    speculated: bool = False
    spilled_rows: int = 0
    spilled_bytes: int = 0
    peak_buffered_rows: int = 0


class DAGScheduler:
    """Runs a task DAG in one of two modes.

    *Pipelined* (the default): every vertex is submitted in topological
    order and starts as soon as a worker is free; vertices exchange
    ``VectorBatch`` morsels through spill-aware :class:`Exchange` buffers,
    so a consumer processes its producer's first chunks while the producer
    is still running, and the root's chunks reach ``on_root_chunk`` (and
    from there the client's ``fetch_stream``) before the DAG finishes.
    Submission in topo order onto a FIFO pool guarantees progress: the
    earliest unfinished vertex always has every producer already running or
    done, and ``Exchange.put`` never blocks (overflow spills to scratch),
    so no producer can deadlock behind its consumers.

    *Barrier* (``exchange.pipeline = False``, and always under speculative
    execution): the pre-streaming behavior — each vertex materializes its
    whole output and downstream vertices start only when every dependency
    has finished.  Operators still stream morsels internally, so cancel/kill
    latency stays bounded by one morsel either way.
    """

    def __init__(
        self,
        pool: Optional[ThreadPoolExecutor] = None,
        speculative: bool = False,
        straggler_factor: float = 4.0,
        injected_delays: Optional[Dict[str, float]] = None,  # test hook
        vertex_delay: float = 0.0,  # debug/test hook: sleep per vertex
        adaptive=None,  # AdaptiveManager (pipelined mode only)
    ):
        self.pool = pool
        self.speculative = speculative
        self.straggler_factor = straggler_factor
        self.injected_delays = injected_delays or {}
        self.vertex_delay = vertex_delay
        self.adaptive = adaptive
        self.metrics: List[VertexMetrics] = []
        # serving tier: per-query shared-scan activity (ExecuteStage copies
        # this into q.info, surfaced through poll()/server_stats())
        self.shared_scan_stats = {"published": 0, "attached": 0,
                                  "fallbacks": 0}

    def execute(self, dag: TaskDAG, ctx: ExecContext,
                on_vertex_done: Optional[Callable] = None,
                on_root_chunk: Optional[Callable] = None) -> VectorBatch:
        own_pool = False
        pool = self.pool
        if pool is None:
            pool = ThreadPoolExecutor(max_workers=4, thread_name_prefix="container")
            own_pool = True
        pipelined = bool(ctx.config.get("exchange.pipeline", True)) \
            and not self.speculative
        try:
            if pipelined:
                return self._execute_pipelined(dag, ctx, pool,
                                               on_vertex_done, on_root_chunk)
            return self._execute_barrier(dag, ctx, pool,
                                         on_vertex_done, on_root_chunk)
        finally:
            if own_pool:
                pool.shutdown(wait=False)

    # ------------------------------------------------------------ pipelined
    def _execute_pipelined(self, dag: TaskDAG, ctx: ExecContext, pool,
                           on_vertex_done, on_root_chunk) -> VectorBatch:
        from .exchange import Exchange, ExchangeConfig
        from .shuffle import ShuffleWriter

        cancel_token = getattr(ctx, "cancel_token", None)
        excfg = ExchangeConfig(ctx.config,
                               ctx.config.get("exchange.spill_dir"))
        # observability: resolved once per query; each vertex thread binds
        # the query's trace (None = off), every exchange built below gets
        # the metrics registry
        trace = getattr(ctx, "trace", None)
        excfg.metrics = getattr(ctx, "metrics", None)
        # partitioned SHUFFLE edges: a producer whose consumers all agree on
        # one (num_partitions, keys) spec writes through a ShuffleWriter lane
        # array; disagreeing specs (a subtree shared by differently-keyed
        # consumers) fall back to a plain exchange with read-time filtering
        lane_spec = partitioned_edges(dag)
        lane_readers: Dict[str, List[int]] = {
            tag: [0] * n for tag, (n, _) in lane_spec.items()
        }
        readers: Dict[str, int] = {vid: 0 for vid in dag.vertices}
        full_readers: Dict[str, int] = {vid: 0 for vid in dag.vertices}
        for v in dag.vertices.values():
            for mn in _walk_materialized(v.plan):
                readers[mn.tag] += 1
                if mn.tag in lane_spec and mn.partition is not None:
                    lane_readers[mn.tag][mn.partition] += 1
                else:
                    full_readers[mn.tag] += 1
        exchanges: Dict[str, object] = {}
        for vid in dag.vertices:
            if vid in lane_spec and vid != dag.root:
                n, keys = lane_spec[vid]
                exchanges[vid] = ShuffleWriter(
                    vid, excfg, n, keys, engine=ctx.engine,
                    batch_rows=int(ctx.config.get("shuffle.lane_batch_rows",
                                                  8192) or 8192))
            else:
                exchanges[vid] = Exchange(vid, excfg)
        # typed contract: every edge declares its producer's inferred output
        # schema; under debug.check_batches/REPRO_CHECK_BATCHES the exchange
        # asserts each morsel conforms (free when unset — declare_schema
        # leaves the put() fast path untouched)
        for vid, ex in exchanges.items():
            ex.declare_schema(getattr(dag.vertices[vid].plan, "schema", None))
        # refcount readers per edge: a single-consumer FORWARD edge (and a
        # single-reader shuffle lane) frees chunks (and unlinks spill files)
        # as they are consumed instead of retaining them until query end;
        # multi-consumer edges (shared-work reuse) and the root (replayed by
        # read_all) keep full retention
        for vid, ex in exchanges.items():
            if isinstance(ex, ShuffleWriter):
                ex.configure_retention(lane_readers[vid], full_readers[vid])
            else:
                ex.retain = readers[vid] != 1 or vid == dag.root
        lock = make_lock("dag.metrics")
        errors: List[BaseException] = []
        # serving tier: scan vertices whose output may be shared with (or
        # attached from) a concurrent query's identical scan
        registry = getattr(ctx, "shared_scans", None)
        shareable = self._shareable_vertices(dag, ctx, lane_spec) \
            if registry is not None else {}
        published: Dict[str, object] = {}  # vid -> registry key

        def stream_attached(handle, vid, out_ex) -> Optional[int]:
            """Replay a published exchange into this vertex's own edge.

            Returns the row count, or None when the producer failed before
            we emitted anything — the caller falls back to a fresh scan."""
            rows = 0
            try:
                for chunk in handle.reader():
                    if cancel_token is not None:
                        cancel_token.check()
                    rows += chunk.num_rows
                    out_ex.put(chunk)
                    if vid == dag.root and on_root_chunk is not None:
                        on_root_chunk(chunk)
            except BaseException:
                if rows == 0 and not (cancel_token is not None
                                      and cancel_token.is_set()):
                    return None
                raise
            finally:
                handle.release()
            return rows

        adaptive = self.adaptive

        def run_vertex(vid: str) -> None:
            out_ex = exchanges[vid]
            frame = None
            try:
                if cancel_token is not None:
                    cancel_token.check()
                if adaptive is not None:
                    # replanning gate: merge/clone vertices of adaptive
                    # edges wait here for the split / collapse decision;
                    # "skip" means the vertex was replanned away (its
                    # consumers were rewired through a validated mutation)
                    if adaptive.on_vertex_start(vid) == "skip":
                        out_ex.close()
                        return
                if vid in self.injected_delays:
                    time.sleep(self.injected_delays[vid])
                if self.vertex_delay:
                    time.sleep(self.vertex_delay)
                v = dag.vertices[vid]
                for mn in _walk_materialized(v.plan):
                    src = exchanges[mn.tag]
                    mn.source = (adaptive.source_for(vid, mn, src)
                                 if adaptive is not None else src)
                t0 = clock.perf_counter()
                # the query's trace is this thread's current one (kernel,
                # probe, exchange-wait and spill spans) until the vertex ends
                frame = open_vertex_frame(trace) if trace is not None \
                    else None
                rows: Optional[int] = None
                if vid in shareable:
                    key, table = shareable[vid]
                    handle = registry.attach(key)
                    if handle is not None:
                        rows = stream_attached(handle, vid, out_ex)
                        if rows is None:
                            registry.note_fallback()
                            emit_event(trace, f"serving:fallback:{vid}",
                                       "serving", table=table)
                            with lock:
                                self.shared_scan_stats["fallbacks"] += 1
                        else:
                            emit_event(trace, f"serving:attached:{vid}",
                                       "serving", table=table, rows=rows)
                            with lock:
                                self.shared_scan_stats["attached"] += 1
                    elif registry.publish(key, table, out_ex):
                        # keep every chunk for late attachers; the registry
                        # owns discard once consumers are attached
                        out_ex.retain = True
                        emit_event(trace, f"serving:published:{vid}",
                                   "serving", table=table)
                        with lock:
                            published[vid] = key
                            self.shared_scan_stats["published"] += 1
                if rows is None:
                    ex = _VertexExecutor(ctx)
                    rows = 0
                    for chunk in ex.stream(v.plan):
                        rows += chunk.num_rows
                        out_ex.put(chunk)
                        if vid == dag.root and on_root_chunk is not None:
                            on_root_chunk(chunk)
                out_ex.close()
                dt = clock.perf_counter() - t0
                st = out_ex.stats()
                if trace is not None:
                    lanes = st.get("lanes")
                    trace.add_vertex(
                        vid, t0, dt, wait_s=frame.wait_s,
                        spill_s=frame.spill_s, rows=rows,
                        lanes=([{"partition": i, **ln}
                                for i, ln in enumerate(lanes)]
                               if lanes else None))
                with lock:
                    self.metrics.append(VertexMetrics(
                        vid, rows, dt,
                        spilled_rows=st["spilled_rows"],
                        spilled_bytes=st["spilled_bytes"],
                        peak_buffered_rows=st["peak_buffered_rows"],
                    ))
                if adaptive is not None:
                    adaptive.note_vertex_done(vid, rows, dt)
                if on_vertex_done is not None:
                    on_vertex_done(vid, rows, st)
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                out_ex.close(error=exc)
                if adaptive is not None \
                        and adaptive.note_vertex_error(vid, exc):
                    return  # absorbed: a replaced vertex / speculation loser
                with lock:
                    errors.append(exc)
                if cancel_token is not None and not cancel_token.is_set():
                    # wake sibling vertices blocked on other exchanges
                    cancel_token.cancel(f"vertex {vid} failed: {exc}")
            finally:
                close_vertex_frame(frame)

        if adaptive is not None:
            adaptive.begin(dag, ctx, exchanges, lane_spec,
                           run_vertex=run_vertex, cancel_token=cancel_token)
        futures = [pool.submit(run_vertex, vid) for vid in dag.topo_order()]
        try:
            for fut in futures:
                fut.result()
            if adaptive is not None:
                # adaptive vertices (collapse targets, sub-lane consumers,
                # speculation clones) run on their own threads; the query is
                # done only when they are
                adaptive.wait()
            if errors:
                raise self._primary_error(errors)
            return exchanges[dag.root].read_all()
        finally:
            if adaptive is not None:
                adaptive.finish()
            # published exchanges may still feed attached consumers of other
            # queries: retire them through the registry, which discards when
            # the last consumer releases; the scratch dir (spilled chunks)
            # is likewise cleaned up only after the last of them releases
            state = {"held": 1}

            def released_one() -> None:
                with lock:
                    state["held"] -= 1
                    last = state["held"] == 0
                if last:
                    excfg.cleanup()

            for vid, ex in exchanges.items():
                key = published.get(vid)
                if key is None:
                    ex.discard()
                else:
                    with lock:
                        state["held"] += 1
                    if registry.retire(key, ex, on_final=released_one):
                        released_one()
            released_one()

    @staticmethod
    def _shareable_vertices(dag: TaskDAG, ctx: ExecContext,
                            lane_spec) -> Dict[str, tuple]:
        """Scan vertices eligible for the serving tier's shared-scan path.

        A vertex qualifies when it is a pure fused scan pipeline — exactly
        one managed-table :class:`~..optimizer.plan.Scan`, no federated
        scans, no runtime-filter inputs, no upstream edges — writing a
        plain (unpartitioned) exchange.  The registry key combines the
        vertex plan's ``key()`` (table, columns, pushed/partition filters,
        min write-ID), the query parameters and the table's ``(hwm,
        invalid)`` write-ID state, so only transactionally identical scans
        ever share an exchange."""
        out: Dict[str, tuple] = {}
        for vid, v in dag.vertices.items():
            if v.deps or (vid in lane_spec and vid != dag.root):
                continue
            nodes = list(P.walk_plan(v.plan))
            scans = [n for n in nodes if isinstance(n, P.Scan)]
            if len(scans) != 1:
                continue
            if any(isinstance(n, (P.FederatedScan, MaterializedNode))
                   for n in nodes):
                continue
            sc = scans[0]
            if getattr(sc.table, "handler", None) or sc.runtime_filters:
                continue
            try:
                wl = ctx.widlist(sc.table.name)
            except Exception:
                continue
            key = (v.plan.key(), repr(ctx.params), ctx.engine,
                   bool(ctx.config.get("keep_acid_cols")),
                   sc.table.name, wl.hwm, frozenset(wl.invalid))
            out[vid] = (key, sc.table.name)
        return out

    @staticmethod
    def _primary_error(errors: List[BaseException]) -> BaseException:
        # surface the root cause, not a secondary cancellation triggered by
        # the failure-propagation cancel above
        from .cancel import QueryCancelledError

        for exc in errors:
            if not isinstance(exc, QueryCancelledError):
                return exc
        return errors[0]

    # ------------------------------------------------------------ barrier
    def _execute_barrier(self, dag: TaskDAG, ctx: ExecContext, pool,
                         on_vertex_done, on_root_chunk) -> VectorBatch:
        cancel_token = getattr(ctx, "cancel_token", None)
        trace = getattr(ctx, "trace", None)
        results: Dict[str, VectorBatch] = {}
        done: Set[str] = set()
        order = dag.topo_order()
        pending: Dict[str, Future] = {}
        durations: List[float] = []
        lock = make_lock("dag.metrics")

        def run_vertex(vid: str) -> VectorBatch:
            # the vertex start is a cancellation point; operator loops also
            # observe the token at every batch boundary, so even speculated
            # clones of a cancelled vertex stop within one morsel
            if cancel_token is not None:
                cancel_token.check()
            if vid in self.injected_delays:
                time.sleep(self.injected_delays[vid])
            if self.vertex_delay:
                time.sleep(self.vertex_delay)
            v = dag.vertices[vid]
            for mn in _walk_materialized(v.plan):
                mn.batch = results[mn.tag]
            t0 = clock.perf_counter()
            ex = _VertexExecutor(ctx)
            out = ex.execute(v.plan)
            dt = clock.perf_counter() - t0
            if trace is not None:
                # barrier mode has no exchanges: the whole wall is compute
                trace.add_vertex(vid, t0, dt, rows=out.num_rows)
            with lock:
                durations.append(dt)
                self.metrics.append(VertexMetrics(vid, out.num_rows, dt))
            return out

        remaining = list(order)
        while remaining or pending:
            if cancel_token is not None:
                cancel_token.check()
            # launch every vertex whose deps are satisfied
            for vid in list(remaining):
                v = dag.vertices[vid]
                if all(d in done for d in v.deps):
                    pending[vid] = pool.submit(run_vertex, vid)
                    remaining.remove(vid)
            if not pending:
                raise RuntimeError("DAG deadlock (cyclic dependencies?)")
            completed, _ = wait(list(pending.values()), return_when=FIRST_COMPLETED,
                                timeout=self._speculation_timeout(durations))
            if not completed and self.speculative:
                # straggler: speculatively clone the slowest pending vertex
                vid = next(iter(pending))
                self.injected_delays.pop(vid, None)
                spec = pool.submit(run_vertex, vid)
                old = pending[vid]
                pending[vid] = spec
                old.cancel()
                with lock:
                    self.metrics.append(VertexMetrics(vid, -1, 0.0, True))
                continue
            for vid in list(pending):
                fut = pending[vid]
                if fut.done():
                    results[vid] = fut.result()
                    done.add(vid)
                    del pending[vid]
                    if on_vertex_done is not None:
                        # barrier mode buffers each vertex's whole output
                        on_vertex_done(vid, results[vid].num_rows, {
                            "spilled_rows": 0, "spilled_bytes": 0,
                            "peak_buffered_rows": results[vid].num_rows,
                        })
        root = results[dag.root]
        if on_root_chunk is not None:
            for chunk in root.iter_chunks():
                on_root_chunk(chunk)
        return root

    def _speculation_timeout(self, durations: List[float]) -> Optional[float]:
        if not self.speculative or not durations:
            return None
        med = sorted(durations)[len(durations) // 2]
        return max(med * self.straggler_factor, 0.05)


class _VertexExecutor(Executor):
    def _stream_materializednode(self, node: MaterializedNode):
        if node.source is not None:  # pipelined: replay the edge's exchange
            from .shuffle import ShuffleWriter, partition_select

            if node.sub_lane is not None:
                # adaptive hot-lane split: one round-robin sub-lane of a
                # split shuffle lane
                yield from node.source.sub_lane_reader(node.sub_lane)
                return
            if node.partition is not None:
                if isinstance(node.source, ShuffleWriter):
                    yield from node.source.lane_reader(node.partition)
                    return
                # conflicting-spec fallback: full stream, filtered per chunk
                for chunk in node.source.reader():
                    self._checkpoint()  # cancel point per replayed chunk
                    yield partition_select(
                        chunk, node.partition_keys, node.partition,
                        node.num_partitions, self.ctx.engine)
                return
            yield from node.source.reader()
            return
        assert node.batch is not None, f"edge {node.tag} not materialized"
        if node.partition is not None:  # barrier mode: filter to the lane
            from .shuffle import partition_select

            yield from self._emit(partition_select(
                node.batch, node.partition_keys, node.partition,
                node.num_partitions, self.ctx.engine))
            return
        yield from self._emit(node.batch)
