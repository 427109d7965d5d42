"""Staged query pipeline (paper §2, Figure 2 — the query driver).

``Session`` used to fuse planning and execution into a single blocking call;
this module carves that path into explicit, individually testable stages:

    Parse -> Bind -> CacheProbe -> MVRewrite -> Optimize -> Compile -> Execute

A typed :class:`QueryContext` flows through the stages; each stage's
wall-time is recorded and surfaced in ``QueryResult.info['stage_times_ms']``
and via ``EXPLAIN ANALYZE``.

The module also hosts :class:`PlanCache` (prepared-statement support): the
Bind stage probes it by statement text, and the Optimize stage fills it with
the optimized logical plan, so ``PreparedStatement.execute()`` skips
parse + bind + optimize on re-execution.  Plans are parameter-generic —
``?`` placeholders stay :class:`repro_torch.core.sql.ast.Param` nodes in the plan
and bind to values only inside ``ExecContext`` — while the *result* cache key
includes the parameter values.
"""
from __future__ import annotations

import copy
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .config_keys import PLANNING_KEYS
from .optimizer import plan as P
from .optimizer.mv_rewrite import MVRewriter
from .optimizer.rules import Optimizer, OptimizerConfig
from .optimizer.semijoin import SemijoinConfig, insert_semijoin_reducers
from .optimizer.shared_work import find_shared_subplans
from ..analysis.lockdep import make_lock
from ..analysis.plan_validator import maybe_validate_dag
from .obs import clock
from .obs.trace import (QueryTrace, bind_trace, emit_event, make_span,
                        restore_trace, tracing_enabled)
from .runtime.dag import DAGScheduler, compile_dag, describe_exchanges
from .schema import annotate_plan
from .runtime.exec import MemoryPressureError
from .runtime.scheduler import stream_batch_rows
from .runtime.vector import VectorBatch
from .sql import ast as A
from .sql.binder import Binder
from .sql.parser import parse


# ===========================================================================
# prepared-statement plan cache
# ===========================================================================
# config keys that change the shape of the optimized plan; part of the cache
# key so sessions with different planning configs don't share plans.
# Derived from the central registry (repro_torch.core.config_keys) — a key added
# there with planning=True joins the cache key automatically, so this tuple
# can no longer drift from the declared set (the REP001 invariant).
_PLANNING_KEYS = PLANNING_KEYS


@dataclass
class PlanCacheEntry:
    stmt: object                 # parsed AST (needed for re-optimization)
    plan: P.PlanNode             # pristine optimized plan (deep-copied out)
    bound_key: str               # bound-plan key = result-cache identity
    tables: List[str]            # participating tables (cache validation)
    snapshot: Dict[str, Tuple] = field(default_factory=dict)
    info: Dict[str, object] = field(default_factory=dict)  # planning info
    row_counts: Dict[str, float] = field(default_factory=dict)  # at plan time
    uses_mv: bool = False        # MV-rewritten plans validate strictly
    created_at: float = field(default_factory=time.time)
    hits: int = 0


def table_state(hms, tables) -> Dict[str, Tuple]:
    """Per-table (hwm, invalid WriteIds): the transactional identity used to
    validate both the result cache and the plan cache.  Tables the metastore
    does not know (catalog-mounted external tables, §6) have no WriteId
    state and map to a constant — the warehouse cannot observe remote
    changes, so they neither validate nor invalidate an entry."""
    snap = hms.get_snapshot()
    out: Dict[str, Tuple] = {}
    for t in tables:
        try:
            wl = hms.writeid_list(t, snap)
            out[t] = (wl.hwm, wl.invalid)
        except KeyError:
            out[t] = (0, frozenset())
    return out


def table_row_counts(hms, tables) -> Dict[str, float]:
    """Per-table optimizer row counts (the statistics plans are costed on)."""
    out = {}
    for t in tables:
        try:
            out[t] = float(hms.get_stats(t).row_count)
        except KeyError:
            out[t] = 0.0
    return out

# a cached plan's cost-based choices (join order, broadcast sides, semijoin
# reducers) are considered stale once any base table's row count shifts by
# more than this factor in either direction
PLAN_DRIFT_FACTOR = 2.0


class PlanCache:
    """Caches optimized logical plans, keyed like the query-result cache:
    by resolved statement text plus the planning-relevant session config.

    Entries are validated against the participating tables' WriteId state.
    MV-rewritten plans drop on *any* base-table write — a stale MV-scan plan
    would silently return stale data.  Plain plans only embed cost-based
    decisions (scans re-resolve data at execution time), so they survive
    writes and drop only when a table's row count drifts by more than
    ``PLAN_DRIFT_FACTOR`` from what the plan was costed on — the point at
    which join order / broadcast choices deserve re-optimization (§4.2)."""

    def __init__(self, max_entries: int = 128):
        self.max_entries = max_entries
        self._lock = make_lock("plan_cache")
        self._entries: Dict[str, PlanCacheEntry] = {}
        self.stats = {"hits": 0, "misses": 0}

    @staticmethod
    def key_of(sql: str, config: dict) -> Optional[str]:
        if not sql or not sql.strip():
            return None
        cfg = "|".join(f"{k}={config.get(k)!r}" for k in _PLANNING_KEYS)
        return f"{' '.join(sql.split())}#{cfg}"

    def get(self, key: Optional[str], hms=None) -> Optional[PlanCacheEntry]:
        if key is None:
            return None
        with self._lock:
            entry = self._entries.get(key)
        if entry is None:
            self.stats["misses"] += 1
            return None
        if hms is not None:
            current = table_state(hms, entry.snapshot)
            if current != entry.snapshot:
                if entry.uses_mv or self._drifted(hms, entry):
                    with self._lock:
                        self._entries.pop(key, None)
                    self.stats["misses"] += 1
                    return None
                # plan survives the write: adopt the new WriteId state so the
                # next hit skips the drift re-check (row_counts keeps the
                # plan-time baseline the drift factor is measured against)
                entry.snapshot = current
        entry.hits += 1
        self.stats["hits"] += 1
        return entry

    @staticmethod
    def _drifted(hms, entry: PlanCacheEntry) -> bool:
        """Did any base table's row count shift past the drift factor?"""
        try:
            current = table_row_counts(hms, entry.row_counts)
        except Exception:  # noqa: BLE001 - e.g. table vanished mid-check
            return True
        for t, base in entry.row_counts.items():
            cur = current.get(t, 0.0)
            if base <= 0.0:
                if cur > 0.0:
                    return True  # empty -> populated: unbounded drift
            elif cur > base * PLAN_DRIFT_FACTOR or cur < base / PLAN_DRIFT_FACTOR:
                return True
        return False

    def put(self, key: Optional[str], entry: PlanCacheEntry) -> None:
        if key is None:
            return
        with self._lock:
            self._entries[key] = entry
            if len(self._entries) > self.max_entries:
                victims = sorted(self._entries.items(),
                                 key=lambda kv: (kv[1].hits, kv[1].created_at))
                for k, _ in victims[: len(self._entries) - self.max_entries]:
                    self._entries.pop(k, None)

    def invalidate_all(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


# ===========================================================================
# query context
# ===========================================================================
@dataclass
class QueryContext:
    """Typed state flowing through the pipeline stages."""

    session: object                       # repro_torch.core.session.Session
    sql: str = ""                         # statement text ("" when unknown)
    stmt: object = None                   # parsed AST (Select | SetOp)
    params: Tuple = ()                    # qmark parameter values
    config: dict = field(default_factory=dict)
    info: dict = field(default_factory=dict)

    # planning state
    plan: Optional[P.PlanNode] = None
    plan_pretty: str = ""                 # captured before DAG compilation
    bound_key: str = ""                   # parameter-generic plan identity
    result_key: str = ""                  # + parameter values
    tables: List[str] = field(default_factory=list)
    from_plan_cache: bool = False
    plan_cache_key: Optional[str] = None

    # result-cache state
    cacheable: bool = False
    filling: bool = False

    # execution state
    exec_ctx: object = None
    dag: object = None
    batch: Optional[VectorBatch] = None

    # async-handle state (None on the synchronous path)
    task: object = None                   # runtime.scheduler.QueryTask
    slot: object = None                   # WLM slot admitted by the scheduler
    qid: str = ""                         # query id ("" -> allocate one)
    cancel_token: object = None           # runtime.cancel.CancelToken

    # observability (PR 10): the query's QueryTrace, resolved once by
    # QueryPipeline.run (None = tracing off)
    trace: object = None

    # bookkeeping
    stage_times: Dict[str, float] = field(default_factory=dict)
    finished: bool = False                # short-circuits remaining stages


# ===========================================================================
# stages
# ===========================================================================
class Stage:
    name = "stage"

    def run(self, q: QueryContext) -> None:
        raise NotImplementedError


class ParseStage(Stage):
    name = "parse"

    def run(self, q: QueryContext) -> None:
        if q.stmt is None:
            q.stmt = parse(q.sql)
        n = A.count_params(q.stmt)
        if n != len(q.params):
            raise ValueError(
                f"statement has {n} parameter placeholder(s) but "
                f"{len(q.params)} value(s) were supplied"
            )


class BindStage(Stage):
    """Name resolution + subquery unnesting; also probes the plan cache —
    a hit yields the fully optimized plan and skips MVRewrite/Optimize."""

    name = "bind"

    def run(self, q: QueryContext) -> None:
        s = q.session
        q.plan_cache_key = PlanCache.key_of(q.sql, q.config)
        entry = s.wh.plan_cache.get(q.plan_cache_key, s.hms)
        if entry is not None:
            q.plan = copy.deepcopy(entry.plan)  # Compile mutates the tree
            q.bound_key = entry.bound_key
            q.tables = list(entry.tables)
            q.from_plan_cache = True
            q.info.update(entry.info)  # mv_used / semijoin_reducers / ...
            q.info["plan_cache_hit"] = True
            return
        q.plan = Binder(s.hms, catalogs=getattr(s.wh, "catalogs", None)).bind(q.stmt)
        q.bound_key = q.plan.key()
        q.tables = [sc.table.name for sc in P.walk_plan(q.plan)
                    if isinstance(sc, (P.Scan, P.FederatedScan))]


class CacheProbeStage(Stage):
    """Query-result cache (§4.3), probed on the bound-plan identity so a hit
    skips optimization entirely.  Parameter values are part of the key."""

    name = "cache_probe"

    def run(self, q: QueryContext) -> None:
        s, cfg = q.session, q.config
        # mv_rewriting is part of the identity: an MV-rewritten execution may
        # legitimately serve stale-within-window data that a non-MV session
        # must never be handed from the cache
        q.result_key = q.bound_key + f"|mv={bool(cfg['mv_rewriting'])}" + (
            f"|params={q.params!r}" if q.params else "")
        # catalog-mounted external tables have no WriteId identity, so the
        # warehouse cannot detect remote changes: never cache their results
        # (detected from the plan — no extra metastore roundtrips)
        uses_catalog = any(
            isinstance(n, P.FederatedScan)
            and (n.table.handler or "").startswith("catalog:")
            for n in P.walk_plan(q.plan)
        )
        q.cacheable = bool(
            cfg["result_cache"] and cfg.get("serving.result_cache", True)
            and is_cacheable(q.stmt) and q.tables
            and not uses_catalog
        )
        if not q.cacheable:
            return
        hit = s.wh.result_cache.lookup(q.result_key, s.hms, q.tables)
        if hit is not None:
            q.batch = hit
            q.info["cache_hit"] = True
            q.finished = True
            return
        q.filling = s.wh.result_cache.begin_pending(q.result_key, s.hms,
                                                    q.tables)
        if not q.filling:
            # someone else is filling; wait behind their pending entry
            hit = s.wh.result_cache.lookup(q.result_key, s.hms, q.tables)
            if hit is not None:
                q.batch = hit
                q.info.update(cache_hit=True, pending_wait=True)
                q.finished = True


class MVRewriteStage(Stage):
    name = "mv_rewrite"

    def run(self, q: QueryContext) -> None:
        if q.from_plan_cache or not q.config["mv_rewriting"]:
            return
        hit = MVRewriter(q.session.hms).try_rewrite(q.plan)
        if hit is not None:
            q.plan, mv_name, mode = hit
            q.info["mv_used"] = mv_name
            q.info["mv_mode"] = mode


class OptimizeStage(Stage):
    """Rule/cost optimization + semijoin reducers + federation pushdown;
    fills the plan cache with the pristine optimized plan."""

    name = "optimize"

    def __init__(self, runtime_overrides: Optional[dict] = None):
        # §4.2 re-optimization threads captured actual cardinalities in here
        self.runtime_overrides = runtime_overrides

    def run(self, q: QueryContext) -> None:
        s, cfg = q.session, q.config
        if q.from_plan_cache:
            return
        opt = Optimizer(s.hms, optimizer_config(cfg),
                        runtime_overrides=self.runtime_overrides,
                        handler_resolver=s.wh.resolve_handler)
        q.plan = opt.optimize(q.plan)
        if cfg["semijoin_reduction"]:
            added = insert_semijoin_reducers(q.plan, opt.cost_model,
                                             SemijoinConfig(enabled=True))
            q.info["semijoin_reducers"] = added
        q.plan, pushed = s._push_federated(q.plan, cfg)
        if pushed:
            q.info["federated_pushdown"] = pushed
        if q.plan_cache_key is not None:
            planning_info = {k: q.info[k] for k in
                             ("mv_used", "mv_mode", "semijoin_reducers",
                              "federated_pushdown") if k in q.info}
            s.wh.plan_cache.put(q.plan_cache_key, PlanCacheEntry(
                stmt=q.stmt,
                plan=copy.deepcopy(q.plan),
                bound_key=q.bound_key,
                tables=list(q.tables),
                snapshot=table_state(s.hms, q.tables),
                info=planning_info,
                row_counts=table_row_counts(s.hms, q.tables),
                uses_mv="mv_used" in q.info,
            ))


class CompileStage(Stage):
    """Shared-work detection (§4.5) + Tez-style task-DAG compilation."""

    name = "compile"

    def run(self, q: QueryContext) -> None:
        s, cfg = q.session, q.config
        ctx = s._make_ctx(cfg, params=q.params, cancel_token=q.cancel_token)
        # fan federated scans out over their connectors' splits (compile
        # time so cached plans re-enumerate fresh splits per execution)
        q.plan = s._expand_federated(q.plan, cfg)
        if cfg["shared_work"]:
            # detected before partition expansion: per-partition clone keys
            # embed their lane and must never be mistaken for shared subplans
            ctx.shared_keys = find_shared_subplans(q.plan)
            q.info["shared_subplans"] = len(ctx.shared_keys)
        # partitioned shuffle service: clone pipeline-breaker consumers per
        # lane (compile time, after the plan-cache deepcopy, so cached plans
        # re-expand under the session's current shuffle.partitions); adaptive
        # compile-time decisions (co-partition shuffle elision) land in
        # q.info["adaptive"], where the runtime replanner appends later
        adaptive_events = q.info.setdefault("adaptive", [])
        q.plan = s._expand_shuffle(q.plan, cfg, events=adaptive_events)
        if not adaptive_events:
            del q.info["adaptive"]
        # (re)infer the typed schema contract on the expanded tree: EXPLAIN
        # shows per-node schemas, compile copies them onto edge placeholders
        # and the scheduler declares them on exchanges
        annotate_plan(q.plan)
        q.plan_pretty = q.plan.pretty()  # before compile_dag mutates the tree
        q.dag = compile_dag(q.plan)
        # structural validation (debug.validate_plans / REPRO_VALIDATE_PLANS):
        # catches malformed wiring — and, via the plan-cache aliasing check,
        # a compile that mutated a cached pristine plan in place
        maybe_validate_dag(q.dag, cfg, plan_cache=s.wh.plan_cache)
        q.info["dag_edges"] = q.dag.edge_summary()
        q.info["exchanges"] = [ln.strip() for ln in describe_exchanges(q.dag)]
        # observability wiring, resolved once per query: the DAG scheduler
        # propagates these onto every exchange; ExecContext.kernel and the
        # federated streamer test them per call site
        ctx.trace = q.trace
        obs = getattr(s.wh, "obs", None)
        ctx.metrics = obs.metrics if obs is not None else None
        q.exec_ctx = ctx


class ExecuteStage(Stage):
    """WLM admission (§5.2), scheduled execution (LLAP or containers),
    re-optimization on memory pressure (§4.2), result streaming to an async
    handle, result-cache fill.

    On the synchronous path this stage admits (and releases) its own WLM
    slot, raising when the pool is saturated.  On the async path the
    :class:`~repro_torch.core.runtime.scheduler.QueryScheduler` already queued the
    handle through blocking admission and owns the slot's lifecycle; the
    stage only consumes ``q.slot``.
    """

    name = "execute"

    def run(self, q: QueryContext) -> None:
        s, cfg = q.session, q.config
        qid = q.qid or f"q{next(s.wh._qid)}"
        slot = q.slot
        own_slot = q.task is None
        try:
            if own_slot:
                with make_span(q.trace, "wlm:admission_wait", "wlm"):
                    slot = s.wh.wlm.admit(qid, cfg.get("user"),
                                          cfg.get("application"))
            if slot is not None:
                q.info["wlm_pool"] = slot.pool
            q.batch = self._run_dag(q, qid, slot)
            if q.task is not None:
                # fallback for paths that produced no live chunk stream (a
                # barrier-mode run, or a consumer that attached late): the
                # emit path already claimed the stream otherwise, so this
                # first-wins publish never double-streams
                q.task.stream.publish(q.batch, stream_batch_rows(cfg),
                                      q.cancel_token)
            if q.cacheable and q.filling:
                s.wh.result_cache.fill(q.result_key, q.batch)
            q.info["cache_hit"] = False
        finally:
            if own_slot and slot is not None:
                s.wh.wlm.release(qid)

    def _run_dag(self, q: QueryContext, qid: str, slot) -> VectorBatch:
        s, cfg, ctx = q.session, q.config, q.exec_ctx
        # adaptive execution (pipelined mode only): replan the running DAG
        # from live lane telemetry; decisions land in q.info["adaptive"]
        # (EXPLAIN ANALYZE) and stream to poll() through note_adaptive
        adaptive = None
        pipelined = bool(cfg.get("exchange.pipeline", True)) \
            and not cfg["speculative_execution"]
        if pipelined and bool(cfg.get("adaptive.enabled", True)):
            from .runtime.adaptive import AdaptiveManager

            events = q.info.setdefault("adaptive", [])
            if q.task is not None:
                for ev in events:  # compile-time decisions (elision)
                    q.task.note_adaptive(ev)
            adaptive = AdaptiveManager(
                cfg, events=events,
                on_event=(q.task.note_adaptive if q.task is not None
                          else None),
                trace=q.trace)
        sched = DAGScheduler(
            pool=s.wh.llap.executors if cfg["llap"] else None,
            speculative=cfg["speculative_execution"],
            vertex_delay=float(cfg.get("debug_vertex_delay_s", 0.0) or 0.0),
            adaptive=adaptive,
        )
        if q.task is not None:
            q.task.note_vertices_total(len(q.dag.vertices))

        def on_vertex(vid, rows, stats):
            if q.task is not None:
                q.task.note_vertex_done(vid, stats)
            if slot is not None:
                s.wh.wlm.update_metrics(qid, rows_produced=rows)
            if stats.get("lanes"):
                # per-lane row counts per partitioned edge: skew shows up in
                # EXPLAIN ANALYZE (and through poll() on the async path)
                q.info.setdefault("exchange_lanes", {})[vid] = [
                    lane["rows"] for lane in stats["lanes"]
                ]

        def on_root_chunk(chunk):
            # thread root-vertex morsels to the handle's stream while the
            # DAG is still running: first rows reach fetch_stream() before
            # upstream vertices finish
            if q.task is not None:
                q.task.stream.emit(chunk, stream_batch_rows(cfg),
                                   q.cancel_token)

        try:
            batch = sched.execute(q.dag, ctx, on_vertex_done=on_vertex,
                                  on_root_chunk=on_root_chunk)
            if not q.info.get("adaptive", True):
                del q.info["adaptive"]  # no adaptive decision fired
            s._persist_runtime_stats(q.plan, ctx)
            if any(sched.shared_scan_stats.values()):
                q.info["shared_scans"] = dict(sched.shared_scan_stats)
                if q.task is not None:
                    q.task.note_shared_scans(sched.shared_scan_stats)
            return batch
        except MemoryPressureError as mem_err:
            mode = cfg["reopt_mode"]
            if mode == "off":
                raise
            if q.task is not None:
                # a live consumer may hold a partial chunk prefix; fail the
                # stream rather than splicing re-executed output onto it
                # (result()/replay consumers get the re-executed result)
                q.task.stream.abort_live(mem_err)
            q.info["reexecuted"] = True
            q.info["reopt_mode"] = mode
            emit_event(q.trace, "reopt:reexecute", "adaptive", mode=mode)
            s._persist_runtime_stats(q.plan, ctx)
            # re-executions run with materialized (barrier) exchanges: the
            # pressure signal may have come from a spill-disabled exchange
            # overflow, which an unchanged budget would deterministically
            # hit again
            if mode == "overlay":
                # §4.2 overlay: re-run every re-execution with config overrides
                cfg2 = {**cfg, **cfg.get("overlay", {}), "reopt_mode": "off",
                        "exchange.pipeline": False}
                plan2, _ = s._plan_query(q.stmt, config=cfg2)
            else:
                # §4.2 reoptimize: feed captured actual cardinalities back in;
                # the failure also teaches the planner the broadcast budget
                cfg2 = {
                    **cfg,
                    "reopt_mode": "off",
                    "exchange.pipeline": False,
                    "broadcast_threshold_rows": min(
                        cfg["broadcast_threshold_rows"],
                        float(cfg["mapjoin_max_rows"]),
                    ),
                }
                plan2, _ = s._plan_query(
                    q.stmt, runtime_overrides=dict(ctx.op_stats), config=cfg2
                )
            ctx2 = s._make_ctx(cfg2, params=q.params,
                               cancel_token=q.cancel_token)
            ctx2.trace = q.trace
            ctx2.metrics = ctx.metrics
            plan2 = s._expand_federated(plan2, cfg2)
            if cfg2["shared_work"]:
                ctx2.shared_keys = find_shared_subplans(plan2)
            plan2 = s._expand_shuffle(plan2, cfg2)
            annotate_plan(plan2)
            dag2 = compile_dag(plan2)
            # §4.2 re-optimized plans never came from the cache, but their
            # rewritten shuffle/split wiring is exactly where structural
            # bugs would hide — validate them like first compiles
            maybe_validate_dag(dag2, cfg2, plan_cache=s.wh.plan_cache)
            if q.task is not None:
                q.task.note_vertices_total(len(dag2.vertices))
            return DAGScheduler(
                pool=s.wh.llap.executors if cfg2["llap"] else None,
                vertex_delay=float(cfg.get("debug_vertex_delay_s", 0.0) or 0.0),
            ).execute(dag2, ctx2, on_vertex_done=on_vertex)


# ===========================================================================
# the pipeline
# ===========================================================================
DEFAULT_STAGES: Tuple[Stage, ...] = (
    ParseStage(), BindStage(), CacheProbeStage(), MVRewriteStage(),
    OptimizeStage(), CompileStage(), ExecuteStage(),
)

# serving tier: the async scheduler probes the result cache *before* WLM
# admission (a hit is served without a slot and without execution), then
# resumes the same QueryContext through the remaining stages on a miss
PRE_ADMISSION_STAGES: Tuple[Stage, ...] = (
    ParseStage(), BindStage(), CacheProbeStage(),
)
POST_PROBE_STAGES: Tuple[Stage, ...] = (
    MVRewriteStage(), OptimizeStage(), CompileStage(), ExecuteStage(),
)

def plan_only_stages(runtime_overrides: Optional[dict] = None):
    """Bind + rewrite + optimize, no caches / compile / execute — the shape
    used by MV maintenance and §4.2 re-planning."""
    return (BindStage(), MVRewriteStage(), OptimizeStage(runtime_overrides))


class QueryPipeline:
    """Runs a :class:`QueryContext` through the staged query path."""

    def __init__(self, session, stages: Tuple[Stage, ...] = DEFAULT_STAGES):
        self.session = session
        self.stages = stages

    def run(self, q: QueryContext) -> QueryContext:
        # resolve the query's trace exactly once (lockdep factory pattern):
        # the async scheduler already allocated one on the QueryTask when
        # obs.tracing was on at submit; EXPLAIN ANALYZE and sync callers
        # force/enable it via config, in which case the pipeline allocates
        # (and hands the task the trace so the warehouse stores it)
        if q.trace is None and q.task is not None:
            q.trace = q.task.trace
        if q.trace is None and tracing_enabled(q.config):
            if not q.qid:
                q.qid = f"q{next(self.session.wh._qid)}"
            q.trace = QueryTrace(q.qid, q.sql)
            if q.task is not None:
                q.task.trace = q.trace
        trace = q.trace
        # the stages' work on this thread (the result cache's wait, a
        # kernel call outside the DAG) records on the query's trace
        prev = bind_trace(trace) if trace is not None else None
        t0 = time.perf_counter()
        try:
            for stage in self.stages:
                if q.finished:
                    break
                # one pair of clock reads gives stage_times_ms and the
                # stage:* span, so the two agree exactly
                t = clock.perf_counter()
                cpu = clock.thread_time() if trace is not None else 0.0
                try:
                    stage.run(q)
                finally:
                    if trace is not None:
                        cpu = clock.thread_time() - cpu
                    t_end = clock.perf_counter()
                    if trace is not None:
                        trace.add_span(f"stage:{stage.name}", "stage", t,
                                       t_end, cpu_ms=cpu * 1e3)
                q.stage_times[stage.name] = (
                    q.stage_times.get(stage.name, 0.0) + t_end - t)
        except Exception:
            if q.cacheable and q.filling:
                self.session.wh.result_cache.cancel_pending(q.result_key)
            raise
        finally:
            if trace is not None:
                restore_trace(prev)
        q.info["stage_times_ms"] = {
            k: round(v * 1e3, 3) for k, v in q.stage_times.items()
        }
        q.info["seconds"] = time.perf_counter() - t0
        return q


def optimizer_config(cfg: dict) -> OptimizerConfig:
    return OptimizerConfig(
        cbo=cfg["cbo"],
        pushdown=cfg["pushdown"],
        prune_columns=cfg["prune_columns"],
        join_reorder=cfg["join_reorder"],
        transitive_inference=cfg["transitive_inference"],
        broadcast_threshold_rows=cfg["broadcast_threshold_rows"],
        partition_pruning=cfg["partition_pruning"],
    )


def is_cacheable(stmt) -> bool:
    """No non-deterministic or runtime-constant functions (§4.3)."""
    bad = A.NON_DETERMINISTIC_FUNCS | A.RUNTIME_CONSTANT_FUNCS

    def scan_sel(s) -> bool:
        if isinstance(s, A.SetOp):
            return scan_sel(s.left) and scan_sel(s.right)
        if not isinstance(s, A.Select):
            return True
        exprs = [e for e, _ in s.projections]
        exprs += [x for x in (s.where, s.having) if x is not None]
        exprs += [e for e, _ in s.order_by] + list(s.group_by)
        for e in exprs:
            for node in A.walk(e):
                if isinstance(node, A.Func) and node.name in bad:
                    return False
                if isinstance(node, A.SubqueryExpr) and not scan_sel(node.query):
                    return False
        if isinstance(s.from_, A.SubqueryRef) and not scan_sel(s.from_.query):
            return False
        return True

    return scan_sel(stmt)
