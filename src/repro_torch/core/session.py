"""HiveServer2 analogue: the query driver (paper §2, Figure 2).

``Warehouse`` owns cluster-wide state (metastore, LLAP daemon, storage
handlers, workload manager, query-result cache, and the async
``QueryScheduler`` worker pool); ``Session`` executes SQL:

    parse -> bind (logical plan) -> [result cache probe] -> [MV rewrite]
         -> rule/cost optimization -> semijoin reducers -> shared-work marks
         -> task-DAG compile -> scheduled execution (LLAP or containers)
         -> [re-optimization on runtime errors] -> cache fill

DML statements (INSERT/UPDATE/DELETE/MERGE) run under single-statement ACID
transactions (§3.2); materialized views rebuild incrementally when possible
(§4.4); resource-plan DDL administers the workload manager (§5.2).

``Session.execute`` drives the pipeline synchronously; ``Session.submit``
hands the statement to the warehouse scheduler and returns a
:class:`~repro_torch.core.runtime.scheduler.QueryTask` that the client-side
``QueryHandle`` polls, streams from, or cancels.
"""
from __future__ import annotations

import itertools
import os
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..kernels.registry import VALID_ENGINES as _VALID_ENGINES
from .acid import AcidTable, PlainIO
from .config_keys import DEFAULT_CONFIG, SessionConfig
from .compaction import CompactionConfig, compact_partition, maybe_compact
from .federation.catalog import CatalogRegistry
from .federation.datasource import expand_federated_splits, negotiate_federated
from .federation.druid import DruidHandler
from .federation.handler import HandlerRegistry
from .federation.jdbc import JdbcHandler
from .federation.memtable import MemTableHandler
from .metastore import Metastore, TxnAborted, WriteConflict
from .obs import WarehouseObs
from .obs.trace import emit_event
from .optimizer import plan as P
from .serving import ResultCacheServer, SharedScanRegistry
from .pipeline import (
    POST_PROBE_STAGES,
    PRE_ADMISSION_STAGES,
    PlanCache,
    QueryContext,
    QueryPipeline,
    is_cacheable,
    plan_only_stages,
)
from .runtime.dag import compile_dag, describe_exchanges
from .schema import annotate_plan
from .runtime.exec import ExecContext, Executor, eval_expr
from .runtime.llap import LlapDaemon, LlapIO
from .runtime.scheduler import QueryScheduler, QueryTask
from .runtime.vector import ROWID_COL, WRITEID_COL, VectorBatch
from .runtime.wlm import WorkloadManager
from .sql import ast as A
from .sql.binder import Binder, _classify_join_condition
from .sql.parser import parse, parse_many

# DEFAULT_CONFIG now lives in repro_torch.core.config_keys (the REP001
# registry): every knob is declared there once with its default, type,
# and planning flag; this module re-exports the derived dict for
# backwards compatibility (repro_torch.api.connection and tests import it).


class QueryResult:
    def __init__(self, batch: VectorBatch, info: Optional[dict] = None):
        self.batch = batch
        self.info = info or {}

    @property
    def rows(self) -> List[tuple]:
        return self.batch.to_rows()

    @property
    def num_rows(self) -> int:
        return self.batch.num_rows

    def __repr__(self):
        return f"QueryResult({self.num_rows} rows, info={self.info})"


class Warehouse:
    """Cluster-scoped state (one per deployment)."""

    def __init__(self, warehouse_dir: str, llap_cache_bytes: int = 256 << 20,
                 llap_executors: int = 4, query_workers: int = 8,
                 result_cache_bytes: int = 64 << 20):
        self.dir = warehouse_dir
        os.makedirs(warehouse_dir, exist_ok=True)
        self.hms = Metastore(warehouse_dir)
        self.llap = LlapDaemon(cache_bytes=llap_cache_bytes,
                               num_executors=llap_executors)
        self.handlers = HandlerRegistry()
        self.handlers.register(DruidHandler(), self.hms)
        self.handlers.register(JdbcHandler(), self.hms)
        self.handlers.register(MemTableHandler(), self.hms)
        # federated catalogs (§6): whole external systems mounted at once,
        # re-instantiated from metastore persistence on reopen
        self.catalogs = CatalogRegistry(self.hms)
        # observability (PR 10): metrics registry + query log + trace store;
        # created before the serving tier/WLM so they register counters on it
        self.obs = WarehouseObs()
        # serving tier: byte-bounded LRFU result cache + shared-scan registry
        self.result_cache = ResultCacheServer(max_bytes=result_cache_bytes,
                                              metrics=self.obs.metrics)
        self.shared_scans = SharedScanRegistry(metrics=self.obs.metrics)
        self.plan_cache = PlanCache()
        self.wlm = WorkloadManager(self.hms, total_executors=llap_executors,
                                   metrics=self.obs.metrics)
        self._qid = itertools.count()
        self.scheduler = QueryScheduler(self, max_workers=query_workers)

    def serving_stats(self) -> Dict[str, dict]:
        """Serving-tier counters (result cache, shared scans, admission),
        surfaced through ``QueryHandle.poll()`` and
        ``Connection.server_stats()``."""
        return {
            "result_cache": self.result_cache.stats_snapshot(),
            "shared_scans": self.shared_scans.stats_snapshot(),
            "admission_queues": self.wlm.queue_depths(),
        }

    def resolve_handler(self, name: Optional[str]):
        """Resolve a TableDesc.handler reference: either a globally
        registered handler name or a mounted catalog's connector instance
        (``catalog:<name>``)."""
        if not name:
            return None
        if name.startswith("catalog:"):
            cat = self.catalogs.get(name.split(":", 1)[1])
            return cat.handler if cat is not None else None
        return self.handlers.get(name)

    def session(self, **config) -> "Session":
        # SessionConfig warns on keys the registry doesn't declare — the
        # silent-typo class (a misspelled knob falling back to its default
        # without a trace) REP001 exists to catch
        cfg = SessionConfig(DEFAULT_CONFIG, config)
        if cfg.get("engine") not in _VALID_ENGINES:
            raise ValueError(
                f"engine must be one of {_VALID_ENGINES}, got {cfg['engine']!r}"
            )
        return Session(self, cfg)

    def close(self) -> None:
        """Decommission cluster state (LLAP thread pools, caches)."""
        self.scheduler.shutdown()  # cancels in-flight async handles
        self.llap.shutdown()
        self.result_cache.invalidate_all()
        self.shared_scans.invalidate_all()
        self.plan_cache.invalidate_all()


class Session:
    def __init__(self, wh: Warehouse, config: dict):
        self.wh = wh
        self.hms = wh.hms
        self.config = config
        self.last_info: dict = {}

    # ==================================================================
    # public API
    # ==================================================================
    def execute(self, sql: str, params: Optional[Sequence] = None) -> QueryResult:
        stmt = parse(sql)
        return self.execute_stmt(stmt, sql, params)

    def submit(self, sql: str, params: Optional[Sequence] = None) -> QueryTask:
        """Submit a statement for asynchronous execution.

        Parsing and parameter arity run synchronously (so syntax errors
        surface at submit time, like HS2 compilation); everything else —
        WLM admission, planning, execution — happens on the warehouse
        scheduler's worker pool.  The returned :class:`QueryTask` is the
        engine side of a client :class:`repro_torch.api.handle.QueryHandle`.
        """
        stmt = parse(sql)
        params = tuple(params) if params is not None else ()
        target = stmt.stmt if isinstance(stmt, A.Explain) else stmt
        n = A.count_params(target)
        if n != len(params):
            raise ValueError(
                f"statement has {n} parameter placeholder(s) but "
                f"{len(params)} value(s) were supplied"
            )
        return self.wh.scheduler.submit(self, stmt, sql, params)

    def execute_script(self, sql: str) -> List[QueryResult]:
        return [self.execute_stmt(s, "") for s in parse_many(sql)]

    def explain(self, sql: str) -> str:
        stmt = parse(sql)
        if isinstance(stmt, A.Explain):
            stmt = stmt.stmt
        plan, info = self._plan_query(stmt)
        annotate_plan(plan)  # per-node schema: lines in the rendering
        pretty = plan.pretty()  # before DAG compilation mutates the tree
        expanded = self._expand_for_compile(plan)
        annotate_plan(expanded)
        dag = compile_dag(expanded)
        lines = [pretty, "", f"DAG edges: {dag.edge_summary()}",
                 "exchanges:"] + describe_exchanges(dag)
        for k, v in info.items():
            lines.append(f"{k}: {v}")
        return "\n".join(lines)

    # ==================================================================
    # statement dispatch
    # ==================================================================
    def execute_stmt(self, stmt, sql_text: str = "",
                     params: Optional[Sequence] = None) -> QueryResult:
        params = tuple(params) if params is not None else ()
        if isinstance(stmt, A.Explain):
            inner = stmt.stmt
            if not isinstance(inner, (A.Select, A.SetOp)):
                raise ValueError("EXPLAIN supports queries only")
            n = A.count_params(inner)
            if n != len(params):
                raise ValueError(
                    f"statement has {n} parameter placeholder(s) but "
                    f"{len(params)} value(s) were supplied"
                )
            if stmt.analyze:
                return self._explain_analyze(inner, sql_text, params)
            return QueryResult(
                VectorBatch({"plan": np.array(self.explain_stmt(inner).split("\n"))})
            )
        if isinstance(stmt, (A.Select, A.SetOp)):
            return self._run_query(stmt, sql_text, params)
        n_params = A.count_params(stmt)
        if n_params != len(params):
            raise ValueError(
                f"statement has {n_params} parameter placeholder(s) but "
                f"{len(params)} value(s) were supplied"
            )
        if params:
            # DML/DDL take the substitution path: placeholders become literals
            stmt = A.substitute_params(stmt, params)
        if isinstance(stmt, A.CreateCatalog):
            self.wh.catalogs.create(stmt.name, stmt.connector, stmt.props)
            self.wh.plan_cache.invalidate_all()
            return QueryResult(VectorBatch({}), {"catalog": stmt.name})
        if isinstance(stmt, A.DropCatalog):
            self.wh.catalogs.drop(stmt.name, if_exists=stmt.if_exists)
            self.wh.plan_cache.invalidate_all()
            self.wh.result_cache.invalidate_all()
            return QueryResult(VectorBatch({}))
        if isinstance(stmt, A.CreateTable):
            return self._create_table(stmt)
        if isinstance(stmt, A.CreateMaterializedView):
            return self._create_mv(stmt)
        if isinstance(stmt, A.DropTable):
            if stmt.if_exists and not self.hms.table_exists(stmt.name):
                return QueryResult(VectorBatch({}))
            desc = self.hms.get_table(stmt.name)
            self.hms.drop_table(stmt.name)
            self.wh.result_cache.invalidate_all()
            self.wh.plan_cache.invalidate_all()
            # stop new shared-scan attachments; consumers already attached
            # replay exchange-owned chunks and are unaffected by the purge
            self.wh.shared_scans.invalidate_table(stmt.name)
            if not desc.handler:
                # managed table: purge the LLAP cache and the data files, so
                # a table re-created under the same name never scans the old
                # delta stores (stale-rows-after-DROP seed bug)
                self.wh.llap.invalidate_location(desc.location)
                shutil.rmtree(desc.location, ignore_errors=True)
            return QueryResult(VectorBatch({}))
        if isinstance(stmt, A.Insert):
            return self._insert(stmt)
        if isinstance(stmt, A.Update):
            return self._update(stmt)
        if isinstance(stmt, A.Delete):
            return self._delete(stmt)
        if isinstance(stmt, A.Merge):
            return self._merge(stmt)
        if isinstance(stmt, A.RebuildMaterializedView):
            return self._rebuild_mv(stmt.name)
        if isinstance(stmt, A.CreateResourcePlan):
            self.wh.wlm.create_plan(stmt.name)
            return QueryResult(VectorBatch({}))
        if isinstance(stmt, A.CreatePool):
            self.wh.wlm.create_pool(stmt.plan, stmt.pool, stmt.alloc_fraction,
                                    stmt.query_parallelism)
            return QueryResult(VectorBatch({}))
        if isinstance(stmt, A.CreateWMRule):
            self.wh.wlm.create_rule(stmt.plan, stmt.rule, stmt.metric,
                                    stmt.threshold, stmt.action, stmt.target_pool)
            return QueryResult(VectorBatch({}))
        if isinstance(stmt, A.AddWMRuleToPool):
            plan_name = stmt.plan or self._only_plan()
            self.wh.wlm.add_rule_to_pool(plan_name, stmt.rule, stmt.pool)
            return QueryResult(VectorBatch({}))
        if isinstance(stmt, A.CreateWMMapping):
            self.wh.wlm.create_mapping(stmt.plan, stmt.kind, stmt.entity, stmt.pool)
            return QueryResult(VectorBatch({}))
        if isinstance(stmt, A.AlterResourcePlan):
            if stmt.default_pool:
                self.wh.wlm.set_default_pool(stmt.plan, stmt.default_pool)
            if stmt.enable_activate:
                self.wh.wlm.activate(stmt.plan)
            return QueryResult(VectorBatch({}))
        raise ValueError(f"unsupported statement {type(stmt).__name__}")

    def explain_stmt(self, stmt) -> str:
        plan, info = self._plan_query(stmt)
        annotate_plan(plan)
        pretty = plan.pretty()
        expanded = self._expand_for_compile(plan)
        annotate_plan(expanded)
        dag = compile_dag(expanded)
        edge_lines = "\n".join(describe_exchanges(dag))
        return (pretty + f"\nDAG edges: {dag.edge_summary()}"
                + f"\nexchanges:\n{edge_lines}\ninfo: {info}")

    def _only_plan(self) -> str:
        if self.wh.wlm.active_plan:
            return self.wh.wlm.active_plan.name
        names = [r[0] for r in self.hms._q("SELECT name FROM resource_plans")]
        if len(names) == 1:
            return names[0]
        raise ValueError("ADD RULE requires an active plan or plan qualifier")

    # ==================================================================
    # query path (staged pipeline; see repro_torch.core.pipeline)
    # ==================================================================
    def _plan_query(self, stmt, runtime_overrides: Optional[dict] = None,
                    config: Optional[dict] = None) -> Tuple[P.PlanNode, dict]:
        """Plan-only pipeline run (bind + MV rewrite + optimize)."""
        q = QueryContext(session=self, stmt=stmt, config=config or self.config)
        QueryPipeline(self, plan_only_stages(runtime_overrides)).run(q)
        info = {k: v for k, v in q.info.items()
                if k not in ("stage_times_ms", "seconds")}
        return q.plan, info

    def _push_federated(self, plan: P.PlanNode,
                        config: Optional[dict] = None):
        """Capability-negotiated pushdown for every federated scan: returns
        ``(new_plan, summary)``; declined work stays as local residual
        operators (see ``core.federation.datasource``)."""
        return negotiate_federated(plan, self.wh.resolve_handler,
                                   config or self.config)

    def _expand_federated(self, plan: P.PlanNode,
                          config: Optional[dict] = None) -> P.PlanNode:
        """Fan federated scans out over their connectors' splits (one DAG
        vertex per split; compile-time, never cached)."""
        return expand_federated_splits(plan, self.wh.resolve_handler,
                                       config or self.config)

    def _expand_shuffle(self, plan: P.PlanNode,
                        config: Optional[dict] = None,
                        events: Optional[list] = None) -> P.PlanNode:
        """Clone pipeline-breaker consumers per shuffle partition (compile
        time, like split expansion — cached plans re-expand per execution).
        Compile-time adaptive decisions (co-partition shuffle elision) are
        appended to ``events``."""
        from .optimizer.cost import CostModel
        from .runtime.shuffle import expand_shuffle_partitions

        cfg = config or self.config
        cm = CostModel(self.hms, handler_resolver=self.wh.resolve_handler)
        return expand_shuffle_partitions(plan, cfg, cost_model=cm,
                                         events=events)

    def _expand_for_compile(self, plan: P.PlanNode,
                            config: Optional[dict] = None) -> P.PlanNode:
        """The full compile-time expansion pipeline (splits, then lanes)."""
        return self._expand_shuffle(self._expand_federated(plan, config),
                                    config)

    def _run_pipeline(self, stmt, sql_text: str = "", params: Tuple = (),
                      config: Optional[dict] = None, task=None,
                      slot=None) -> QueryContext:
        q = QueryContext(session=self, sql=sql_text, stmt=stmt,
                         params=tuple(params), config=config or self.config,
                         task=task, slot=slot,
                         qid=task.qid if task is not None else "",
                         cancel_token=(task.cancel_token
                                       if task is not None else None))
        return QueryPipeline(self).run(q)

    def _run_query(self, stmt, sql_text: str = "",
                   params: Tuple = ()) -> QueryResult:
        q = self._run_pipeline(stmt, sql_text, params)
        self.last_info = q.info
        self._note_sync_done(q)
        return QueryResult(q.batch, q.info)

    def _note_sync_done(self, q: QueryContext) -> None:
        """Record a synchronously executed query in the warehouse query log
        (async queries are recorded by the scheduler's worker instead).
        Observability must never fail the query it observes."""
        try:
            self.wh.obs.note_query_done({
                "qid": q.qid,
                "sql": q.sql,
                "status": "SUCCEEDED",
                "wall_ms": round(float(q.info.get("seconds", 0.0)) * 1e3, 3),
                "queue_wait_ms": 0.0,
                "rows": q.batch.num_rows if q.batch is not None else 0,
                "pool": None,
                "cache_hit": bool(q.info.get("cache_hit", False)),
                "error": None,
            }, trace=q.trace)
        except Exception:
            pass

    def _probe_result_cache(self, task: QueryTask):
        """Serving-tier pre-admission probe (run by the async scheduler).

        Parses and binds the statement, then probes the result cache.  On a
        hit the query is finished — served without a WLM slot and without
        execution.  Returns ``(QueryResult | None, QueryContext | None)``;
        a non-None context on a miss carries the bound plan and any pending
        cache entry into :meth:`_run_query_task` so the remaining stages
        resume without re-probing (re-probing would deadlock behind our own
        pending entry)."""
        if isinstance(task.stmt, A.Explain):
            return None, None  # EXPLAIN ANALYZE always executes
        q = QueryContext(session=self, sql=task.sql, stmt=task.stmt,
                         params=tuple(task.params), config=self.config,
                         task=task, qid=task.qid,
                         cancel_token=task.cancel_token)
        QueryPipeline(self, stages=PRE_ADMISSION_STAGES).run(q)
        if not q.finished:
            return None, q
        q.info["admission_skipped"] = True
        # a cache-served result reports the same stage_times_ms keys as an
        # executed one: the post-probe stages ran for 0 ms, not "not at all"
        # (dashboards keying on stage names would otherwise KeyError on hits)
        st = q.info.setdefault("stage_times_ms", {})
        for stage in POST_PROBE_STAGES:
            st.setdefault(stage.name, 0.0)
        emit_event(q.trace, "serving:result_cache_hit", "serving")
        self.last_info = q.info
        return QueryResult(q.batch, q.info), q

    def _run_query_task(self, task: QueryTask, slot,
                        pre: Optional[QueryContext] = None) -> QueryResult:
        """Async query entry point, called by the scheduler's worker with an
        already-admitted WLM slot (or None when no plan is active)."""
        if isinstance(task.stmt, A.Explain):
            # EXPLAIN ANALYZE executes the inner query, so it is admitted
            # like one; the scheduler only routes the analyze variant here
            return self._explain_analyze(task.stmt.stmt, task.sql,
                                         task.params, task=task, slot=slot)
        if pre is not None:
            # resume the pre-admission QueryContext past the cache probe
            pre.slot = slot
            q = QueryPipeline(self, stages=POST_PROBE_STAGES).run(pre)
        else:
            q = self._run_pipeline(task.stmt, task.sql, task.params,
                                   task=task, slot=slot)
        self.last_info = q.info
        return QueryResult(q.batch, q.info)

    def _explain_analyze(self, stmt, sql_text: str, params: Tuple = (),
                         task=None, slot=None) -> QueryResult:
        """EXPLAIN ANALYZE: run the query, report plan + per-stage timings.

        The result cache is bypassed — ANALYZE means "actually execute and
        measure"; a cache hit would short-circuit before the plan exists.
        Tracing is forced on so the report is built from the query's own
        :class:`~repro_torch.core.obs.trace.QueryTrace` (per-vertex compute /
        exchange-wait / spill-I/O breakdowns, lane skew, serving and
        adaptive events) rather than ad-hoc timers."""
        q = self._run_pipeline(stmt, sql_text, params,
                               config={**self.config, "result_cache": False,
                                       "obs.tracing": True},
                               task=task, slot=slot)
        self.last_info = q.info
        lines: List[str] = []
        if q.plan_pretty:
            lines.extend(q.plan_pretty.split("\n"))
            lines.append("")
        lines.append("stage timings:")
        for name, ms in q.info.get("stage_times_ms", {}).items():
            lines.append(f"  {name}: {ms:.3f} ms")
        adaptive = q.info.get("adaptive")
        if adaptive:
            lines.append("adaptive decisions:")
            for ev in adaptive:
                rest = ", ".join(f"{k}={v}" for k, v in ev.items()
                                 if k != "kind")
                lines.append(f"  {ev.get('kind')}: {rest}")
        lines.extend(self._analyze_trace_lines(q))
        for k, v in q.info.items():
            if k not in ("stage_times_ms", "adaptive"):
                lines.append(f"{k}: {v}")
        return QueryResult(VectorBatch({"plan": np.array(lines)}), q.info)

    @staticmethod
    def _analyze_trace_lines(q: QueryContext) -> List[str]:
        """Trace-derived EXPLAIN ANALYZE sections: per-vertex wall split,
        shuffle-lane skew, and the serving/kernel event log."""
        if q.trace is None:
            return []
        summ = q.trace.summary()
        lines: List[str] = []
        verts = summ.get("vertices", {})
        if verts:
            lines.append("vertex breakdown:")
            for vid, v in verts.items():
                lines.append(
                    f"  {vid}: total={v['total_ms']:.3f} ms"
                    f" compute={v['compute_ms']:.3f} ms"
                    f" exchange_wait={v['exchange_wait_ms']:.3f} ms"
                    f" spill_io={v['spill_io_ms']:.3f} ms"
                    f" rows={v['rows']}")
                lanes = v.get("lanes")
                if lanes:
                    rows = [int(ln.get("rows", 0)) for ln in lanes]
                    mean = sum(rows) / len(rows)
                    skew = (max(rows) / mean) if mean else 1.0
                    lines.append(
                        f"    lanes={len(rows)}"
                        f" rows/lane min={min(rows)} max={max(rows)}"
                        f" skew={skew:.2f}x")
        dispatches = summ.get("kernel_dispatches", {})
        if dispatches:
            lines.append("kernel dispatches:")
            for name, n in sorted(dispatches.items()):
                lines.append(f"  {name}: {n}")
        events = [ev for ev in summ.get("events", [])
                  if ev.get("cat") in ("serving", "adaptive", "wlm")]
        if events:
            lines.append("trace events:")
            for ev in events:
                lines.append(f"  +{ev['ts_ms']:.3f} ms [{ev['cat']}] "
                             f"{ev['name']}")
        return lines

    def _make_ctx(self, cfg, params: Tuple = (),
                  cancel_token=None) -> ExecContext:
        ctx = ExecContext(
            self.hms,
            self.hms.get_snapshot(),
            config=cfg,
            io=LlapIO(self.wh.llap) if cfg["llap"] else PlainIO(),
            handlers={**self.wh.handlers.as_dict(),
                      **self.wh.catalogs.handler_map()},
            params=params,
            cancel_token=cancel_token,
        )
        if cfg.get("serving.shared_scans", True):
            ctx.shared_scans = self.wh.shared_scans
        return ctx

    def _persist_runtime_stats(self, plan, ctx) -> None:
        fp = plan.digest()
        for op, rows in list(ctx.op_stats.items())[:64]:
            self.hms.record_runtime_stats(fp, op, -1.0, float(rows))

    # ==================================================================
    # DDL
    # ==================================================================
    def _create_table(self, stmt: A.CreateTable) -> QueryResult:
        handler_name = None
        if stmt.stored_by:
            h = self.wh.handlers.get(stmt.stored_by)
            if h is None:
                raise ValueError(f"unknown storage handler {stmt.stored_by}")
            handler_name = h.name
        schema = [(c.name, c.type) for c in stmt.columns]
        if not schema and handler_name:
            h = self.wh.handlers.get(handler_name)
            inferred = h.infer_schema(stmt.props)
            if inferred is None:
                raise ValueError("cannot infer schema from external system")
            schema = inferred
        part_cols = [c.name for c in stmt.partition_by]
        # Hive keeps partition columns out of the file schema but they are
        # part of the table schema
        for c in stmt.partition_by:
            if c.name not in [n for n, _ in schema]:
                schema.append((c.name, c.type))
        self.hms.create_table(
            stmt.name, schema, partition_cols=part_cols, props=stmt.props,
            handler=handler_name,
        )
        self.wh.plan_cache.invalidate_all()
        return QueryResult(VectorBatch({}))

    def _create_mv(self, stmt: A.CreateMaterializedView) -> QueryResult:
        # 1. evaluate the definition
        plan, _ = self._plan_query(stmt.query)
        ctx = self._make_ctx(self.config)
        batch = Executor(ctx).execute(plan)
        names = plan.output_names()
        out_cols = {}
        for n in names:
            base = n.split(".", 1)[1] if "." in n else n
            out_cols[base] = batch.cols[n]
        batch = VectorBatch(out_cols)
        schema = [(c, _sql_type(batch.cols[c])) for c in batch.column_names]

        source_tables = sorted(
            {s.table.name for s in P.walk_plan(plan)
             if isinstance(s, (P.Scan, P.FederatedScan))}
        )
        handler_name = None
        if stmt.stored_by:
            handler_name = self.wh.handlers.get(stmt.stored_by).name

        desc = self.hms.create_table(
            stmt.name, schema, props=stmt.props, handler=handler_name,
            is_mv=True, mv_sql=_mv_sql_of(stmt),
        )
        if handler_name:
            self._write_external(desc, batch)
        else:
            txn = self.hms.open_txn()
            AcidTable(desc, self.hms).insert(txn, batch)
            self.hms.commit_txn(txn)

        snap = self.hms.get_snapshot()
        build = {t: self._hwm_of(t, snap) for t in source_tables}
        window = float(stmt.props.get("staleness_window", 0) or 0)
        self.hms.register_mv(stmt.name, _mv_sql_of(stmt), source_tables, build,
                             staleness_window=window)
        self.wh.plan_cache.invalidate_all()  # cached plans now miss the MV
        return QueryResult(VectorBatch({}), {"mv": stmt.name, "rows": batch.num_rows})

    def _rebuild_mv(self, name: str) -> QueryResult:
        mvs = {m["name"]: m for m in self.hms.list_mvs()}
        if name not in mvs:
            raise KeyError(f"no materialized view {name}")
        mv = mvs[name]
        desc = self.hms.get_table(name)
        snap = self.hms.get_snapshot()

        # which sources changed, and did any change involve deletes?
        # (catalog-mounted external sources have no WriteId state: remote
        # changes are undetectable, so they never trigger an incremental
        # path on their own — ALTER ... REBUILD still recomputes via "full")
        changed, has_deletes = [], False
        for t in mv["source_tables"]:
            if not self.hms.table_exists(t):
                continue
            wl = self.hms.writeid_list(t, snap)
            old = mv["build_snapshot"].get(t, 0)
            if wl.hwm != old:
                changed.append((t, old))
                tdesc = self.hms.get_table(t)
                from .acid import list_stores

                locs = ([loc for _, loc in self.hms.list_partitions(t)]
                        if tdesc.partition_cols else [tdesc.location])
                for loc in locs:
                    for s in list_stores(loc):
                        if s.kind == "delete_delta" and s.max_writeid > old:
                            has_deletes = True

        mode = "noop"
        stmt = parse(mv["sql"])
        if not changed:
            pass
        elif has_deletes or len(changed) > 1:
            # UPDATE/DELETE (or multi-table inserts) force a full rebuild (§4.4)
            mode = "full"
            self._replace_mv_contents(desc, stmt)
        else:
            # incremental: rewrite reads the MV + only the new data (§4.4);
            # SPJA views MERGE the delta partials into existing groups
            mode = "incremental"
            table, old_wid = changed[0]
            plan, _ = self._plan_query(stmt, config={**self.config,
                                                     "mv_rewriting": False})
            for s in P.walk_plan(plan):
                if isinstance(s, P.Scan) and s.table.name == table:
                    s.min_writeid = old_wid  # snapshot filter on WriteId (§4.4)
            ctx = self._make_ctx(self.config)
            delta = Executor(ctx).execute(plan)
            self._merge_mv_delta(desc, stmt, delta, plan.output_names())

        build = {t: self._hwm_of(t, snap) for t in mv["source_tables"]}
        self.hms.update_mv_snapshot(name, build)
        self.wh.result_cache.invalidate_all()
        self.wh.plan_cache.invalidate_all()
        return QueryResult(VectorBatch({}), {"rebuild_mode": mode})

    def _hwm_of(self, table: str, snap) -> int:
        try:
            return self.hms.writeid_list(table, snap).hwm
        except KeyError:  # catalog-mounted external table: no WriteIds
            return 0

    def _replace_mv_contents(self, desc, stmt) -> None:
        plan, _ = self._plan_query(stmt, config={**self.config,
                                                 "mv_rewriting": False})
        ctx = self._make_ctx(self.config)
        batch = Executor(ctx).execute(plan)
        renamed = VectorBatch({
            c: batch.cols[n]
            for (c, _), n in zip(desc.schema, plan.output_names())
        })
        tbl = AcidTable(desc, self.hms)
        txn = self.hms.open_txn()
        wl = self.hms.writeid_list(desc.name, self.hms.get_snapshot())
        targets = {}
        for pvals, b in tbl.scan(wl, keep_acid_cols=True):
            t = np.stack([b.cols[WRITEID_COL], b.cols[ROWID_COL]], axis=1)
            targets[pvals] = t
        if targets:
            tbl.delete(txn, targets)
        tbl.insert(txn, renamed, update_stats=False)
        self.hms.commit_txn(txn)

    def _merge_mv_delta(self, desc, stmt, delta: VectorBatch, out_names) -> None:
        """MERGE the delta aggregation into the MV table (paper §4.4)."""
        sel = stmt if isinstance(stmt, A.Select) else None
        n_keys = len(sel.group_by) if sel and sel.group_by else 0
        cols = [c for c, _ in desc.schema]
        key_cols, agg_cols = cols[:n_keys], cols[n_keys:]
        delta_renamed = VectorBatch({c: delta.cols[n] for c, n in zip(cols, out_names)})

        tbl = AcidTable(desc, self.hms)
        txn = self.hms.open_txn()
        wl = self.hms.writeid_list(desc.name, self.hms.get_snapshot())
        cur_parts = list(tbl.scan(wl, keep_acid_cols=True))
        cur = VectorBatch.concat([b for _, b in cur_parts])

        if n_keys == 0 or cur.num_rows == 0:
            if cur.num_rows and n_keys == 0:
                merged = {}
                agg_fns = self._agg_fns_of(sel)
                for c, fn in zip(cols, agg_fns):
                    merged[c] = _fold_partial(fn, cur.cols[c], delta_renamed.cols[c])
                targets = {(): np.stack([cur.cols[WRITEID_COL], cur.cols[ROWID_COL]], axis=1)}
                tbl.delete(txn, targets)
                tbl.insert(txn, VectorBatch(merged), update_stats=False)
            else:
                tbl.insert(txn, delta_renamed, update_stats=False)
            self.hms.commit_txn(txn)
            return

        # match delta groups against current rows (WHEN MATCHED -> fold)
        from .runtime.exec import _factorize_pair, _combine_codes

        pairs = [_factorize_pair(cur.cols[k], delta_renamed.cols[k]) for k in key_cols]
        cc, dc = _combine_codes(pairs)
        matched_mask = np.isin(cc, dc)
        # delete matched current rows; fold their aggs into the delta rows
        agg_fns = self._agg_fns_of(sel)
        d_index = {code: i for i, code in enumerate(dc)}
        folded = {c: delta_renamed.cols[c].copy() for c in cols}
        for i in np.flatnonzero(matched_mask):
            j = d_index[cc[i]]
            for c, fn in zip(agg_cols, agg_fns[n_keys:] if len(agg_fns) == len(cols) else agg_fns):
                folded[c][j] = _fold_partial(fn, np.array([cur.cols[c][i]]),
                                             np.array([folded[c][j]]))[0]
        if matched_mask.any():
            targets = {(): np.stack([
                cur.cols[WRITEID_COL][matched_mask],
                cur.cols[ROWID_COL][matched_mask],
            ], axis=1)}
            tbl.delete(txn, targets)
        tbl.insert(txn, VectorBatch(folded), update_stats=False)
        self.hms.commit_txn(txn)

    @staticmethod
    def _agg_fns_of(sel: Optional[A.Select]) -> List[str]:
        if sel is None:
            return []
        fns = []
        for e, _ in sel.projections:
            aggs = [x for x in A.walk(e) if isinstance(x, A.Func) and x.name in A.AGG_FUNCS]
            fns.append(aggs[0].name if aggs else "key")
        return fns

    # ==================================================================
    # DML (§3.2: single-statement transactions, update = delete + insert)
    # ==================================================================
    def _write_external(self, desc, batch: VectorBatch) -> None:
        """Batched write path: morsels stream through the connector's
        :class:`~repro_torch.core.federation.datasource.Writer` and become visible
        atomically on ``commit`` (replaces the one-shot ``write``)."""
        handler = self.wh.resolve_handler(desc.handler)
        if handler is None:
            raise ValueError(f"no storage handler registered: {desc.handler}")
        writer = handler.writer(desc)
        rows = int(self.config.get("exchange.batch_rows", 1024) or 1024)
        try:
            for chunk in batch.iter_chunks(rows):
                writer.write_batch(chunk)
            writer.commit()
        except Exception:
            writer.abort()
            raise

    def _post_write(self, table: str) -> None:
        desc = self.hms.get_table(table)
        if not desc.handler and self.config["compaction_enabled"]:
            maybe_compact(
                AcidTable(desc, self.hms), self.hms,
                CompactionConfig(
                    minor_delta_threshold=self.config["compaction_minor_threshold"],
                    major_ratio_threshold=self.config["compaction_major_ratio"],
                ),
            )

    def _insert(self, stmt: A.Insert) -> QueryResult:
        desc = self.hms.get_table(stmt.table)
        if isinstance(stmt.source, A.Values):
            names = stmt.columns or [c for c, _ in desc.schema]
            one = VectorBatch({"__d": np.zeros(1)})
            cols = {n: [] for n in names}
            for row in stmt.source.rows:
                for n, e in zip(names, row):
                    cols[n].append(eval_expr(e, one, None)[0])
            batch = VectorBatch({n: np.array(v) for n, v in cols.items()})
        else:
            plan, _ = self._plan_query(stmt.source)
            ctx = self._make_ctx(self.config)
            out = Executor(ctx).execute(plan)
            names = stmt.columns or [c for c, _ in desc.schema]
            batch = VectorBatch(dict(zip(names, (out.cols[n] for n in plan.output_names()))))
        batch = _coerce_schema(batch, desc)

        if desc.handler:
            self._write_external(desc, batch)
            return QueryResult(VectorBatch({}), {"inserted": batch.num_rows})
        txn = self.hms.open_txn()
        try:
            AcidTable(desc, self.hms).insert(txn, batch)
            self.hms.commit_txn(txn)
        except Exception:
            if self.hms.txn_state(txn) == "open":
                self.hms.abort_txn(txn)
            raise
        self._post_write(stmt.table)
        return QueryResult(VectorBatch({}), {"inserted": batch.num_rows, "txn": txn})

    def _scan_with_acid(self, desc, where: Optional[A.Expr], alias: str):
        """Yield (pvals, batch, mask) for DML target selection."""
        tbl = AcidTable(desc, self.hms)
        wl = self.hms.writeid_list(desc.name, self.hms.get_snapshot())
        scope_cols = {f"{alias}.{c}": c for c, _ in desc.schema}
        for pvals, b in tbl.scan(wl, keep_acid_cols=True,
                                 io=LlapIO(self.wh.llap) if self.config["llap"] else None):
            qb = b.rename({c: f"{alias}.{c}" for c in b.column_names
                           if not c.startswith("__")})
            if where is not None and qb.num_rows:
                bound = Binder(self.hms)._bind_expr(
                    where, _dml_scope(alias, [c for c, _ in desc.schema])
                )
                mask = eval_expr(bound, qb, None).astype(bool)
            else:
                mask = np.ones(qb.num_rows, dtype=bool)
            yield pvals, qb, mask

    def _delete(self, stmt: A.Delete) -> QueryResult:
        desc = self.hms.get_table(stmt.table)
        # DELETE ... WHERE col IN (subquery) takes the semi-join path
        where = stmt.where
        alias = stmt.table
        txn = self.hms.open_txn()
        deleted = 0
        try:
            targets = {}
            if where is not None and _has_subquery(where):
                sel = A.Select(projections=[(A.Star(), None)],
                               from_=A.TableRef(stmt.table, alias), where=where)
                plan = Binder(self.hms).bind(sel)
                ctx = self._make_ctx({**self.config, "keep_acid_cols": True})
                out = Executor(ctx).execute(plan)
                wid_col = WRITEID_COL if WRITEID_COL in out.cols else f"{alias}.{WRITEID_COL}"
                t = np.stack([out.cols[WRITEID_COL], out.cols[ROWID_COL]], axis=1)
                targets[()] = t
                deleted = len(t)
            else:
                for pvals, qb, mask in self._scan_with_acid(desc, where, alias):
                    t = np.stack([qb.cols[WRITEID_COL][mask],
                                  qb.cols[ROWID_COL][mask]], axis=1)
                    if len(t):
                        targets[pvals] = t
                        deleted += len(t)
            if targets:
                AcidTable(desc, self.hms).delete(txn, targets)
            self.hms.commit_txn(txn)
        except (WriteConflict, TxnAborted):
            raise
        except Exception:
            if self.hms.txn_state(txn) == "open":
                self.hms.abort_txn(txn)
            raise
        self._post_write(stmt.table)
        self.wh.result_cache.invalidate_all()
        return QueryResult(VectorBatch({}), {"deleted": deleted, "txn": txn})

    def _update(self, stmt: A.Update) -> QueryResult:
        desc = self.hms.get_table(stmt.table)
        alias = stmt.table
        tbl = AcidTable(desc, self.hms)
        txn = self.hms.open_txn()
        updated = 0
        try:
            all_targets, new_parts = {}, []
            scope = _dml_scope(alias, [c for c, _ in desc.schema])
            binder = Binder(self.hms)
            for pvals, qb, mask in self._scan_with_acid(desc, stmt.where, alias):
                if not mask.any():
                    continue
                t = np.stack([qb.cols[WRITEID_COL][mask],
                              qb.cols[ROWID_COL][mask]], axis=1)
                all_targets[pvals] = t
                sel = qb.select(mask)
                cols = {}
                for c, _ty in desc.schema:
                    if c in desc.partition_cols:
                        cols[c] = np.full(sel.num_rows, dict(zip(desc.partition_cols, pvals))[c])
                    else:
                        cols[c] = sel.cols[f"{alias}.{c}"]
                for col, e in stmt.assignments:
                    bound = binder._bind_expr(e, scope)
                    cols[col] = eval_expr(bound, sel, None)
                new_parts.append(VectorBatch(cols))
                updated += sel.num_rows
            if all_targets:
                # update = delete + insert under one WriteId (§3.2)
                tbl.delete(txn, all_targets)
                for pvals in all_targets:
                    self.hms.record_write_set(txn, desc.name, pvals, "update")
                tbl.insert(txn, _coerce_schema(VectorBatch.concat(new_parts), desc))
            self.hms.commit_txn(txn)
        except (WriteConflict, TxnAborted):
            raise
        except Exception:
            if self.hms.txn_state(txn) == "open":
                self.hms.abort_txn(txn)
            raise
        self._post_write(stmt.table)
        self.wh.result_cache.invalidate_all()
        return QueryResult(VectorBatch({}), {"updated": updated, "txn": txn})

    def _merge(self, stmt: A.Merge) -> QueryResult:
        tgt_desc = self.hms.get_table(stmt.target.name)
        t_alias = stmt.target.alias or stmt.target.name
        tbl = AcidTable(tgt_desc, self.hms)

        # source relation
        binder = Binder(self.hms)
        if isinstance(stmt.source, A.TableRef):
            s_alias = stmt.source.alias or stmt.source.name
            src_sel = A.Select(projections=[(A.Star(), None)],
                               from_=A.TableRef(stmt.source.name, s_alias))
        else:
            s_alias = stmt.source.alias
            src_sel = A.Select(projections=[(A.Star(), None)], from_=stmt.source)
        src_plan = binder.bind(src_sel)
        ctx = self._make_ctx(self.config)
        src = Executor(ctx).execute(src_plan)
        src = src.rename({n: (n if "." in n else f"{s_alias}.{n}")
                          for n in src.column_names})

        # target snapshot with ACID columns, qualified
        wl = self.hms.writeid_list(tgt_desc.name, self.hms.get_snapshot())
        tgt_parts = list(tbl.scan(wl, keep_acid_cols=True))
        tgt = VectorBatch.concat([
            b.rename({c: f"{t_alias}.{c}" for c in b.column_names
                      if not c.startswith("__")})
            for _, b in tgt_parts
        ]) if tgt_parts else VectorBatch({})

        merged_scope = _dml_scope2({t_alias: [c for c, _ in tgt_desc.schema],
                                    s_alias: [n.split(".", 1)[1] for n in src.column_names]})
        on = binder._bind_expr(stmt.on, merged_scope)
        lkeys, rkeys, residual = _classify_join_condition(
            on, set(tgt.column_names), set(src.column_names)
        )
        from .runtime.exec import _factorize_pair, _combine_codes, _expand_matches

        pairs = [_factorize_pair(tgt.cols[lk], src.cols[rk])
                 for lk, rk in zip(lkeys, rkeys)]
        tc, sc = _combine_codes(pairs)
        order = np.argsort(sc, kind="stable")
        sc_sorted = sc[order]
        lo = np.searchsorted(sc_sorted, tc, "left")
        hi = np.searchsorted(sc_sorted, tc, "right")
        counts = hi - lo
        ti, si = _expand_matches(lo, counts, order)
        joined = VectorBatch({**{k: tgt.cols[k][ti] for k in tgt.cols},
                              **{k: src.cols[k][si] for k in src.cols}})
        if residual is not None and joined.num_rows:
            ok = eval_expr(residual, joined, None).astype(bool)
            joined = joined.select(ok)

        src_matched = np.zeros(src.num_rows, dtype=bool)
        if len(si):
            src_matched[si] = True
        not_matched = src.select(~src_matched)

        txn = self.hms.open_txn()
        n_upd = n_del = n_ins = 0
        try:
            consumed = np.zeros(joined.num_rows, dtype=bool)
            del_targets = []
            ins_parts = []
            for action in stmt.matched:
                if action.condition is not None:
                    cond = binder._bind_expr(action.condition, merged_scope)
                    m = eval_expr(cond, joined, None).astype(bool) & ~consumed
                else:
                    m = ~consumed
                if not m.any():
                    continue
                consumed |= m
                sel = joined.select(m)
                del_targets.append(np.stack([sel.cols[WRITEID_COL],
                                             sel.cols[ROWID_COL]], axis=1))
                if action.kind == "update":
                    cols = {c: sel.cols[f"{t_alias}.{c}"] for c, _ in tgt_desc.schema}
                    for col, e in action.assignments:
                        bound = binder._bind_expr(e, merged_scope)
                        cols[col] = eval_expr(bound, sel, None)
                    ins_parts.append(VectorBatch(cols))
                    n_upd += sel.num_rows
                    self.hms.record_write_set(txn, tgt_desc.name, (), "update")
                else:
                    n_del += sel.num_rows
                    self.hms.record_write_set(txn, tgt_desc.name, (), "delete")
            for action in stmt.not_matched:
                m = np.ones(not_matched.num_rows, dtype=bool)
                if action.condition is not None:
                    cond = binder._bind_expr(action.condition, merged_scope)
                    m = eval_expr(cond, not_matched, None).astype(bool)
                sel = not_matched.select(m)
                names = action.columns or [c for c, _ in tgt_desc.schema]
                cols = {}
                for n, e in zip(names, action.values):
                    bound = binder._bind_expr(e, merged_scope)
                    cols[n] = eval_expr(bound, sel, None)
                ins_parts.append(VectorBatch(cols))
                n_ins += sel.num_rows
            if del_targets:
                tbl.delete(txn, {(): np.concatenate(del_targets)})
            if ins_parts:
                tbl.insert(txn, _coerce_schema(VectorBatch.concat(ins_parts), tgt_desc))
            self.hms.commit_txn(txn)
        except (WriteConflict, TxnAborted):
            raise
        except Exception:
            if self.hms.txn_state(txn) == "open":
                self.hms.abort_txn(txn)
            raise
        self._post_write(tgt_desc.name)
        self.wh.result_cache.invalidate_all()
        return QueryResult(VectorBatch({}),
                           {"updated": n_upd, "deleted": n_del, "inserted": n_ins})


# ---------------------------------------------------------------------------
_is_cacheable = is_cacheable  # moved to repro_torch.core.pipeline; alias kept


def _has_subquery(e: A.Expr) -> bool:
    return any(isinstance(x, A.SubqueryExpr) for x in A.walk(e))


def _dml_scope(alias: str, cols: List[str]):
    from .sql.binder import Scope

    return Scope({alias: cols})


def _dml_scope2(tables: Dict[str, List[str]]):
    from .sql.binder import Scope

    return Scope(tables)


def _sql_type(arr: np.ndarray) -> str:
    return {"i": "BIGINT", "u": "BIGINT", "f": "DOUBLE", "b": "BOOLEAN"}.get(
        arr.dtype.kind, "STRING"
    )


def _coerce_schema(batch: VectorBatch, desc) -> VectorBatch:
    from .acid import _np_dtype

    cols = {}
    for c, ty in desc.schema:
        if c in batch.cols:
            want = _np_dtype(ty)
            v = batch.cols[c]
            if v.dtype != want:
                if want.kind == "i" and v.dtype.kind == "f":
                    v = v.astype(np.int64)
                elif want.kind == "U" :
                    v = v.astype(str)
                else:
                    v = v.astype(want)
            cols[c] = v
    return VectorBatch(cols)


def _fold_partial(fn: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if fn in ("sum", "count"):
        return a + b
    if fn == "min":
        return np.minimum(a, b)
    if fn == "max":
        return np.maximum(a, b)
    return b


def _mv_sql_of(stmt: A.CreateMaterializedView) -> str:
    # reconstruct definition text (the parser does not retain raw text)
    return _select_to_sql(stmt.query)


def _select_to_sql(s: A.Select) -> str:
    parts = ["SELECT "]
    parts.append(", ".join(
        f"{_expr_sql(e)}" + (f" AS {a}" if a else "") for e, a in s.projections
    ))
    if s.from_ is not None:
        parts.append(" FROM " + _from_sql(s.from_))
    if s.where is not None:
        parts.append(" WHERE " + _expr_sql(s.where))
    if s.group_by:
        parts.append(" GROUP BY " + ", ".join(_expr_sql(e) for e in s.group_by))
    if s.having is not None:
        parts.append(" HAVING " + _expr_sql(s.having))
    if s.order_by:
        parts.append(" ORDER BY " + ", ".join(
            f"{_expr_sql(e)} {'DESC' if d else 'ASC'}" for e, d in s.order_by))
    if s.limit is not None:
        parts.append(f" LIMIT {s.limit}")
    return "".join(parts)


def _from_sql(f) -> str:
    if isinstance(f, A.TableRef):
        return f.name + (f" {f.alias}" if f.alias else "")
    if isinstance(f, A.JoinRef):
        if f.kind == "cross" and f.condition is None:
            return f"{_from_sql(f.left)}, {_from_sql(f.right)}"
        cond = f" ON {_expr_sql(f.condition)}" if f.condition is not None else ""
        kind = {"inner": "JOIN", "left": "LEFT JOIN", "right": "RIGHT JOIN",
                "full": "FULL JOIN", "cross": "CROSS JOIN"}[f.kind]
        return f"{_from_sql(f.left)} {kind} {_from_sql(f.right)}{cond}"
    if isinstance(f, A.SubqueryRef):
        return f"({_select_to_sql(f.query)}) {f.alias}"
    raise ValueError(type(f))


def _expr_sql(e: A.Expr) -> str:
    if isinstance(e, A.Col):
        return e.qualified
    if isinstance(e, A.Param):
        return "?"
    if isinstance(e, A.Lit):
        if isinstance(e.value, str):
            return "'" + e.value.replace("'", "''") + "'"
        return str(e.value)
    if isinstance(e, A.BinOp):
        return f"({_expr_sql(e.left)} {e.op} {_expr_sql(e.right)})"
    if isinstance(e, A.UnOp):
        return f"({e.op} {_expr_sql(e.operand)})"
    if isinstance(e, A.Func):
        d = "DISTINCT " if e.distinct else ""
        args = ", ".join(_expr_sql(a) for a in e.args) if e.args else "*"
        if not e.args:
            args = "*" if e.name == "count" else ""
        return f"{e.name}({d}{args})"
    if isinstance(e, A.Star):
        return "*"
    if isinstance(e, A.Between):
        n = "NOT " if e.negated else ""
        return f"({_expr_sql(e.expr)} {n}BETWEEN {_expr_sql(e.low)} AND {_expr_sql(e.high)})"
    if isinstance(e, A.InList):
        n = "NOT " if e.negated else ""
        return f"({_expr_sql(e.expr)} {n}IN ({', '.join(_expr_sql(v) for v in e.values)}))"
    if isinstance(e, A.IsNull):
        n = "NOT " if e.negated else ""
        return f"({_expr_sql(e.expr)} IS {n}NULL)"
    if isinstance(e, A.Case):
        ws = " ".join(f"WHEN {_expr_sql(c)} THEN {_expr_sql(v)}" for c, v in e.whens)
        el = f" ELSE {_expr_sql(e.otherwise)}" if e.otherwise is not None else ""
        return f"CASE {ws}{el} END"
    if isinstance(e, A.Cast):
        return f"CAST({_expr_sql(e.expr)} AS {e.to_type})"
    raise ValueError(f"cannot render {type(e).__name__}")
