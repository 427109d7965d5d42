"""Quickstart: the warehouse in 60 seconds, through the client API.

Connects via the DB-API-style front-end (``repro_torch.api``), creates a
partitioned ACID table, runs optimized analytic queries with ``?``
parameters, pages results with a cursor, reuses a prepared statement's
cached plan, shows the results cache, a materialized-view rewrite, DML with
snapshot isolation, asynchronous query handles (``execute_async`` +
``fetch_stream`` behind workload-manager pools, paper §5.2), streaming
execution over spill-aware exchanges (``exchange.*`` session config),
federated catalogs (``CREATE CATALOG`` + three-part names with
capability-negotiated pushdown, paper §6), EXPLAIN ANALYZE with per-stage
pipeline timings, adaptive execution (live-telemetry replanning: hot-
lane splits, co-partition shuffle elision, payoff-gated fan-out), and the
observability layer (per-query tracing with Perfetto-renderable export,
the warehouse metrics registry, and the always-on query log).

The port's copy of the JAX package's ``examples/quickstart.py``: every
connection takes ``--engine`` (default ``cuda``, the hand-written kernels on
an H100; ``ref`` runs their plain torch versions and ``auto`` the numpy host
paths, both on the CPU).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--engine auto]
"""
import argparse
import tempfile
from typing import Optional, Sequence

import numpy as np

import repro_torch.api as db


def main(engine: str = "cuda", warehouse_dir: Optional[str] = None):
    conn = db.connect(warehouse_dir or tempfile.mkdtemp(
        prefix="tahoe_quickstart_"), engine=engine)
    cur = conn.cursor()

    print("== DDL: partitioned fact table + dimension (paper §3.1) ==")
    cur.execute("""CREATE TABLE store_sales (
        ss_item_sk INT, ss_qty INT, ss_price DECIMAL(7,2), ss_sold_date_sk INT
    ) PARTITIONED BY (ss_sold_date_sk INT)""")
    cur.execute("CREATE TABLE item (i_item_sk INT, i_category STRING)")

    rng = np.random.default_rng(0)
    rows = ", ".join(
        f"({rng.integers(0, 30)}, {rng.integers(1, 9)},"
        f" {rng.uniform(1, 50):.2f}, {d})"
        for d in range(8) for _ in range(500))
    cur.execute(f"INSERT INTO store_sales VALUES {rows}")
    cur.executemany("INSERT INTO item VALUES (?, ?)",
                    [(i, ["Sports", "Books", "Home"][i % 3])
                     for i in range(30)])
    hms = conn.warehouse.hms
    print(f"partitions on disk: {len(hms.list_partitions('store_sales'))}")

    q = """SELECT i_category, SUM(ss_price * ss_qty) AS rev
           FROM store_sales, item
           WHERE ss_item_sk = i_item_sk AND ss_sold_date_sk BETWEEN ? AND ?
           GROUP BY i_category ORDER BY rev DESC"""
    print("\n== parameterized query (CBO + semijoin reduction + LLAP) ==")
    cur.execute(q, (2, 5))
    print("description:", [d[:2] for d in cur.description])
    for row in cur:
        print("  ", row)
    print("info:", {k: cur.info[k] for k in
                    ("semijoin_reducers", "dag_edges", "cache_hit")})

    cur.execute(q, (2, 5))
    print(f"second run: cache_hit={cur.info['cache_hit']} "
          f"plan_cache_hit={cur.info.get('plan_cache_hit')}")

    print("\n== prepared statement: plan bound+optimized once ==")
    ps = conn.prepare("""SELECT ss_sold_date_sk, COUNT(*) AS n
                         FROM store_sales WHERE ss_qty >= ?
                         GROUP BY ss_sold_date_sk ORDER BY ss_sold_date_sk""")
    for qty in (7, 8):
        c = ps.execute((qty,))
        page = c.fetchmany(3)  # cursor pages through the result
        print(f"  qty>={qty}: first page {page} "
              f"(plan_cache_hit={c.info.get('plan_cache_hit')})")

    print("\n== materialized view rewrite (paper §4.4) ==")
    cur.execute("""CREATE MATERIALIZED VIEW daily_rev AS
        SELECT ss_sold_date_sk, i_category, SUM(ss_price) AS s
        FROM store_sales, item WHERE ss_item_sk = i_item_sk
        GROUP BY ss_sold_date_sk, i_category""")
    cur.execute("""SELECT i_category, SUM(ss_price) FROM store_sales, item
                   WHERE ss_item_sk = i_item_sk GROUP BY i_category""")
    print(f"rewritten against MV: {cur.info.get('mv_used')}"
          f" (mode={cur.info.get('mv_mode')})")

    print("\n== ACID DML with snapshot isolation (paper §3.2) ==")
    cur.execute("UPDATE item SET i_category = 'Clearance' WHERE i_item_sk < ?",
                (3,))
    print("updated rows:", cur.rowcount)
    cur.execute("DELETE FROM store_sales WHERE ss_qty = ?", (1,))
    print("deleted rows:", cur.rowcount)
    cur.execute("ALTER MATERIALIZED VIEW daily_rev REBUILD")
    print("MV rebuild after delete:", cur.info)
    cur.execute("SELECT COUNT(*) FROM store_sales")
    print("row count:", cur.fetchone()[0])

    print("\n== async handles: concurrent queries behind WLM pools (§5.2) ==")
    # a resource plan with two pools: interactive clients are admitted into
    # `bi` (one query at a time), everything else lands in `etl`
    for ddl in [
        "CREATE RESOURCE PLAN daytime",
        "CREATE POOL daytime.bi WITH alloc_fraction=0.7, query_parallelism=1",
        "CREATE POOL daytime.etl WITH alloc_fraction=0.3, query_parallelism=2",
        "CREATE APPLICATION MAPPING dashboard IN daytime TO bi",
        "ALTER PLAN daytime SET DEFAULT POOL = etl",
        "ALTER RESOURCE PLAN daytime ENABLE ACTIVATE",
    ]:
        cur.execute(ddl)
    dash = db.connect(warehouse=conn.warehouse, application="dashboard",
                      result_cache=False, engine=engine)
    # submit without blocking; both handles run on the warehouse scheduler
    h1 = dash.execute_async(
        "SELECT i_category, SUM(ss_price * ss_qty) AS rev "
        "FROM store_sales, item WHERE ss_item_sk = i_item_sk "
        "GROUP BY i_category ORDER BY rev DESC")
    h2 = dash.execute_async("SELECT COUNT(*) FROM store_sales")
    print(f"submitted {h1.query_id} and {h2.query_id} without blocking "
          f"(states: h1={h1.state}, h2={h2.state}; pool bi admits one "
          f"query at a time — with bi full, h2 borrows idle etl capacity; "
          f"once every pool is busy, further handles queue as QUEUED)")
    # stream row batches as the engine produces them; on slow queries the
    # consumer sees batches while the handle is still RUNNING
    for batch in h1.fetch_stream(batch_rows=2):
        print(f"  streamed {len(batch)} row(s) (h1: {h1.state}): {batch}")
    p = h1.poll()
    print(f"h1 finished: pool={p['pool']} vertices="
          f"{p['vertices_done']}/{p['vertices_total']} "
          f"queue_wait_ms={p['queue_wait_ms']}")
    print("h2 result:", h2.result(timeout=30).fetchone()[0],
          f"(state={h2.state})")
    # handles are cancellable while queued or running (cooperative,
    # observed at DAG vertex boundaries); killed/cancelled queries raise
    # QueryKilledError / QueryCancelledError from result().  The demo slows
    # each vertex so the cancel lands before the last cancellation point.
    slow = db.connect(warehouse=conn.warehouse, application="dashboard",
                      debug_vertex_delay_s=0.3, result_cache=False,
                      engine=engine)
    h3 = slow.execute_async("SELECT ss_customer_sk, SUM(ss_price) "
                            "FROM store_sales GROUP BY ss_customer_sk")
    h3.cancel()
    try:
        h3.result(timeout=30)
        print(f"h3 outran the cancel request (state={h3.state})")
    except db.QueryCancelledError:
        print(f"h3 cancelled cleanly (state={h3.state})")
    slow.close()
    dash.close()

    print("\n== streaming execution + spill-aware exchanges (§5) ==")
    # Operators stream `exchange.batch_rows`-row morsels end-to-end: scans,
    # filters and projects pipeline chunk-by-chunk, pipeline breakers (join
    # builds, grouped aggregation, sort) keep incremental-merge state, and
    # each DAG edge buffers at most `exchange.buffer_rows` rows /
    # `exchange.buffer_bytes` bytes in memory — overflow morsels spill to a
    # per-query scratch directory and replay downstream, so a constrained
    # budget changes peak memory, never results.  fetch_stream() therefore
    # yields first rows while upstream vertices are still running.
    tight = db.connect(warehouse=conn.warehouse, result_cache=False,
                       **{"exchange.batch_rows": 256,
                          "exchange.buffer_rows": 512,
                          "exchange.spill": True},
                       engine=engine)
    ht = tight.execute_async(
        "SELECT ss_item_sk, ss_price FROM store_sales WHERE ss_qty >= 2")
    first = next(iter(ht.fetch_stream(batch_rows=256)))
    print(f"first {len(first)} rows arrived while state={ht.state}")
    ht.result(30)
    pt = ht.poll()
    print(f"spilled under the tight budget: rows={pt['rows_spilled']} "
          f"bytes={pt['bytes_spilled']} per-vertex={pt['spill']} "
          f"(peak in-memory rows bounded at {pt['peak_buffered_rows']})")
    # with `exchange.spill: False` the same overflow raises
    # MemoryPressureError and feeds the §4.2 re-optimization path instead
    tight.close()

    print("\n== partitioned shuffle service (§4/§5 MPP parallelism) ==")
    # SHUFFLE edges hash-partition the producer stream into per-consumer
    # lanes: pipeline-breaker consumers (shuffle joins, grouped aggregation,
    # DISTINCT) clone once per partition, each clone owns its lane's
    # build/probe/aggregation state, and the clones merge back through a
    # UNION (or a merging fold for global DISTINCT partials).  The default
    # `shuffle.partitions: auto` derives the lane count from CBO row
    # estimates (small inputs stay single-lane); an int forces it.
    part = db.connect(warehouse=conn.warehouse, result_cache=False,
                      **{"shuffle.partitions": 2}, engine=engine)
    hp = part.execute_async(
        "SELECT i_category, COUNT(DISTINCT ss_item_sk) AS items, "
        "SUM(ss_price) AS rev FROM store_sales, item "
        "WHERE ss_item_sk = i_item_sk GROUP BY i_category")
    print("partitioned result:", hp.result(30).fetchall())
    # per-lane rows/bytes/spill are visible while (and after) running, so
    # key skew shows up as one hot lane instead of a mystery slowdown
    lanes = hp.poll()["lanes"]
    for vid, per_lane in lanes.items():
        rows = [l["rows"] for l in per_lane]
        spill = sum(l["spilled_rows"] for l in per_lane)
        print(f"  edge {vid}: lane rows={rows} spilled={spill}"
          f" (skew = max/min imbalance)")
    # EXPLAIN annotates every exchange boundary with its movement kind and
    # lane count (pushed-vs-residual style)
    s_part = conn.warehouse.session(result_cache=False,
                                    **{"shuffle.partitions": 2},
                                    engine=engine)
    for line in s_part.explain(
            "SELECT i_category, SUM(ss_price) FROM store_sales, item"
            " WHERE ss_item_sk = i_item_sk GROUP BY i_category").split("\n"):
        if "partitions=" in line or line.startswith("exchanges"):
            print(" ", line.strip())
    part.close()

    print("\n== federated catalogs (paper §6) ==")
    # CREATE CATALOG mounts a whole external system at once: tables are
    # addressed with three-part names (catalog.schema.table) and their
    # remote schemas are discovered lazily — no per-table STORED BY DDL
    # (which still works, on the same connector API).
    cur.execute("CREATE CATALOG crm USING jdbc")
    cur.execute("CREATE CATALOG events USING memtable"
                " WITH (latency_s = '0.001', batch_rows = '256')")
    print("mounted catalogs:", conn.catalogs())
    # load data directly into the external engines (out-of-band)
    from repro_torch.core.runtime.vector import VectorBatch

    crm = conn.warehouse.catalogs.get("crm").handler
    crm.load_table("accounts", VectorBatch({
        "item_sk": np.arange(30),
        "owner": np.array([f"acct_{i % 6}" for i in range(30)]),
    }))
    ev = conn.warehouse.catalogs.get("events").handler
    ev.load("clicks", [{"item_sk": int(i % 30), "n": int(1 + i % 4)}
                       for i in range(5000)])
    # pushdown is negotiated capability-by-capability; whatever a connector
    # declines runs locally as residual operators (here the parameterized
    # predicate stays a local residual — plans are parameter-generic, so
    # `?`-bound conjuncts never bake into a connector query), and EXPLAIN
    # shows pushed vs residual on the scan node
    cur.execute("""SELECT owner, SUM(n) AS clicks
                   FROM events.default.clicks c, crm.main.accounts a
                   WHERE c.item_sk = a.item_sk AND c.item_sk < ?
                   GROUP BY owner ORDER BY clicks DESC""", (20,))
    for row in cur.fetchall():
        print("  ", row)
    print("pushed vs residual:", cur.info.get("federated_pushdown"))
    cur.execute("SELECT item_sk, n FROM events.default.clicks"
                " WHERE item_sk < 10 AND n > 1")
    print("literal filters push down:",
          cur.info["federated_pushdown"]["events.default.clicks"])
    # split-parallel streaming: the memtable connector produces morsels
    # with latency, yet first rows arrive before it finishes producing
    hs = conn.execute_async("SELECT item_sk, n FROM events.default.clicks")
    first = next(iter(hs.fetch_stream(batch_rows=256)))
    print(f"first {len(first)} federated rows streamed while "
          f"state={hs.state} (parallel split readers: "
          f"{ev.peak_active_readers})")
    hs.result(30)

    print("\n== serving tier: shared scans + result-cache serving ==")
    # high-concurrency serving: repeated dashboard queries are answered
    # straight from the warehouse-wide result cache — a hit skips WLM
    # admission and execution entirely (`admission_skipped` below) — while
    # distinct-but-overlapping queries attach to an in-flight scan's
    # exchange instead of re-reading the table through LLAP
    dash = """SELECT i_category, SUM(ss_price) AS rev FROM store_sales, item
              WHERE ss_item_sk = i_item_sk GROUP BY i_category"""
    conn.execute(dash)  # first execution fills the cache
    hd = conn.execute_async(dash)  # repeat: served without a WLM slot
    hd.result(30)
    print("repeat served without admission:",
          hd.info.get("admission_skipped"),
          f"(cache_hit={hd.info.get('cache_hit')})")
    # concurrent unique variants (dim-side filters only) share one fact
    # scan: the second query's scan vertex attaches to the first's exchange
    share = db.connect(warehouse=conn.warehouse, semijoin_reduction=False,
                       result_cache=False,
                       **{"debug_vertex_delay_s": 0.05}, engine=engine)
    hs1 = share.execute_async(dash + " ORDER BY rev DESC")
    hs2 = share.execute_async(dash + " ORDER BY rev")
    hs1.result(30), hs2.result(30)
    stats = conn.server_stats()  # warehouse-wide serving counters
    print("result cache:", {k: stats["result_cache"][k]
                            for k in ("hits", "misses", "bytes_used")})
    print("shared scans:", {k: stats["shared_scans"][k]
                            for k in ("published", "attached", "fallbacks")})
    print("admission queues:", stats["admission_queues"])
    share.close()

    print("\n== EXPLAIN ANALYZE: per-stage pipeline timings ==")
    cur.execute("EXPLAIN ANALYZE " + q.replace("?", "3", 1).replace("?", "6"))
    for (line,) in cur.fetchall():
        print(line)

    print("\n== correctness toolkit ==")
    # three analysis gates ship with the warehouse
    # (`repro_torch.analysis`):
    #   * `python -m repro_torch.analysis` — AST invariant lint
    #     (REP001..REP004:
    #     declared config keys, cancellable reader loops, no new full-
    #     materialization sites, lock hygiene); CI fails on any finding;
    #   * REPRO_LOCKDEP=1 — every runtime lock becomes order-tracked and
    #     the first AB/BA inversion raises LockOrderError deterministically;
    #   * debug.validate_plans / REPRO_VALIDATE_PLANS — every compiled DAG
    #     is structurally validated (edges, shuffle lanes, plan-cache
    #     aliasing) before execution, as below:
    checked = db.connect(warehouse=conn.warehouse,
                         **{"debug.validate_plans": True}, engine=engine)
    rows = checked.execute(
        "SELECT i_category, COUNT(*) AS n FROM store_sales, item"
        " WHERE ss_item_sk = i_item_sk GROUP BY i_category"
    ).fetchall()
    print(f"validated plan executed: {len(rows)} groups "
          f"(every DAG this session compiles is structure-checked)")
    checked.close()

    print("\n-- schema contract --")
    # every bound plan node carries a typed output schema (name -> numpy
    # dtype + nullability, inferred from catalog types through the same
    # promotion rules the executor applies).  The schema-flow checker
    # (`repro_torch.analysis.schema_check`, rules SCH001..SCH006) re-verifies
    # the contract on every compiled and adaptively mutated DAG under
    # `debug.validate_plans`: column refs resolve, UNION/shuffle branches
    # promote, aggregate merge folds preserve partial-state dtypes, join
    # and partition keys hash in the same dtype family, federated
    # residuals only touch surviving columns, and edge placeholders agree
    # with their producers.  `debug.check_batches` (REPRO_CHECK_BATCHES)
    # adds the runtime half: every exchange morsel is asserted against
    # the edge's declared schema — zero overhead when off.  EXPLAIN shows
    # the inferred contract inline:
    schema_checked = db.connect(warehouse=conn.warehouse,
                                **{"debug.validate_plans": True,
                                   "debug.check_batches": True},
                                engine=engine)
    sc_cur = schema_checked.cursor()
    sc_cur.execute(
        "EXPLAIN SELECT i_category, COUNT(*) AS n FROM store_sales, item"
        " WHERE ss_item_sk = i_item_sk GROUP BY i_category")
    for (line,) in sc_cur.fetchall():
        if "schema:" in line or "->" in line:
            print(line)
    schema_checked.close()

    print("\n== adaptive execution: live-telemetry replanning ==")
    # with `adaptive.enabled` (the default) the running DAG is replanned
    # from lane telemetry: a hot shuffle lane splits its remaining rows
    # across fresh sub-lanes (re-merged by a folding aggregate), a grouped
    # aggregate whose keys cover the upstream join's shuffle keys reuses
    # the join's lanes instead of adding its own hop (shuffle elision, at
    # compile time), and a fan-out whose live rows fall far short of the
    # CBO estimate collapses back to a single consumer.  Every mid-query
    # DAG mutation is re-validated by `repro_torch.analysis.check_dag` before
    # the scheduler adopts it; declined adoptions surface as `declined`.
    cur.execute("CREATE TABLE skewed_sales (k INT, v INT)")
    cur.execute("CREATE TABLE sku (sk INT, weight INT)")
    n = 240_000
    k = rng.integers(0, 64, n)
    k[rng.random(n) < 0.85] = 7  # one key owns ~85% of the rows
    from repro_torch.core.acid import AcidTable
    tx = conn.warehouse.hms.open_txn()
    AcidTable(conn.warehouse.hms.get_table("skewed_sales"),
              conn.warehouse.hms).insert(
        tx, VectorBatch({"k": k, "v": np.arange(n) % 100}))
    AcidTable(conn.warehouse.hms.get_table("sku"),
              conn.warehouse.hms).insert(
        tx, VectorBatch({"sk": np.arange(64), "weight": np.arange(64)}))
    conn.warehouse.hms.commit_txn(tx)

    # hot-lane split: the skewed key floods one of the two lanes; its
    # remaining rows are re-spread over fresh sub-lanes mid-stream and the
    # merge becomes a partial-combining fold
    adp2 = db.connect(warehouse=conn.warehouse, result_cache=False,
                      **{"shuffle.partitions": 2}, engine=engine)
    ha = adp2.execute_async(
        "SELECT k, SUM(v) AS sv, COUNT(*) AS c FROM skewed_sales"
        " GROUP BY k")
    ha.result(60)
    print("skewed aggregate replanned live:",
          [e["kind"] for e in ha.poll()["adaptive"]])

    auto = db.connect(warehouse=conn.warehouse, result_cache=False,
                      **{"shuffle.partitions": "auto",
                         "broadcast_threshold_rows": 0.0}, engine=engine)
    # co-partition elision: GROUP BY s.k covers the join's shuffle keys,
    # so the aggregate runs inside the join's lanes — one hop, not two
    he = auto.execute_async(
        "SELECT s.k, SUM(s.v) AS sv FROM skewed_sales s"
        " JOIN sku d ON s.k = d.sk GROUP BY s.k")
    he.result(60)
    print("covered join/agg elides its shuffle:", he.poll()["adaptive"])
    # payoff gate: the residual predicate is opaque to the CBO, live rows
    # come in far under the estimate, and the fan-out is collapsed back
    # to a single consumer
    hc = auto.execute_async(
        "SELECT s.v, SUM(s.k) AS sk FROM skewed_sales s"
        " JOIN sku d ON s.k = d.sk"
        " WHERE s.k + d.weight >= 100 GROUP BY s.v")
    hc.result(60)
    print("over-estimated fan-out declined:", hc.poll()["adaptive"])
    auto.close()

    # EXPLAIN ANALYZE appends the adaptive decision log to the stage
    # timings, so a replanned query explains itself after the fact
    s_adp = conn.warehouse.session(result_cache=False,
                                   **{"shuffle.partitions": 2},
                                   engine=engine)
    ra = s_adp.execute("EXPLAIN ANALYZE SELECT k, SUM(v) AS sv"
                       " FROM skewed_sales GROUP BY k")
    text = [str(line) for line in ra.batch.cols["plan"]]
    start = next((i for i, l in enumerate(text)
                  if l.startswith("adaptive decisions:")), len(text))
    for line in text[start:]:
        print(" ", line)
    adp2.close()

    print("\n== observability: tracing, metrics, query log ==")
    # `obs.tracing` (or REPRO_OBS_TRACING=1) records a structured
    # QueryTrace per query: pipeline-stage spans, the WLM admission wait,
    # every DAG vertex split into compute / exchange-wait / spill-I/O,
    # shuffle lanes, federated split reads, kernel dispatches, and
    # serving/adaptive events — all on one clock.  Tracing off costs one
    # attribute test per site (the span helpers return a shared no-op).
    traced = db.connect(warehouse=conn.warehouse, result_cache=False,
                        **{"obs.tracing": True, "shuffle.partitions": 2},
                        engine=engine)
    ht = traced.execute_async(
        "SELECT k, SUM(v) AS sv FROM skewed_sales GROUP BY k")
    ht.result(60)
    summ = ht._task.trace.summary()
    print("traced stages:", sorted(summ["stages_ms"]))
    for vid, v in summ["vertices"].items():
        print(f"  vertex {vid}: total={v['total_ms']:.1f}ms "
              f"compute={v['compute_ms']:.1f}ms "
              f"exchange_wait={v['exchange_wait_ms']:.1f}ms "
              f"spill_io={v['spill_io_ms']:.1f}ms rows={v['rows']}")
    # export as Chrome trace-event JSON: open in Perfetto or
    # chrome://tracing to see the query as a timeline
    import os
    trace_path = os.path.join(tempfile.gettempdir(), "quickstart_trace.json")
    traced.export_trace(ht.query_id, trace_path)
    print("Perfetto-renderable trace written to", trace_path)
    # every counter/gauge/histogram flows through one MetricsRegistry;
    # server_stats()/poll() keep their shapes but derive from it
    m = conn.metrics()
    print("metrics: query.succeeded =",
          m["counters"].get("query.succeeded"),
          "| result-cache hits =",
          m["counters"].get("serving.result_cache.hits"),
          "| kernel dispatches =",
          {k.split(".", 2)[2]: v for k, v in m["counters"].items()
           if k.startswith("kernels.dispatch.")} or "(engine=auto)")
    print("query.wall_ms histogram:",
          m["histograms"]["query.wall_ms"]["count"], "queries observed")
    # the query log is an always-on bounded ring — no config needed
    for entry in conn.query_log(limit=3):
        print(f"  [{entry['status']}] {entry['qid'] or '-'} "
              f"{entry['wall_ms']:.1f}ms rows={entry['rows']} "
              f"cache_hit={entry['cache_hit']}: {entry['sql'][:48]}...")
    traced.close()

    conn.close()


def cli(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", default="cuda",
                    help="cuda (default) | ref | auto")
    main(ap.parse_args(argv).engine)


if __name__ == "__main__":
    cli()
