"""The warehouse's four axes in one scenario over SSB (paper §3-§6).

One step per axis, in this order, because the writes come last:

1. ``runtime_step``: a resource plan shaped like the paper's ``daytime``
   example (pools ``bi`` and ``etl``), concurrent client connections on
   threads sending ``execute_async`` for flights 1-2, and a repeated q2.1
   answered from the result cache;
2. ``federation_step``: a ``memtable`` catalog holding ``customer`` and
   ``supplier`` (three-part names in q3.1, q3.2 and a grouped count), and
   ``part`` in the JDBC (sqlite) engine, joined in q2.1;
3. ``mv_step``: a materialized view over ``lineorder ⋈ date_dim`` that the
   rewriter takes for q1.1-q1.3;
4. ``write_step``: UPDATE, DELETE and a multi-row INSERT on ``lineorder``,
   a handle opened before the UPDATE reading its own snapshot, the view
   skipped while stale and used again after ``REBUILD``, then compaction.

Every function takes the client ``api`` module (this package's
``repro_torch.api``, or the JAX package's when a test passes it in), a
warehouse that ``workloads/ssb.py:load_ssb`` filled, the ``engine`` every
statement runs under, and ``cfg``, the session configuration of every
connection.  With ``against``, each result is also computed under that
engine on the same state, and the two must agree; every step checks its
own invariants (client rows against serial rows, federated rows against
local ones, view rows against base rows, snapshot and compaction rows)
with ``same``.  ``known`` maps a statement's text to its rows under
``against`` on this state from an earlier run, which the step then does
not run again.  A step returns ``{"rows": {label: rows}, "info": {label:
fields}, "measured": {...}}``: rows and info are what two packages must
agree on; ``measured`` holds times and counts of this run.  Each statement
is logged with its seconds (logger ``repro_torch.workloads.surface``, level
INFO).  Nothing is caught: a failed check raises.
"""
from __future__ import annotations

import importlib
import logging
import math
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from .ssb import SSB_QUERIES

_log = logging.getLogger(__name__)
SEED = 0  # the clients' query orders and the inserted rows
TIMEOUT_S = 600.0  # a result, a barrier or the snapshot handle: else a failure
POLL_S = 0.02  # how often a client polls its handle's queue depth

CLIENT_QUERIES = ("q1.1", "q1.2", "q1.3", "q2.1", "q2.2", "q2.3")
FLIGHT1 = ("q1.1", "q1.2", "q1.3")

# the paper's resource plan (§5.2), as tests/test_cache_reopt_wlm.py writes
# it: dashboards map to ``bi``, everything else lands in ``etl``
DASHBOARD_APP = "visualization_app"
WLM_DDL = (
    "CREATE RESOURCE PLAN daytime",
    "CREATE POOL daytime.bi WITH alloc_fraction=0.8, query_parallelism=5",
    "CREATE POOL daytime.etl WITH alloc_fraction=0.2, query_parallelism=20",
    f"CREATE APPLICATION MAPPING {DASHBOARD_APP} IN daytime TO bi",
    "ALTER PLAN daytime SET DEFAULT POOL = etl",
    "ALTER RESOURCE PLAN daytime ENABLE ACTIVATE",
)

FED_CATALOG = ("CREATE CATALOG ext USING memtable"
               " WITH (latency_s = '0', batch_rows = '8192')")
FED_TABLES = ("customer", "supplier")
JDBC_TABLE = "part_jdbc"
# a grouped count over the federated dimension: integer aggregates that
# float32 holds exactly, so the kernel engines take them (SSB's own SUMs
# over DOUBLE columns stay on the host)
FED_COUNT = """SELECT c_nation, COUNT(lo_orderkey) AS n, SUM(lo_quantity) AS q,
    MIN(lo_quantity) AS lo, MAX(lo_quantity) AS hi
    FROM lineorder, customer WHERE lo_custkey = c_custkey
    AND c_region = 'ASIA' AND lo_quantity < 25
    GROUP BY c_nation ORDER BY c_nation"""

# every flight-1 filter is on a group key (the rewriter re-applies it to
# the view) and inside the view's own ranges; COUNT(lo_orderkey) is the
# view's kernel-shaped aggregate
MV_NAME = "flight1_mv"
MV_SQL = f"""CREATE MATERIALIZED VIEW {MV_NAME} AS
    SELECT d_year, d_yearmonthnum, d_weeknum, lo_discount, lo_quantity,
    SUM(lo_extendedprice * lo_discount) AS revenue, COUNT(lo_orderkey) AS n
    FROM lineorder, date_dim WHERE lo_orderdate = d_datekey
    AND lo_discount BETWEEN 0.01 AND 0.07 AND lo_quantity < 36
    GROUP BY d_year, d_yearmonthnum, d_weeknum, lo_discount, lo_quantity"""

# one year of the 2,556 dates, and the top two quantities
UPDATE_SQL = ("UPDATE lineorder SET lo_discount = lo_discount + 0.01"
              " WHERE lo_orderdate BETWEEN 365 AND 729")
DELETE_SQL = "DELETE FROM lineorder WHERE lo_quantity > 48"
INSERT_ROWS = 4000
INSERT_KEY0 = 10_000_000  # above every lo_orderkey load_ssb draws
# what each of the three writes changes
SNAPSHOT_SQL = """SELECT COUNT(lo_orderkey) AS n, SUM(lo_discount) AS disc,
    SUM(lo_quantity) AS q FROM lineorder"""


# ---------------------------------------------------------------------------
# rows
# ---------------------------------------------------------------------------
def _sort_key(row):
    return tuple(str(v) if isinstance(v, str) else
                 (round(v, 4) if isinstance(v, float) else v) for v in row)


def same_rows(got, exp, rtol: float = 1e-5, atol: float = 1e-8) -> bool:
    """Equal rows in any order; floats within ``rtol``/``atol``
    (``np.allclose``'s defaults: sums taken in another order), NaN equal to
    NaN and None to None."""
    if len(got) != len(exp):
        return False
    for g, e in zip(sorted(got, key=_sort_key), sorted(exp, key=_sort_key)):
        if len(g) != len(e):
            return False
        for gv, ev in zip(g, e):
            if gv is None or ev is None:
                if not (gv is None and ev is None):
                    return False
            elif isinstance(ev, float) or isinstance(gv, float):
                if not ((math.isnan(gv) and math.isnan(ev))
                        or np.isclose(gv, ev, rtol=rtol, atol=atol)):
                    return False
            elif gv != ev:
                return False
    return True


def _check(same: Callable, got, exp, what: str) -> None:
    assert same(got, exp), f"{what}: {got[:4]} != {exp[:4]}"


def _package(api, module: str):
    """``module`` of the package ``api`` belongs to (the scenario imports
    neither package by name)."""
    return importlib.import_module(
        api.__name__.rsplit(".", 1)[0] + "." + module)


def _connect(api, wh, engine: str, cfg: dict, **extra):
    return api.connect(warehouse=wh, **{**cfg, "engine": engine, **extra})


def _head(sql: str) -> str:
    return " ".join(sql.split())[:60]


def _run(api, wh, engine: str, cfg: dict, sql: str, **extra):
    """(rows, info) of ``sql`` on a fresh connection (no rows for a
    statement without a result set)."""
    t0 = time.perf_counter()
    with _connect(api, wh, engine, cfg, **extra) as conn:
        cur = conn.execute(sql)
        rows = cur.fetchall() if cur.description is not None else []
    _log.info("%s %s: %.1f s", engine, _head(sql), time.perf_counter() - t0)
    return rows, dict(cur.info)


def _expected(api, wh, engine, against, cfg, sql, known=None, **extra):
    """``sql``'s rows under ``against`` (else ``engine``): what the step's
    results under ``engine`` are held to; taken from ``known`` where it
    has them."""
    if known and sql in known:
        return known[sql]
    return _run(api, wh, against or engine, cfg, sql, **extra)[0]


def _percentile(ms: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(ms), q)) if ms else float("nan")


# ---------------------------------------------------------------------------
# 1. runtime: WLM pools, concurrent clients, the result cache
# ---------------------------------------------------------------------------
def runtime_step(api, wh, engine: str, cfg: dict,
                 against: Optional[str] = None,
                 same: Callable = same_rows, clients: int = 16,
                 per_client: int = len(CLIENT_QUERIES),
                 known: Optional[dict] = None) -> dict:
    """``clients`` connections of the dashboard application, one thread
    each, send ``per_client`` of flights 1-2 in a seeded order through
    ``execute_async``; each result must equal the query's rows run
    serially (under ``against`` where given)."""
    with _connect(api, wh, engine, cfg) as admin:
        for ddl in WLM_DDL:
            admin.execute(ddl)
    serial = {name: _expected(api, wh, engine, against, cfg,
                              SSB_QUERIES[name], known)
              for name in CLIENT_QUERIES}
    rng = np.random.default_rng(SEED)
    orders = [[CLIENT_QUERIES[i] for i in rng.permutation(len(CLIENT_QUERIES))
               [:per_client]] for _ in range(clients)]
    lat_ms: List[float] = []
    depth = [0]
    pools: Dict[str, int] = {}
    got: List[tuple] = []
    lock = threading.Lock()
    ready = threading.Barrier(clients)

    def client(order):
        conn = _connect(api, wh, engine, cfg, application=DASHBOARD_APP)
        try:
            ready.wait(TIMEOUT_S)
            for name in order:
                t0 = time.perf_counter()
                h = conn.execute_async(SSB_QUERIES[name])
                deepest = 0
                while not h.done() and time.perf_counter() - t0 < TIMEOUT_S:
                    deepest = max([deepest, *h.poll().get(
                        "pool_queue_depth", {}).values()])
                    time.sleep(POLL_S)
                rows = h.result(TIMEOUT_S).fetchall()
                ms = (time.perf_counter() - t0) * 1e3
                with lock:
                    lat_ms.append(ms)
                    depth[0] = max(depth[0], deepest)
                    pool = h.info.get("wlm_pool")
                    pools[pool] = pools.get(pool, 0) + 1
                    got.append((name, rows))
        finally:
            conn.close()

    t0 = time.perf_counter()
    errors: List[BaseException] = []

    def run(order):
        try:
            client(order)
        except BaseException as exc:  # re-raised on the calling thread
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(o,)) for o in orders]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    _log.info("%s: %d clients x %d queries: %.1f s", engine, clients,
              per_client, wall)
    if errors:
        raise errors[0]
    assert len(got) == clients * per_client, (len(got), clients, per_client)
    for name, rows in got:
        _check(same, rows, serial[name], f"client {name} against serial")

    with _connect(api, wh, engine, cfg, result_cache=True) as cached:
        hits = []
        for _ in range(2):
            cur = cached.execute(SSB_QUERIES["q2.1"])
            _check(same, cur.fetchall(), serial["q2.1"], "cached q2.1")
            hits.append(bool(cur.info.get("cache_hit")))
    plan = wh.wlm.active_plan
    return {
        "rows": dict(serial),
        "info": {"cache_hit": hits,
                 "pools": {p: [d.alloc_fraction, d.query_parallelism]
                           for p, d in sorted(plan.pools.items())}},
        "measured": {"clients": clients, "per_client": per_client,
                     "queries": len(lat_ms), "wall_s": wall,
                     "p50_ms": _percentile(lat_ms, 50),
                     "p95_ms": _percentile(lat_ms, 95),
                     "max_queue_depth": depth[0], "pools": pools},
    }


# ---------------------------------------------------------------------------
# 2. federation: a memtable catalog and a JDBC table
# ---------------------------------------------------------------------------
def _federated(sql: str) -> str:
    for t in FED_TABLES:
        sql = sql.replace(f" {t},", f" ext.default.{t},") \
                 .replace(f", {t} ", f", ext.default.{t} ")
    return sql


def federation_step(api, wh, engine: str, cfg: dict,
                    against: Optional[str] = None,
                    same: Callable = same_rows,
                    known: Optional[dict] = None) -> dict:
    """q3.1, q3.2 and a grouped count with ``customer`` and ``supplier``
    read from the ``ext`` memtable catalog, and q2.1 with ``part`` from
    the JDBC engine; rows must equal the local tables' rows."""
    with _connect(api, wh, engine, cfg) as conn:
        conn.execute(FED_CATALOG)
        ext = wh.catalogs.get("ext").handler
        for t in FED_TABLES:
            ext.load(t, conn.session.execute(f"SELECT * FROM {t}").batch)
        jdbc = wh.handlers.get("jdbc")
        jdbc.load_table(JDBC_TABLE, conn.session.execute(
            "SELECT * FROM part").batch)
        conn.execute(f"CREATE EXTERNAL TABLE {JDBC_TABLE} STORED BY 'jdbc'"
                     f" TBLPROPERTIES ('jdbc.table'='{JDBC_TABLE}')")
    local = {"q3.1": SSB_QUERIES["q3.1"], "q3.2": SSB_QUERIES["q3.2"],
             "fed_count": FED_COUNT, "q2.1": SSB_QUERIES["q2.1"]}
    remote = {name: _federated(sql) for name, sql in local.items()
              if name != "q2.1"}
    remote["q2.1"] = local["q2.1"].replace(" part,", f" {JDBC_TABLE},")
    assert all(remote[n] != local[n] for n in local), remote
    rows, info = {}, {}
    for name, sql in remote.items():
        rows[name], got_info = _run(api, wh, engine, cfg, sql)
        info[name] = {"federated_pushdown": got_info.get("federated_pushdown")}
        exp = _expected(api, wh, engine, against, cfg, local[name], known)
        _check(same, rows[name], exp, f"{name} federated against local")
    return {"rows": rows, "info": info,
            "measured": {"jdbc_queries": len(jdbc.queries_served),
                         "memtable_peak_readers": ext.peak_active_readers}}


# ---------------------------------------------------------------------------
# 3. optimizer: materialized-view rewrite
# ---------------------------------------------------------------------------
def mv_step(api, wh, engine: str, cfg: dict, against: Optional[str] = None,
            same: Callable = same_rows, known: Optional[dict] = None) -> dict:
    """Build the flight-1 view; q1.1-q1.3 read it and equal the base
    tables' rows (``mv_rewriting=False``)."""
    t0 = time.perf_counter()
    _run(api, wh, engine, cfg, MV_SQL)
    build_s = time.perf_counter() - t0
    rows, info = {}, {}
    for name in FLIGHT1:
        rows[name], got = _run(api, wh, engine, cfg, SSB_QUERIES[name])
        info[name] = {"mv_used": got.get("mv_used"),
                      "mv_mode": got.get("mv_mode")}
        assert info[name]["mv_used"] == MV_NAME, (name, info[name])
        exp = _expected(api, wh, engine, against, cfg, SSB_QUERIES[name],
                        known, mv_rewriting=False)
        _check(same, rows[name], exp, f"{name} view against base tables")
    (mv_rows,), _ = _run(api, wh, engine, cfg,
                         f"SELECT COUNT(*) FROM {MV_NAME}")
    return {"rows": rows, "info": {**info, "mv_rows": mv_rows[0]},
            "measured": {"build_s": build_s}}


# ---------------------------------------------------------------------------
# 4. transactions: DML, snapshot isolation, view staleness, compaction
# ---------------------------------------------------------------------------
def _insert_sql(rows: int = INSERT_ROWS) -> str:
    """One multi-row INSERT of ``rows`` lineorder rows, drawn as
    ``load_ssb`` draws them, keyed from ``INSERT_KEY0``."""
    rng = np.random.default_rng(SEED)
    price = rng.uniform(100, 10_000, rows).round(2)
    disc = rng.uniform(0, 0.1, rows).round(3)
    cols = (INSERT_KEY0 + np.arange(rows), rng.integers(0, 1000, rows),
            rng.integers(0, 400, rows), rng.integers(0, 200, rows),
            rng.integers(0, 2556, rows), rng.integers(1, 50, rows), price,
            disc, (price * (1 - disc)).round(2),
            rng.uniform(50, 5000, rows).round(2))
    values = ", ".join("(" + ", ".join(repr(v.item()) for v in r) + ")"
                       for r in zip(*cols))
    return f"INSERT INTO lineorder VALUES {values}"


def _delta_dirs(api, wh, table: str = "lineorder") -> int:
    """Delta and delete-delta directories of ``table`` on disk."""
    stores = _package(api, "core.acid").list_stores(
        wh.hms.get_table(table).location)
    return sum(s.kind != "base" for s in stores)


def write_step(api, wh, engine: str, cfg: dict, against: Optional[str] = None,
               same: Callable = same_rows,
               snapshot_delay_s: float = 3.0) -> dict:
    """UPDATE, DELETE and INSERT under ``engine`` (automatic compaction
    off, so the deltas stay for the compaction below), with a handle
    opened before the UPDATE that must return its snapshot's rows; the
    view is skipped while stale and used after ``REBUILD``; compaction
    leaves flight 1's rows as they were.  The handle's vertices wait
    ``snapshot_delay_s`` before they read, so that they read after the
    UPDATE has committed where it takes less than that
    (``measured["snapshot_running_after"]`` names the writes after whose
    commit the handle was still running)."""
    before = _expected(api, wh, engine, against, cfg, SNAPSHOT_SQL,
                       mv_rewriting=False)
    snap = _connect(api, wh, engine, cfg, mv_rewriting=False,
                    debug_vertex_delay_s=snapshot_delay_s)
    t0 = time.perf_counter()
    handle = snap.execute_async(SNAPSHOT_SQL)
    # the query's snapshot is taken when its DAG is compiled
    while not handle.done() and not handle.poll()["vertices_total"]:
        assert time.perf_counter() - t0 < TIMEOUT_S, "snapshot handle stalled"
        time.sleep(0.005)
    counts, secs, running_after = {}, {}, []
    with _connect(api, wh, engine, cfg, compaction_enabled=False) as w:
        for name, sql in (("update", UPDATE_SQL), ("delete", DELETE_SQL),
                          ("insert", _insert_sql())):
            t1 = time.perf_counter()
            counts[name] = w.execute(sql).rowcount
            secs[name] = time.perf_counter() - t1
            _log.info("%s %s: %d rows, %.1f s", engine, name, counts[name],
                      secs[name])
            if not handle.done():
                running_after.append(name)
    old = handle.result(TIMEOUT_S).fetchall()
    snap.close()
    _check(same, old, before, "handle opened before the UPDATE")
    after = _expected(api, wh, engine, against, cfg, SNAPSHOT_SQL,
                      mv_rewriting=False)
    assert not same_rows(after, before), "the writes changed nothing"

    base = {name: _expected(api, wh, engine, against, cfg, SSB_QUERIES[name],
                            mv_rewriting=False)
            for name in FLIGHT1}
    stale, got = _run(api, wh, engine, cfg, SSB_QUERIES["q1.1"])
    _check(same, stale, base["q1.1"], "q1.1 with the view stale")
    t1 = time.perf_counter()
    _, rebuilt = _run(api, wh, engine, cfg,
                      f"ALTER MATERIALIZED VIEW {MV_NAME} REBUILD")
    secs["rebuild"] = time.perf_counter() - t1
    info = {"rowcount": counts, "stale_mv_used": got.get("mv_used"),
            "rebuild_mode": rebuilt.get("rebuild_mode")}
    assert info["stale_mv_used"] is None, info
    rows = {"snapshot_before": old, "snapshot_after": after}
    for name in FLIGHT1:
        rows[name], got = _run(api, wh, engine, cfg, SSB_QUERIES[name])
        info[f"{name}_mv_used"] = got.get("mv_used")
        assert info[f"{name}_mv_used"] == MV_NAME, (name, got)
        _check(same, rows[name], base[name], f"{name} on the rebuilt view")

    acid = _package(api, "core.acid")
    compaction = _package(api, "core.compaction")
    deltas = [_delta_dirs(api, wh)]
    desc = wh.hms.get_table("lineorder")
    t1 = time.perf_counter()
    # major: every delta and delete delta folded into one new base
    info["compaction"] = compaction.compact_partition(
        acid.AcidTable(desc, wh.hms), desc.location, "major",
        wh.hms) is not None
    secs["compaction"] = time.perf_counter() - t1
    _log.info("major compaction: %.1f s", secs["compaction"])
    deltas.append(_delta_dirs(api, wh))
    info["delta_dirs"] = deltas
    for name in FLIGHT1:
        got, _ = _run(api, wh, engine, cfg, SSB_QUERIES[name],
                      mv_rewriting=False)
        _check(same, got, base[name], f"{name} after compaction")
        rows[f"{name}_compacted"] = got
    return {"rows": rows, "info": info,
            "measured": {"seconds": secs,
                         "snapshot_running_after": running_after}}


STEPS = (("runtime", runtime_step), ("federation", federation_step),
         ("mv", mv_step), ("writes", write_step))

