"""Batch-pipelined vectorized execution.

Covers: chunked-operator parity against the materialized baseline on
randomized inputs, spill-and-replay correctness under a tiny exchange
budget, first-batch-before-root-completion streaming, cancellation at
operator batch boundaries (including under speculative execution), WLM
per-pool FIFO admission, and pallas/ref engine parity for the newly
dispatched kernels (bloom_probe, MIN/MAX hash_group, key_lookup).
"""
import time

import numpy as np
import pytest
import torch

import repro_torch.api as db
from repro_torch.core.runtime.cancel import QueryCancelledError
from repro_torch.core.runtime.exec import Executor, MemoryPressureError
from repro_torch.core.sql.parser import parse
from repro_torch.kernels.registry import engine_device, on_gpu

TINY = {"exchange.batch_rows": 64, "result_cache": False}


def wait_for(cond, timeout=10.0, interval=0.01, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out after {timeout}s waiting for {what}")


def rounded(rows):
    def norm(x):
        if isinstance(x, float):
            return "NULL" if np.isnan(x) else round(x, 6)
        return x

    return sorted(tuple(norm(x) for x in r) for r in rows)


@pytest.fixture()
def conn(tmp_path):
    c = db.connect(str(tmp_path / "wh"), engine="auto")
    cur = c.cursor()
    cur.execute("CREATE TABLE fact (fk INT, grp INT, v DOUBLE, s STRING)")
    cur.execute("CREATE TABLE dim (dk INT, cat STRING, weight DOUBLE)")
    rng = np.random.default_rng(7)
    fk = rng.integers(0, 40, 3000)
    grp = rng.integers(0, 13, 3000)
    v = rng.uniform(-50, 50, 3000)
    rows = ", ".join(
        f"({int(a)}, {int(g)}, {float(x):.4f}, 's{int(a) % 5}')"
        for a, g, x in zip(fk, grp, v)
    )
    cur.execute(f"INSERT INTO fact VALUES {rows}")
    rows = ", ".join(f"({i}, 'c{i % 4}', {i * 0.25})" for i in range(35))
    cur.execute(f"INSERT INTO dim VALUES {rows}")
    yield c
    c.close()


PARITY_QUERIES = [
    "SELECT grp, COUNT(*) AS n, SUM(v) AS s, MIN(v) AS mn, MAX(v) AS mx,"
    " AVG(v) AS av FROM fact GROUP BY grp ORDER BY grp",
    "SELECT s, COUNT(DISTINCT grp) AS d FROM fact GROUP BY s ORDER BY s",
    "SELECT fk, v FROM fact WHERE v > 10 ORDER BY v DESC LIMIT 17",
    "SELECT cat, SUM(v) AS s, MIN(fk) AS mn FROM fact JOIN dim ON fk = dk"
    " WHERE weight > 2 GROUP BY cat ORDER BY cat",
    "SELECT d.cat, f.v FROM dim d LEFT JOIN fact f ON d.dk = f.fk"
    " WHERE d.dk >= 38",
    "SELECT fk FROM fact WHERE fk IN (SELECT dk FROM dim WHERE weight > 8)"
    " ORDER BY fk LIMIT 25",
    "SELECT grp AS g FROM fact WHERE v > 45 UNION ALL"
    " SELECT dk AS g FROM dim WHERE weight > 8",
    "SELECT grp AS g FROM fact UNION SELECT dk AS g FROM dim",
    "SELECT COUNT(*), SUM(v), MIN(v), MAX(v) FROM fact WHERE v > 1000",
    "SELECT grp, v, row_number() OVER (PARTITION BY grp ORDER BY v) AS rn"
    " FROM fact WHERE v > 40",
]


def test_chunked_operator_parity_vs_materialized(conn):
    """Tiny-morsel pipelined execution returns exactly what the
    materialize-every-vertex baseline returns, query by query."""
    wh = conn.warehouse
    piped = db.connect(warehouse=wh, **TINY, engine="auto")
    mat = db.connect(warehouse=wh, result_cache=False,
                     **{"exchange.pipeline": False}, engine="auto")
    for sql in PARITY_QUERIES:
        a = piped.execute(sql).fetchall()
        b = mat.execute(sql).fetchall()
        assert rounded(a) == rounded(b), sql
    for c in (piped, mat):
        c.close()


def test_spill_and_replay_matches_unconstrained(conn):
    """A constrained exchange budget completes via spill with results
    identical to the unconstrained run, and poll() reports the spill."""
    wh = conn.warehouse
    sql = ("SELECT cat, v FROM fact JOIN dim ON fk = dk"
           " ORDER BY v DESC LIMIT 50")
    free = db.connect(warehouse=wh, **TINY, engine="auto")
    tight = db.connect(warehouse=wh, **TINY,
                       **{"exchange.buffer_rows": 128,
                          "exchange.buffer_bytes": 1 << 14}, engine="auto")
    expect = free.execute(sql).fetchall()
    h = tight.execute_async(sql)
    got = h.result(60).fetchall()
    assert rounded(got) == rounded(expect)
    p = h.poll()
    assert p["rows_spilled"] > 0
    assert p["bytes_spilled"] > 0
    assert any(v["rows"] > 0 for v in p["spill"].values())
    for c in (free, tight):
        c.close()


def test_partitioned_scan_all_filtered_keeps_schema(conn):
    """A chunked scan whose every stripe filters out still yields a
    schema-carrying empty batch including partition columns."""
    cur = conn.cursor()
    cur.execute("CREATE TABLE pt (x INT, y DOUBLE) PARTITIONED BY (p INT)")
    cur.execute("INSERT INTO pt VALUES (1, 1.0, 10), (2, 2.0, 20)")
    c = db.connect(warehouse=conn.warehouse, **TINY, engine="auto")
    assert c.execute("SELECT p, x FROM pt WHERE x > 999").fetchall() == []
    assert c.execute("SELECT p, SUM(x) FROM pt WHERE x > 999"
                     " GROUP BY p").fetchall() == []
    c.close()


def test_spill_off_overflow_recovers_via_reopt(conn):
    """With reopt enabled, a spill-disabled exchange overflow re-executes on
    materialized exchanges and still returns correct results."""
    s = conn.warehouse.session(
        result_cache=False,
        **{"exchange.batch_rows": 64, "exchange.buffer_rows": 128,
           "exchange.spill": False}, engine="auto")
    r = s.execute("SELECT cat, COUNT(*) FROM fact JOIN dim ON fk = dk"
                  " GROUP BY cat ORDER BY cat")
    assert r.info.get("reexecuted") is True
    baseline = conn.execute("SELECT cat, COUNT(*) FROM fact JOIN dim"
                            " ON fk = dk GROUP BY cat ORDER BY cat").fetchall()
    assert rounded(r.rows) == rounded(baseline)


def test_spill_disabled_raises_memory_pressure(conn):
    s = conn.warehouse.session(
        result_cache=False, reopt_mode="off",
        **{"exchange.batch_rows": 64, "exchange.buffer_rows": 128,
           "exchange.spill": False}, engine="auto")
    with pytest.raises(MemoryPressureError):
        s.execute("SELECT cat, v FROM fact JOIN dim ON fk = dk ORDER BY v")


def test_fetch_stream_first_batch_before_root_finishes(conn):
    """SSB-style scan-filter-project: the first streamed batch arrives while
    the root (and only) vertex is still producing morsels."""
    wh = conn.warehouse
    c = db.connect(warehouse=wh, **TINY, engine="auto")
    h = c.execute_async("SELECT fk, v * 2 FROM fact WHERE v > -100")
    polls, batches = [], []
    for batch in h.fetch_stream(batch_rows=64):
        if not batches:
            polls.append(h.poll())
        batches.append(batch)
    # backpressure (queue of 2 pages, 64 rows each) guarantees the producer
    # was still mid-vertex when the consumer pulled the first page
    assert polls[0]["vertices_done"] < max(polls[0]["vertices_total"], 1)
    assert polls[0]["state"] == "RUNNING"
    assert len(batches) > 10
    assert sum(len(b) for b in batches) == 3000
    c.close()


def test_cancel_observed_at_batch_boundaries(conn):
    """A tripped token stops an operator loop at the next morsel instead of
    draining the stream (ROADMAP: speculated-clone cancel latency)."""
    from repro_torch.core.runtime.cancel import CancelToken

    wh = conn.warehouse
    s = wh.session(result_cache=False, **{"exchange.batch_rows": 64}, engine="auto")
    plan, _ = s._plan_query(parse("SELECT fk, v FROM fact WHERE v > -100"))
    token = CancelToken()
    ctx = s._make_ctx(dict(s.config), cancel_token=token)
    gen = Executor(ctx).stream(plan)
    first = next(gen)
    assert first.num_rows > 0
    token.cancel("test cancel mid-stream")
    with pytest.raises(QueryCancelledError):
        next(gen)


def test_cancel_mid_vertex_under_speculation(conn):
    """Speculative mode runs the barrier scheduler, but operator loops still
    poll the token every morsel: cancelling mid-vertex (the speculated-clone
    regression) terminates promptly."""
    wh = conn.warehouse
    calls = []

    from repro_torch.core.runtime.exec import _SCALAR_FUNCS

    def slow_ident(args):
        calls.append(1)
        time.sleep(0.02)
        return args[0]

    _SCALAR_FUNCS["slow_ident_pr3"] = slow_ident
    try:
        c = db.connect(warehouse=wh, speculative_execution=True,
                       result_cache=False, **{"exchange.batch_rows": 32}, engine="auto")
        h = c.execute_async("SELECT slow_ident_pr3(v) FROM fact")
        wait_for(lambda: len(calls) >= 3, what="vertex mid-stream")
        t0 = time.monotonic()
        h.cancel()
        wait_for(h.done, what="cancelled handle terminal")
        assert time.monotonic() - t0 < 2.0  # ~one morsel, not 94 of them
        assert h.state == "CANCELLED"
        seen = len(calls)
        time.sleep(0.1)
        assert len(calls) <= seen + 2  # the loop stopped at a batch boundary
        c.close()
    finally:
        _SCALAR_FUNCS.pop("slow_ident_pr3", None)


def test_cancel_latency_bounded_under_partitioned_lanes(conn):
    """With shuffle.partitions > 1 every per-partition clone observes the
    token at its own batch boundaries: cancelling mid-shuffle terminates
    within ~one morsel, not after draining every lane."""
    from repro_torch.core.runtime.exec import _SCALAR_FUNCS

    calls = []

    def slow_ident(args):
        calls.append(1)
        time.sleep(0.02)
        return args[0]

    _SCALAR_FUNCS["slow_ident_pr5"] = slow_ident
    try:
        c = db.connect(warehouse=conn.warehouse, result_cache=False,
                       **{"exchange.batch_rows": 32,
                          "shuffle.partitions": 4,
                          "broadcast_threshold_rows": 0.0}, engine="auto")
        h = c.execute_async(
            "SELECT grp, SUM(slow_ident_pr5(v)) FROM fact"
            " JOIN dim ON fk = dk GROUP BY grp")
        wait_for(lambda: len(calls) >= 3, what="clone mid-stream")
        t0 = time.monotonic()
        h.cancel()
        wait_for(h.done, what="cancelled handle terminal")
        assert time.monotonic() - t0 < 2.0
        assert h.state == "CANCELLED"
        seen = len(calls)
        time.sleep(0.1)
        # each of the (at most 4) running clones stops at a batch boundary
        assert len(calls) <= seen + 8
        c.close()
    finally:
        _SCALAR_FUNCS.pop("slow_ident_pr5", None)


# ---------------------------------------------------------------------------
# WLM fair admission
# ---------------------------------------------------------------------------
def test_wlm_fifo_admission_and_queue_depth(conn):
    cur = conn.cursor()
    for ddl in [
        "CREATE RESOURCE PLAN solo",
        "CREATE POOL solo.only WITH alloc_fraction=1.0, query_parallelism=1",
        "ALTER PLAN solo SET DEFAULT POOL = only",
        "ALTER RESOURCE PLAN solo ENABLE ACTIVATE",
    ]:
        cur.execute(ddl)
    slow = db.connect(warehouse=conn.warehouse, result_cache=False,
                      debug_vertex_delay_s=0.25, engine="auto")
    handles = [slow.execute_async("SELECT COUNT(*) FROM fact WHERE fk > ?",
                                  (0,))]
    wait_for(lambda: handles[0].state == "RUNNING", what="first running")
    for i in range(1, 4):
        depth_before = conn.warehouse.wlm.queue_depths().get("only", 0)
        h = slow.execute_async("SELECT COUNT(*) FROM fact WHERE fk > ?", (i,))
        # wait until this handle is measurably parked in its pool's queue,
        # so arrival order into the per-pool FIFO is deterministic
        wait_for(lambda: conn.warehouse.wlm.queue_depths().get("only", 0)
                 > depth_before, what=f"handle {i} queued")
        handles.append(h)
    depths = [p.poll().get("pool_queue_depth", {}).get("only", 0)
              for p in handles]
    assert max(depths) >= 1  # queue depth surfaced through poll()
    for h in handles:
        h.result(60)
    admitted = [h._task.admitted_at for h in handles]
    assert admitted == sorted(admitted)  # per-pool FIFO, not FIFO-by-wakeup
    slow.close()


# ---------------------------------------------------------------------------
# widened kernel dispatch: cuda/ref parity
# ---------------------------------------------------------------------------
def _engine_device(engine):
    """The device of the port's kernel engine ``ref`` (the CPU) or ``cuda``
    (the JAX package's ``pallas``; skips without an H100)."""
    if engine == "cuda" and not on_gpu():
        pytest.skip("engine 'cuda' needs an NVIDIA GPU of compute "
                    "capability >= 9.0")
    return engine_device(engine)


@pytest.mark.parametrize("engine", ["ref", "cuda"])
def test_bloom_probe_engine_parity(engine):
    from repro_torch.core.bloomfilter import BloomFilter
    from repro_torch.kernels.bloom.ops import probe_bloom_filter

    rng = np.random.default_rng(3)
    keys = rng.integers(0, 100_000, 4000)
    bf = BloomFilter.for_expected(len(keys))
    bf.add(keys)
    queries = rng.integers(0, 200_000, 8192)
    _engine_device(engine)
    host = bf.might_contain(queries)
    kernel = np.asarray(probe_bloom_filter(bf, queries, engine=engine))
    ref = np.asarray(probe_bloom_filter(bf, queries, engine="ref"))
    assert np.array_equal(kernel, ref)
    assert np.array_equal(kernel, host)


@pytest.mark.parametrize("engine", ["ref", "cuda"])
def test_minmax_kernel_engine_parity(engine):
    from repro_torch.kernels.hash_group.ops import hash_group_minmax

    rng = np.random.default_rng(5)
    codes = rng.integers(0, 200, 10_000).astype(np.int32)
    vals = rng.integers(-1000, 1000, 10_000).astype(np.float32)
    out = {}
    for eng in (engine, "ref"):
        dev = _engine_device(eng)
        mins, maxs = hash_group_minmax(torch.from_numpy(codes).to(dev),
                                       torch.from_numpy(vals).to(dev), 200,
                                       engine=eng)
        out[eng] = (mins.cpu().numpy(), maxs.cpu().numpy())
    assert np.array_equal(out[engine][0], out["ref"][0])
    assert np.array_equal(out[engine][1], out["ref"][1])
    for g in (0, 17, 199):
        sel = vals[codes == g]
        assert out["ref"][0][g] == sel.min()
        assert out["ref"][1][g] == sel.max()


@pytest.mark.parametrize("engine", ["ref", "cuda"])
def test_key_lookup_engine_parity(engine):
    from repro_torch.kernels.key_lookup.ops import key_lookup

    rng = np.random.default_rng(11)
    uniq = np.unique(rng.integers(0, 3000, 900)).astype(np.float32)
    probe = rng.integers(-50, 3500, 5000).astype(np.float32)
    got = {eng: key_lookup(torch.from_numpy(uniq).to(_engine_device(eng)),
                           torch.from_numpy(probe).to(_engine_device(eng)),
                           engine=eng).cpu().numpy()
           for eng in (engine, "ref")}
    assert np.array_equal(got[engine], got["ref"])
    hit = got["ref"] >= 0
    assert np.array_equal(uniq[got["ref"][hit]], probe[hit])
    assert not np.isin(probe[~hit], uniq).any()


@pytest.mark.parametrize("engine", ["ref", "cuda"])
def test_engine_parity_full_query_path(conn, engine):
    """bloom_probe (semijoin reducers), MIN/MAX + SUM/COUNT (hash_group*),
    key_lookup (join probes), filter_eval: one SSB-shaped query, auto
    against a kernel engine, identical rows."""
    _engine_device(engine)
    wh = conn.warehouse
    sql = ("SELECT cat, COUNT(*) AS n, SUM(fk) AS s, MIN(fk) AS mn,"
           " MAX(fk) AS mx FROM fact JOIN dim ON fk = dk"
           " WHERE weight > 6 AND fk >= 0 GROUP BY cat ORDER BY cat")
    results = {}
    for eng in ("auto", engine):
        c = db.connect(warehouse=wh, engine=eng, **TINY)
        results[eng] = c.execute(sql).fetchall()
        c.close()
    assert results["auto"] == results[engine]
    assert len(results["auto"]) > 0


def test_exchange_single_consumer_frees_chunks(tmp_path):
    """FORWARD-edge refcounting: with retention off, each chunk (memory and
    spill file) is released as its one reader consumes it."""
    import os

    from repro_torch.core.runtime.exchange import Exchange, ExchangeConfig
    from repro_torch.core.runtime.vector import VectorBatch

    cfg = ExchangeConfig({"exchange.buffer_rows": 64},
                         scratch_dir=str(tmp_path / "scratch"))
    ex = Exchange("v1", cfg)
    ex.retain = False
    for i in range(6):
        ex.put(VectorBatch({"x": np.arange(48) + i * 48}))
    ex.close()
    assert ex.spilled_chunks > 0  # budget forced some chunks to disk
    spilled = [s.path for s in ex._slots
               if type(s).__name__ == "_DiskSlot"]
    rows = sum(b.num_rows for b in ex.reader())
    assert rows == 6 * 48
    st = ex.stats()
    assert st["freed_chunks"] == 6
    assert all(slot is None for slot in ex._slots)
    assert all(not os.path.exists(p) for p in spilled)  # unlinked on read
    # a second pass over a single-consumer edge is a hard error, not junk
    with pytest.raises(RuntimeError, match="already freed"):
        next(iter(ex.reader()))
    ex.discard()
    cfg.cleanup()


def test_multi_consumer_exchange_still_replays(tmp_path):
    from repro_torch.core.runtime.exchange import Exchange, ExchangeConfig
    from repro_torch.core.runtime.vector import VectorBatch

    cfg = ExchangeConfig({"exchange.buffer_rows": 64},
                         scratch_dir=str(tmp_path / "scratch2"))
    ex = Exchange("v2", cfg)  # retain defaults to True
    for i in range(4):
        ex.put(VectorBatch({"x": np.arange(40) + i * 40}))
    ex.close()
    first = sum(b.num_rows for b in ex.reader())
    second = sum(b.num_rows for b in ex.reader())
    assert first == second == 160
    assert ex.stats()["freed_chunks"] == 0
    ex.discard()
    cfg.cleanup()


def test_shared_scan_refcounted_retention(tmp_path):
    """Shared scans: a published exchange outlives its producer while
    consumers are attached; the last release discards spill files and runs
    the deferred cleanup callback exactly once."""
    import os

    from repro_torch.core.runtime.exchange import Exchange, ExchangeConfig
    from repro_torch.core.runtime.vector import VectorBatch
    from repro_torch.core.serving import SharedScanRegistry

    cfg = ExchangeConfig({"exchange.buffer_rows": 64},
                         scratch_dir=str(tmp_path / "scratch3"))
    ex = Exchange("scan", cfg)  # retain defaults to True
    reg = SharedScanRegistry()
    assert reg.publish(("k",), "t", ex)
    assert not reg.publish(("k",), "t", Exchange("dup", cfg))  # key taken
    for i in range(5):
        ex.put(VectorBatch({"x": np.arange(50) + i * 50}))
    ex.close()
    assert ex.spilled_chunks > 0
    spilled = [s.path for s in ex._slots if type(s).__name__ == "_DiskSlot"]

    h1 = reg.attach(("k",))
    h2 = reg.attach(("k",))
    assert h1 is not None and h2 is not None

    cleaned = []
    # producer tears down first: consumers still attached, so the registry
    # keeps the exchange and defers the producer's cleanup
    assert reg.retire(("k",), ex, on_final=lambda: cleaned.append(1)) is False
    assert reg.attach(("k",)) is None  # retired: no NEW attachments
    assert sum(b.num_rows for b in h1.reader()) == 250
    h1.release()
    h1.release()  # idempotent
    assert cleaned == []  # one consumer still attached
    assert all(os.path.exists(p) for p in spilled)
    assert sum(b.num_rows for b in h2.reader()) == 250  # full replay
    h2.release()
    assert cleaned == [1]  # deferred cleanup ran exactly once
    assert all(not os.path.exists(p) for p in spilled)  # discarded
    assert reg.stats_snapshot()["live_entries"] == 0
    cfg.cleanup()


def test_forward_edges_freed_during_pipelined_query(conn):
    """End-to-end: a pipelined scan->project query runs with single-consumer
    edges freeing as they go, and results stay correct."""
    rows = conn.execute(
        "SELECT fk, v FROM fact WHERE v > 5").fetchall()
    assert len(rows) > 0
    assert all(v > 5 for _, v in rows)
