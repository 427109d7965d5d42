"""Tests for the correctness toolkit: invariant lint (REP001..REP007),
lockdep sanitizer, structural plan validator, and the config-key registry
they hang off."""
from _torch_core import warehouse  # noqa: F401
import os
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import pytest

import repro_torch.api as db
from repro_torch.analysis import lint
from repro_torch.analysis import lockdep
from repro_torch.analysis.plan_validator import (PlanValidationError, check_dag,
                                           validate_dag)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO_ROOT, "src")
FIXTURE = os.path.join(REPO_ROOT, "tests", "fixtures", "lint_violations.py")


# ===========================================================================
# invariant lint
# ===========================================================================
class TestLint:
    def test_fixture_seeds_every_checker(self):
        findings = lint.lint_file(FIXTURE)
        codes = sorted(f.code for f in findings)
        assert codes == ["REP001", "REP002", "REP003", "REP004", "REP004",
                         "REP005", "REP005", "REP006", "REP007"]

    def test_rep001_declared_key_passes(self):
        src = 'def f(config):\n    return config.get("cbo", True)\n'
        assert lint.lint_source(src, "core/x.py") == []

    def test_rep001_undeclared_key_fires(self):
        src = 'def f(config):\n    return config.get("cbo_typo", True)\n'
        fs = lint.lint_source(src, "core/x.py")
        assert [f.code for f in fs] == ["REP001"]
        assert "cbo_typo" in fs[0].message

    def test_rep001_scope_excludes_model_code(self):
        src = 'def f(config):\n    return config.get("lr", 0.1)\n'
        assert lint.lint_source(src, "src/repro_torch/models/x.py") == []

    def test_rep002_checked_loop_passes(self):
        src = ("def g(self, ex):\n"
               "    for chunk in ex.reader():\n"
               "        self._checkpoint()\n"
               "        yield chunk\n")
        assert lint.lint_source(src, "core/x.py") == []

    def test_rep002_non_generator_loop_exempt(self):
        src = ("def drain(ex):\n"
               "    out = []\n"
               "    for chunk in ex.reader():\n"
               "        out.append(chunk)\n"
               "    return out\n")
        assert lint.lint_source(src, "core/x.py") == []

    def test_rep003_allowlisted_site_passes(self):
        src = ("def _stream_sort(self, node):\n"
               "    return self._collect(node)\n")
        assert lint.lint_source(src, "src/repro_torch/core/runtime/exec.py") == []
        fs = lint.lint_source(src, "src/repro_torch/core/runtime/dag.py")
        assert [f.code for f in fs] == ["REP003"]

    def test_rep004_with_statement_passes(self):
        src = ("def f(lock):\n"
               "    with lock:\n"
               "        pass\n")
        assert lint.lint_source(src, "core/x.py") == []

    def test_rep004_acquire_try_finally_passes(self):
        src = ("def f(lock):\n"
               "    lock.acquire()\n"
               "    try:\n"
               "        pass\n"
               "    finally:\n"
               "        lock.release()\n")
        assert lint.lint_source(src, "core/x.py") == []

    def test_rep004_wait_for_and_event_wait_exempt(self):
        src = ("def f(cond, done):\n"
               "    with cond:\n"
               "        cond.wait_for(lambda: True)\n"
               "    done.wait(60)\n")  # Event.wait: receiver not a cond
        assert lint.lint_source(src, "core/x.py") == []

    def test_rep005_mutation_outside_adopt_fires(self):
        src = ("def steal(dag):\n"
               "    dag.vertices.pop('v1', None)\n"
               "    dag.vertices['v9'] = object()\n")
        fs = lint.lint_source(src, "src/repro_torch/core/runtime/scheduler.py")
        assert [f.code for f in fs] == ["REP005", "REP005"]

    def test_rep006_dict_literal_in_operator_fires(self):
        src = ("def _stream_x(self, node):\n"
               "    for b in self.stream(node.input):\n"
               "        yield VectorBatch({'v': b.cols['v'] * 2})\n")
        fs = lint.lint_source(src, "src/repro_torch/core/runtime/exec.py")
        assert [f.code for f in fs] == ["REP006"]
        assert "'v'" in fs[0].message

    def test_rep006_derived_and_dunder_pass(self):
        src = ("def _stream_x(self, node):\n"
               "    for b in self.stream(node.input):\n"
               "        yield VectorBatch({k: v for k, v in b.cols.items()})\n"
               "        yield VectorBatch(dict(zip(node.names, b.cols.values())))\n"
               "        yield VectorBatch({'__dummy__': b.cols['v']})\n")
        assert lint.lint_source(src, "src/repro_torch/core/runtime/exec.py") == []

    def test_rep006_non_generator_passes(self):
        # result assembly outside operators (EXPLAIN output, CLI tables)
        # may hard-code columns: the rule is scoped to streaming operators
        src = ("def explain(self, sql):\n"
               "    return VectorBatch({'plan': lines})\n")
        assert lint.lint_source(src, "src/repro_torch/core/session.py") == []

    def test_rep005_reads_pass(self):
        src = ("def peek(dag):\n"
               "    v = dag.vertices['v1']\n"
               "    return list(v.deps), dict(v.edge_types)\n")
        assert lint.lint_source(src, "src/repro_torch/core/runtime/x.py") == []

    def test_rep005_apply_undo_closures_allowed_in_adaptive(self):
        src = ("def _collapse(self, dag):\n"
               "    def apply():\n"
               "        dag.vertices.pop('v1', None)\n"
               "    def undo():\n"
               "        dag.vertices['v1'] = object()\n"
               "    self._adopt(apply, undo, {})\n")
        path = "src/repro_torch/core/runtime/adaptive.py"
        assert lint.lint_source(src, path) == []
        # the same mutations outside apply/undo still fire in adaptive.py
        bad = ("def _collapse(self, dag):\n"
               "    dag.vertices.pop('v1', None)\n")
        assert [f.code for f in lint.lint_source(bad, path)] == ["REP005"]

    def test_rep005_dag_py_construction_allowed(self):
        src = ("def compile_dag(plan):\n"
               "    dag.vertices['v1'] = object()\n"
               "    vertex.deps = ['v2']\n")
        assert lint.lint_source(src, "src/repro_torch/core/runtime/dag.py") == []

    def test_suppression_comment(self):
        src = ('def f(config):\n'
               '    return config.get("oops")  # repro-lint: REP001\n')
        assert lint.lint_source(src, "core/x.py") == []

    def test_repo_is_clean(self):
        findings = lint.lint_paths([os.path.join(SRC, "repro_torch")])
        assert findings == [], "\n".join(str(f) for f in findings)

    def test_cli_exit_codes(self):
        env = dict(os.environ, PYTHONPATH=SRC)
        clean = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis",
             os.path.join(SRC, "repro_torch")],
            capture_output=True, text=True, env=env, cwd=REPO_ROOT)
        assert clean.returncode == 0, clean.stdout + clean.stderr
        dirty = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", FIXTURE],
            capture_output=True, text=True, env=env, cwd=REPO_ROOT)
        assert dirty.returncode == 1, dirty.stdout + dirty.stderr
        for code in ("REP001", "REP002", "REP003", "REP004", "REP005",
                     "REP006", "REP007"):
            assert code in dirty.stdout


# ===========================================================================
# lockdep sanitizer
# ===========================================================================
@pytest.fixture()
def lockdep_on(monkeypatch):
    monkeypatch.setenv("REPRO_LOCKDEP", "1")
    lockdep.reset()
    yield
    lockdep.reset()


class TestLockdep:
    def test_factory_off_returns_plain_primitives(self, monkeypatch):
        monkeypatch.delenv("REPRO_LOCKDEP", raising=False)
        assert type(lockdep.make_lock("x")) is type(threading.Lock())
        assert isinstance(lockdep.make_condition(name="x"),
                          threading.Condition)
        assert not isinstance(lockdep.make_condition(name="x"),
                              lockdep.TrackedCondition)

    def test_ab_ba_inversion_detected_deterministically(self, lockdep_on):
        """One AB acquisition then one BA acquisition — in sequence, no
        interleaving race — must raise LockOrderError every run."""
        a, b = lockdep.make_lock("lk.A"), lockdep.make_lock("lk.B")
        with a:
            with b:
                pass
        caught = []

        def inverted():
            try:
                with b:
                    with a:
                        pass
            except lockdep.LockOrderError as exc:
                caught.append(exc)

        t = threading.Thread(target=inverted)
        t.start()
        t.join(10)
        assert len(caught) == 1
        assert "lk.A" in str(caught[0]) and "lk.B" in str(caught[0])

    def test_three_lock_cycle_detected(self, lockdep_on):
        a, b, c = (lockdep.make_lock(n) for n in ("c3.A", "c3.B", "c3.C"))
        with a, b:
            pass
        with b, c:
            pass
        with pytest.raises(lockdep.LockOrderError):
            with c, a:
                pass

    def test_consistent_order_never_raises(self, lockdep_on):
        a, b = lockdep.make_lock("ok.A"), lockdep.make_lock("ok.B")
        for _ in range(50):
            with a, b:
                pass
        assert lockdep.graph_snapshot()["ok.A"] == {"ok.B"}

    def test_reentrant_rlock_no_self_edge(self, lockdep_on):
        r = lockdep.make_rlock("re.R")
        with r, r:
            pass
        assert "re.R" not in lockdep.graph_snapshot()

    def test_same_name_siblings_not_a_cycle(self, lockdep_on):
        # lane arrays create many same-class locks; holding one while
        # touching another (in either order) must not trip the detector
        e1, e2 = lockdep.make_lock("exchange"), lockdep.make_lock("exchange")
        with e1:
            with e2:
                pass
        with e2:
            with e1:
                pass

    def test_condition_wait_releases_held_set(self, lockdep_on):
        """A waiter holding the condition's lock must not contribute order
        edges while parked in wait() — the lock is released for the wait."""
        shard = lockdep.make_rlock("cv.shard")
        cond = lockdep.make_condition(shard, name="cv.shard.cond")
        glob = lockdep.make_lock("cv.global")
        ready, done, waiter_errors = [], [], []

        def waiter():
            try:
                with cond:
                    ready.append(1)
                    while not done:
                        cond.wait(0.5)
                # shard fully released by the with-exit above: taking the
                # global lock here records no shard->global edge, so the
                # notifier's global->shard edge below is not a cycle.  A
                # wait() that failed to untrack would instead record
                # shard->global during the blocked wait and this (or the
                # notifier) would raise LockOrderError.
                with glob:
                    pass
            except BaseException as exc:  # noqa: BLE001 - asserted below
                waiter_errors.append(exc)

        t = threading.Thread(target=waiter)
        t.start()
        for _ in range(100):
            if ready:
                break
            time.sleep(0.01)
        # notifier takes global first, then the condition's shard lock
        with glob:
            with cond:
                done.append(1)
                cond.notify_all()
        t.join(10)
        assert not t.is_alive()
        assert not waiter_errors, waiter_errors

    def test_failed_nonblocking_acquire_not_tracked(self, lockdep_on):
        lk = lockdep.make_lock("nb.L")
        other = lockdep.make_lock("nb.M")
        hold = threading.Thread(
            target=lambda: (lk.acquire(), time.sleep(0.2), lk.release()))
        hold.start()
        time.sleep(0.05)
        with other:
            assert lk.acquire(blocking=False) is False
        hold.join()
        # a failed acquire records the attempt edge but must not leave nb.L
        # in this thread's held set
        with lk:
            pass

    def test_wlm_documented_order_is_acyclic(self, lockdep_on, tmp_path):
        """End-to-end: real queries through WLM/scheduler/exchange/serving
        under lockdep leave an acyclic graph (no exception) with the
        documented shard->global edge present."""
        conn = db.connect(str(tmp_path / "wh"), engine="auto")
        conn.execute("CREATE TABLE t (a INT, b INT)")
        conn.execute("INSERT INTO t VALUES " + ", ".join(
            f"({i % 7}, {i})" for i in range(200)))
        for _ in range(2):
            rows = conn.execute(
                "SELECT a, SUM(b) AS s FROM t GROUP BY a ORDER BY a"
            ).fetchall()
            assert len(rows) == 7
        h = conn.execute_async("SELECT COUNT(*) FROM t")
        assert h.result().fetchall() == [(200,)]
        conn.close()
        g = lockdep.graph_snapshot()
        assert "wlm.global" in g.get("wlm.shard", set())


@pytest.mark.slow
def test_serving_stress_cycle_free_under_lockdep(tmp_path, monkeypatch):
    """32-client mixed workload (shared scans + result cache + WLM + async)
    with every runtime lock tracked: completes with no LockOrderError."""
    monkeypatch.setenv("REPRO_LOCKDEP", "1")
    lockdep.reset()
    from repro_torch.core.session import Warehouse

    wh = Warehouse(str(tmp_path / "wh"), query_workers=32)
    base = db.connect(warehouse=wh, engine="auto")
    cur = base.cursor()
    cur.execute("CREATE TABLE d (k INT, yr INT, w DOUBLE)")
    cur.execute("INSERT INTO d VALUES " +
                ", ".join(f"({i}, {1992 + i % 6}, {i * 0.5})"
                          for i in range(48)))
    cur.execute("CREATE TABLE f (fk INT, rev INT)")
    rng = np.random.default_rng(11)
    fk = rng.integers(0, 48, 4000)
    rev = rng.integers(1, 500, 4000)
    cur.execute("INSERT INTO f VALUES " + ", ".join(
        f"({int(a)}, {int(b)})" for a, b in zip(fk, rev)))

    repeated = ["SELECT yr, SUM(rev) AS s FROM f, d WHERE fk = k GROUP BY yr",
                "SELECT COUNT(*) AS n FROM f"]
    errors = []

    def client(cid):
        try:
            c = db.connect(warehouse=wh, engine="auto")
            r = np.random.default_rng(cid)
            for j in range(3):
                if r.uniform() < 0.5:
                    sql = repeated[int(r.integers(len(repeated)))]
                else:
                    sql = (f"SELECT yr, SUM(rev) AS s FROM f, d WHERE fk = k"
                           f" AND yr >= {1992 + (cid * 3 + j) % 5}"
                           f" GROUP BY yr")
                assert c.execute(sql).fetchall()
        except Exception as exc:  # noqa: BLE001 - surfaced below
            errors.append((cid, exc))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(32)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    alive = any(t.is_alive() for t in threads)
    base.close()
    wh.close()
    lockdep.reset()
    assert not alive, "client threads deadlocked"
    inversions = [e for _, e in errors
                  if isinstance(e, lockdep.LockOrderError)
                  or "lock-order inversion" in str(e)]
    assert not inversions, inversions[:3]
    assert not errors, errors[:3]


# ===========================================================================
# plan validator
# ===========================================================================
def _leaf(names):
    from repro_torch.core.optimizer import plan as P

    class _Leaf(P.PlanNode):
        def __init__(self, names):
            self.names = list(names)
            self.inputs = []

        def output_names(self):
            return list(self.names)

        def key(self):
            return f"leaf({','.join(self.names)})"

    return _Leaf(names)


def _dag(vertices, root):
    from repro_torch.core.runtime.dag import TaskDAG

    return TaskDAG(vertices, root)


def _vertex(vid, plan, deps=(), edge_types=None):
    from repro_torch.core.runtime.dag import Vertex

    return Vertex(vid, plan, deps=list(deps), edge_types=edge_types or {})


class TestPlanValidator:
    def test_valid_two_vertex_dag(self):
        from repro_torch.core.runtime.dag import MaterializedNode

        producer = _vertex("v1", _leaf(["a"]))
        root = _vertex("v2", MaterializedNode(["a"], "v1"), deps=["v1"])
        assert validate_dag(_dag({"v1": producer, "v2": root}, "v2")) == []

    def test_unknown_placeholder_tag(self):
        from repro_torch.core.runtime.dag import MaterializedNode

        root = _vertex("v2", MaterializedNode(["a"], "ghost"),
                       deps=["ghost"])
        vs = validate_dag(_dag({"v2": root}, "v2"))
        assert any("unknown vertex 'ghost'" in v for v in vs)

    def test_orphan_vertex_flagged(self):
        from repro_torch.core.runtime.dag import MaterializedNode

        producer = _vertex("v1", _leaf(["a"]))
        orphan = _vertex("v9", _leaf(["z"]))
        root = _vertex("v2", MaterializedNode(["a"], "v1"), deps=["v1"])
        vs = validate_dag(_dag({"v1": producer, "v9": orphan, "v2": root},
                               "v2"))
        assert any("v9" in v and "unreachable" in v for v in vs)
        assert any("v9" in v and "no consumer" in v for v in vs)

    def test_deps_disagree_with_placeholders(self):
        from repro_torch.core.runtime.dag import MaterializedNode

        producer = _vertex("v1", _leaf(["a"]))
        root = _vertex("v2", MaterializedNode(["a"], "v1"), deps=[])
        vs = validate_dag(_dag({"v1": producer, "v2": root}, "v2"))
        assert any("deps missing" in v for v in vs)

    def test_lane_out_of_range_and_uncovered(self):
        from repro_torch.core.optimizer import plan as P
        from repro_torch.core.runtime.dag import MaterializedNode, Vertex

        producer = _vertex("v1", _leaf(["a"]))
        # two lanes declared, readers for lanes 0 and 5 (out of range),
        # lane 1 never read
        u = P.Union([
            MaterializedNode(["a"], "v1", partition=0, num_partitions=2,
                             partition_keys=["a"]),
            MaterializedNode(["a"], "v1", partition=5, num_partitions=2,
                             partition_keys=["a"]),
        ])
        root = Vertex("v2", u, deps=["v1"])
        vs = validate_dag(_dag({"v1": producer, "v2": root}, "v2"))
        assert any("out of range" in v for v in vs)
        assert any("no reader" in v for v in vs)

    def test_leftover_shuffleread(self):
        from repro_torch.core.optimizer import plan as P

        inner = _leaf(["a"])
        sr = P.ShuffleRead(inner, ["a"], 0, 2)
        root = _vertex("v1", sr)
        vs = validate_dag(_dag({"v1": root}, "v1"))
        assert any("ShuffleRead" in v for v in vs)

    def test_plan_cache_aliasing_detected(self):
        from types import SimpleNamespace

        shared = _leaf(["a"])
        root = _vertex("v1", shared)
        cache = SimpleNamespace(
            _lock=threading.Lock(),
            _entries={"k1": SimpleNamespace(plan=shared)})
        vs = validate_dag(_dag({"v1": root}, "v1"), plan_cache=cache)
        assert any("cached plan" in v for v in vs)
        with pytest.raises(PlanValidationError):
            check_dag(_dag({"v1": root}, "v1"), plan_cache=cache)

    def test_check_dag_passes_clean(self):
        root = _vertex("v1", _leaf(["a"]))
        check_dag(_dag({"v1": root}, "v1"))  # must not raise

    def test_config_gate_without_env(self, tmp_path, monkeypatch):
        """debug.validate_plans turns validation on for one session even
        when the env var is unset (and the default leaves it off)."""
        monkeypatch.delenv("REPRO_VALIDATE_PLANS", raising=False)
        from repro_torch.analysis.plan_validator import validation_enabled

        assert not validation_enabled({})
        assert validation_enabled({"debug.validate_plans": True})
        conn = db.connect(str(tmp_path / "wh"),
                          **{"debug.validate_plans": True}, engine="auto")
        conn.execute("CREATE TABLE t (a INT)")
        conn.execute("INSERT INTO t VALUES (1), (2)")
        assert conn.execute("SELECT COUNT(*) FROM t").fetchall() == [(2,)]
        conn.close()

    def test_real_plans_validate_including_shuffle_lanes(self, tmp_path):
        """Compiled DAGs from real queries — including lane-expanded
        shuffles — pass the validator (the autouse fixture already has the
        pipeline hook enabled for this test)."""
        conn = db.connect(str(tmp_path / "wh"),
                          **{"shuffle.partitions": 3}, engine="auto")
        conn.execute("CREATE TABLE a (k INT, v INT)")
        conn.execute("CREATE TABLE b (k INT, w INT)")
        conn.execute("INSERT INTO a VALUES " + ", ".join(
            f"({i % 11}, {i})" for i in range(300)))
        conn.execute("INSERT INTO b VALUES " + ", ".join(
            f"({i % 11}, {i * 2})" for i in range(300)))
        rows = conn.execute(
            "SELECT a.k, SUM(a.v + b.w) AS s FROM a, b "
            "WHERE a.k = b.k GROUP BY a.k ORDER BY a.k").fetchall()
        assert len(rows) == 11
        conn.close()


# ===========================================================================
# config-key registry
# ===========================================================================
class TestConfigRegistry:
    def test_defaults_derive_from_registry(self):
        from repro_torch.core.config_keys import CONFIG_KEYS, DEFAULT_CONFIG
        from repro_torch.core.session import DEFAULT_CONFIG as SESSION_DEFAULTS

        assert SESSION_DEFAULTS is DEFAULT_CONFIG
        assert set(DEFAULT_CONFIG) == set(CONFIG_KEYS)

    def test_planning_keys_derive_from_registry(self):
        from repro_torch.core.config_keys import PLANNING_KEYS
        from repro_torch.core.pipeline import _PLANNING_KEYS

        assert tuple(_PLANNING_KEYS) == tuple(PLANNING_KEYS)
        assert "shuffle.partitions" in PLANNING_KEYS
        assert "result_cache" not in PLANNING_KEYS  # execution-only knob

    def test_session_warns_on_unknown_key(self, warehouse):
        from repro_torch.core.config_keys import UnknownConfigKeyWarning

        with pytest.warns(UnknownConfigKeyWarning, match="shufle.partitions"):
            warehouse.session(**{"shufle.partitions": 8}, engine="auto")
        with warnings.catch_warnings():
            warnings.simplefilter("error", UnknownConfigKeyWarning)
            warehouse.session(**{"shuffle.partitions": 8}, engine="auto")

    def test_connect_rejects_unknown_and_mistyped(self, tmp_path):
        with pytest.raises(db.ProgrammingError, match="unknown config"):
            db.connect(str(tmp_path / "w1"), cbo_typo=True, engine="auto")
        with pytest.raises(db.ProgrammingError, match="expects"):
            db.connect(str(tmp_path / "w2"), engine=5)
        conn = db.connect(str(tmp_path / "w3"),
                          broadcast_threshold_rows=np.int64(100), engine="auto")
        conn.close()
