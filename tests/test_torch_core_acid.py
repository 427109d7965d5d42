"""ACID / transaction-manager behaviour (paper §3.2)."""
from _torch_core import warehouse  # noqa: F401
import numpy as np
import pytest
from _hypothesis_compat import HealthCheck, given, settings, st

from repro_torch.core.acid import AcidTable, list_stores
from repro_torch.core.compaction import CompactionConfig, compact_partition, maybe_compact
from repro_torch.core.metastore import LockConflict, Metastore, WriteConflict
from repro_torch.core.runtime.vector import VectorBatch


def _mk(hms, name="t", partitioned=False):
    cols = [("k", "INT"), ("v", "DOUBLE")]
    pcols = []
    if partitioned:
        cols.append(("p", "INT"))
        pcols = ["p"]
    hms.create_table(name, cols, partition_cols=pcols)
    return AcidTable(hms.get_table(name), hms)


def _insert(hms, tbl, ks, vs, ps=None):
    tx = hms.open_txn()
    cols = {"k": np.asarray(ks), "v": np.asarray(vs, dtype=float)}
    if ps is not None:
        cols["p"] = np.asarray(ps)
    tbl.insert(tx, VectorBatch(cols))
    hms.commit_txn(tx)
    return tx


def _read_ks(hms, tbl):
    wl = hms.writeid_list(tbl.desc.name, hms.get_snapshot())
    return sorted(tbl.read_all(wl).cols["k"].tolist())


def test_snapshot_isolation_uncommitted_invisible(tmp_path):
    hms = Metastore(str(tmp_path))
    tbl = _mk(hms)
    _insert(hms, tbl, [1, 2], [1.0, 2.0])
    tx = hms.open_txn()
    tbl.insert(tx, VectorBatch({"k": np.array([3]), "v": np.array([3.0])}))
    assert _read_ks(hms, tbl) == [1, 2]  # open txn invisible
    hms.commit_txn(tx)
    assert _read_ks(hms, tbl) == [1, 2, 3]


def test_aborted_rows_never_visible(tmp_path):
    hms = Metastore(str(tmp_path))
    tbl = _mk(hms)
    tx = hms.open_txn()
    tbl.insert(tx, VectorBatch({"k": np.array([9]), "v": np.array([9.0])}))
    hms.abort_txn(tx)
    assert _read_ks(hms, tbl) == []
    # even after compaction
    compact_partition(tbl, tbl.desc.location, "major", hms)
    assert _read_ks(hms, tbl) == []


def test_old_snapshot_sees_deleted_rows(tmp_path):
    hms = Metastore(str(tmp_path))
    tbl = _mk(hms)
    _insert(hms, tbl, [1, 2, 3], [1, 2, 3])
    old_wl = hms.writeid_list("t", hms.get_snapshot())
    tx = hms.open_txn()
    tbl.delete(tx, {(): np.array([[1, 0]], dtype=np.int64)})
    hms.commit_txn(tx)
    assert _read_ks(hms, tbl) == [2, 3]
    assert sorted(tbl.read_all(old_wl).cols["k"].tolist()) == [1, 2, 3]


def test_first_commit_wins_conflict(tmp_path):
    hms = Metastore(str(tmp_path))
    tbl = _mk(hms, partitioned=True)
    _insert(hms, tbl, [1, 2], [1, 2], ps=[0, 0])
    ta, tb = hms.open_txn(), hms.open_txn()
    tbl.delete(ta, {(0,): np.array([[1, 0]], dtype=np.int64)})
    tbl.delete(tb, {(0,): np.array([[1, 1]], dtype=np.int64)})
    hms.commit_txn(ta)
    with pytest.raises(WriteConflict):
        hms.commit_txn(tb)
    assert hms.txn_state(tb) == "aborted"


def test_disjoint_partitions_no_conflict(tmp_path):
    hms = Metastore(str(tmp_path))
    tbl = _mk(hms, partitioned=True)
    _insert(hms, tbl, [1, 2], [1, 2], ps=[0, 1])
    ta, tb = hms.open_txn(), hms.open_txn()
    tbl.delete(ta, {(0,): np.array([[1, 0]], dtype=np.int64)})
    tbl.delete(tb, {(1,): np.array([[1, 0]], dtype=np.int64)})
    hms.commit_txn(ta)
    hms.commit_txn(tb)  # no conflict


def test_exclusive_lock_blocks(tmp_path):
    hms = Metastore(str(tmp_path))
    _mk(hms)
    ta, tb = hms.open_txn(), hms.open_txn()
    hms.acquire_lock(ta, "t", None, "exclusive")
    with pytest.raises(LockConflict):
        hms.acquire_lock(tb, "t", None, "shared")
    hms.abort_txn(ta)  # releases locks
    hms.acquire_lock(tb, "t", None, "shared")


def test_compaction_equivalence_and_cleanup(tmp_path):
    hms = Metastore(str(tmp_path))
    tbl = _mk(hms)
    for i in range(6):
        _insert(hms, tbl, [i * 10 + j for j in range(5)], [0.0] * 5)
    tx = hms.open_txn()
    tbl.delete(tx, {(): np.array([[1, 0], [2, 1]], dtype=np.int64)})
    hms.commit_txn(tx)
    before = _read_ks(hms, tbl)
    # minor first, then major
    compact_partition(tbl, tbl.desc.location, "minor", hms)
    assert _read_ks(hms, tbl) == before
    compact_partition(tbl, tbl.desc.location, "major", hms)
    assert _read_ks(hms, tbl) == before
    stores = list_stores(tbl.desc.location)
    assert [s.kind for s in stores] == ["base"]


def test_auto_compaction_thresholds(tmp_path):
    hms = Metastore(str(tmp_path))
    tbl = _mk(hms)
    for i in range(12):
        _insert(hms, tbl, [i], [float(i)])
    actions = maybe_compact(tbl, hms, CompactionConfig(
        minor_delta_threshold=10, major_ratio_threshold=100.0))
    assert any(v == "minor" for v in actions.values())


@settings(max_examples=20, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(ops=st.lists(
    st.tuples(st.sampled_from(["insert", "delete", "compact_minor",
                               "compact_major"]),
              st.integers(0, 99)),
    min_size=1, max_size=20))
def test_property_acid_matches_oracle(tmp_path_factory, ops):
    """Random interleavings of insert/delete/compaction match a dict oracle."""
    hms = Metastore(str(tmp_path_factory.mktemp("acid")))
    tbl = _mk(hms)
    oracle = {}  # k -> v (id-keyed rows)
    next_key = [0]
    for op, arg in ops:
        if op == "insert":
            ks = [next_key[0] + i for i in range(arg % 4 + 1)]
            next_key[0] += len(ks)
            _insert(hms, tbl, ks, [float(k) for k in ks])
            for k in ks:
                oracle[k] = float(k)
        elif op == "delete" and oracle:
            victim = sorted(oracle)[arg % len(oracle)]
            wl = hms.writeid_list("t", hms.get_snapshot())
            full = tbl.read_all(wl, keep_acid_cols=True)
            mask = full.cols["k"] == victim
            t = np.stack([full.cols["__writeid__"][mask],
                          full.cols["__rowid__"][mask]], axis=1)
            tx = hms.open_txn()
            tbl.delete(tx, {(): t})
            hms.commit_txn(tx)
            del oracle[victim]
        elif op == "compact_minor":
            compact_partition(tbl, tbl.desc.location, "minor", hms)
        else:
            compact_partition(tbl, tbl.desc.location, "major", hms)
        assert _read_ks(hms, tbl) == sorted(oracle)


# ---------------------------------------------------------------------------
# DDL invalidation (seed bug regression): DROP + CREATE under the same name
# ---------------------------------------------------------------------------
def test_drop_create_same_name_purges_old_rows(warehouse):
    """DROP TABLE must purge the managed table's data files and LLAP cache,
    so a re-created table with the same name never scans stale delta stores
    (the seed bug: 4 old + 4 new rows, COUNT(*) said 8)."""
    s = warehouse.session(engine="auto")
    s.execute("CREATE TABLE dr (a INT)")
    s.execute("INSERT INTO dr VALUES (1), (2), (3), (4)")
    assert s.execute("SELECT COUNT(*) FROM dr").rows == [(4,)]
    s.execute("SELECT a FROM dr")  # warm the LLAP chunk/meta caches
    s.execute("DROP TABLE dr")
    s.execute("CREATE TABLE dr (a INT)")
    s.execute("INSERT INTO dr VALUES (10), (20), (30), (40)")
    assert s.execute("SELECT COUNT(*) FROM dr").rows == [(4,)]
    assert s.execute("SELECT a FROM dr ORDER BY a").rows == \
        [(10,), (20,), (30,), (40,)]


def test_drop_table_removes_data_dir_and_llap_entries(warehouse):
    import os

    s = warehouse.session(engine="auto")
    s.execute("CREATE TABLE gone (a INT)")
    s.execute("INSERT INTO gone VALUES (1), (2)")
    loc = warehouse.hms.get_table("gone").location
    s.execute("SELECT a FROM gone")
    assert os.path.isdir(loc)
    cached = [p for p in warehouse.llap._meta if p.startswith(loc)]
    assert cached  # scan populated the footer cache
    s.execute("DROP TABLE gone")
    assert not os.path.isdir(loc)
    assert not [p for p in warehouse.llap._meta if p.startswith(loc)]
