"""The port's stripe reader: one zip-directory parse per file and scan.

A stripe file is a zip of one member per (stripe, column) plus a JSON
footer.  The port opens each file once per scan (``StripeFileReader``) and
reads the footer and every column through that one parse, on the plain path
and on LLAP's I/O pool; the reference's ``read_stripe_column`` opens the zip
again for every column.  Parses are counted by patching the
``zipfile.ZipFile`` constructor; the bytes read must equal the reference's.
"""
import os
import zipfile

import numpy as np
import pytest

from repro.core.storage import read_stripe_column as ref_read_stripe_column

import repro_torch.api as tdb
from repro_torch.core.acid import AcidTable, PlainIO
from repro_torch.core.compaction import compact_partition
from repro_torch.core.metastore import Metastore
from repro_torch.core.runtime.llap import LlapDaemon, LlapIO
from repro_torch.core.runtime.vector import VectorBatch
from repro_torch.core.session import Warehouse
from repro_torch.core.storage import DEFAULT_STRIPE_ROWS, StripeFileReader

STRIPES = 40
ROWS = STRIPES * DEFAULT_STRIPE_ROWS - 100  # the last stripe is ragged


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    return VectorBatch({
        "k": np.arange(n, dtype=np.int64) + seed * n,
        "v": rng.normal(size=n),
        "s": np.array(["a", "bb", "ccc"])[rng.integers(0, 3, n)],
    })


def _insert(hms, tbl, batch):
    tx = hms.open_txn()
    tbl.insert(tx, batch)
    hms.commit_txn(tx)


@pytest.fixture(scope="module")
def warehouse(tmp_path_factory):
    """A table of two 40-stripe files (two inserts, two delta stores)."""
    path = str(tmp_path_factory.mktemp("stripes"))
    hms = Metastore(path)
    hms.create_table("t", [("k", "BIGINT"), ("v", "DOUBLE"), ("s", "STRING")])
    tbl = AcidTable(hms.get_table("t"), hms)
    for seed in (1, 2):
        _insert(hms, tbl, _batch(ROWS, seed))
    hms.close()
    return path


def _files(location):
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(location)
                  for f in fs if f.endswith(".tahoe"))


class _Parses:
    """Counts read-mode ``zipfile.ZipFile`` constructions per path and
    keeps every archive, to check that each was closed."""

    def __init__(self, monkeypatch):
        self.paths = []
        self.archives = []
        real = zipfile.ZipFile
        parses = self

        class Counting(real):
            def __init__(self, file, mode="r", *args, **kwargs):
                super().__init__(file, mode, *args, **kwargs)
                if mode == "r" and isinstance(file, str):
                    parses.paths.append(file)
                    parses.archives.append(self)

        monkeypatch.setattr(zipfile, "ZipFile", Counting)

    def per_file(self):
        return {p: self.paths.count(p) for p in set(self.paths)}

    def all_closed(self):
        return all(zf.fp is None for zf in self.archives)


def _scan(hms, io):
    desc = hms.get_table("t")
    wid = hms.writeid_list("t", hms.get_snapshot())
    rows = 0
    for _, chunk in AcidTable(desc, hms).scan_chunks(wid, io=io):
        rows += chunk.num_rows
    return rows


@pytest.mark.parametrize("io_kind", ["plain", "llap"])
def test_cold_scan_parses_each_file_once(warehouse, monkeypatch, io_kind):
    hms = Metastore(warehouse)
    files = _files(hms.get_table("t").location)
    assert len(files) == 2
    daemon = LlapDaemon() if io_kind == "llap" else None
    io = PlainIO() if daemon is None else LlapIO(daemon)
    parses = _Parses(monkeypatch)
    try:
        assert _scan(hms, io) == 2 * ROWS
        assert parses.per_file() == {f: 1 for f in files}
        assert parses.all_closed()
        if daemon is not None:
            # a warm scan is served from LLAP's footer and chunk caches
            assert daemon.counters["cache_misses"] == 2 * STRIPES * 5
            assert _scan(hms, io) == 2 * ROWS
            assert len(parses.paths) == 2
            assert daemon.counters["cache_hits"] == 2 * STRIPES * 5
    finally:
        if daemon is not None:
            daemon.shutdown()
        hms.close()


def test_columns_match_reference_reader(warehouse):
    hms = Metastore(warehouse)
    try:
        files = _files(hms.get_table("t").location)
    finally:
        hms.close()
    for path in files:
        with StripeFileReader(path) as reader:
            meta = reader.read_meta()
            assert len(meta.stripes) == STRIPES
            chunks = list(PlainIO().read_file_chunks(path))
            assert len(chunks) == STRIPES
            for si, chunk in enumerate(chunks):
                for col in meta.columns:
                    exp = ref_read_stripe_column(path, si, col)
                    got = reader.read_column(si, col)
                    assert got.dtype == exp.dtype, (si, col)
                    assert got.tobytes() == exp.tobytes(), (si, col)
                    assert chunk.cols[col].tobytes() == exp.tobytes()


def test_reader_refuses_reads_after_close(warehouse):
    hms = Metastore(warehouse)
    try:
        path = _files(hms.get_table("t").location)[0]
    finally:
        hms.close()
    reader = StripeFileReader(path)
    reader.read_column(0, "k")
    reader.close()
    with pytest.raises(ValueError, match="closed"):
        reader.read_column(1, "k")


def _open_tahoe_fds():
    fds = []
    for fd in os.listdir("/proc/self/fd"):
        try:
            target = os.readlink(f"/proc/self/fd/{fd}")
        except OSError:
            continue
        if target.endswith(".tahoe"):
            fds.append(target)
    return fds


def test_no_file_left_open_after_close(warehouse, monkeypatch):
    """Queries through the API (LLAP on, an abandoned LIMIT scan among
    them) leave no stripe file open once the warehouse closes."""
    parses = _Parses(monkeypatch)
    wh = Warehouse(warehouse)
    try:
        with tdb.connect(warehouse=wh, engine="auto",
                         result_cache=False) as conn:
            assert conn.execute("SELECT COUNT(*), SUM(k) FROM t"
                                ).fetchall()[0][0] == 2 * ROWS
            assert len(conn.execute("SELECT k FROM t LIMIT 3").fetchall()) == 3
    finally:
        wh.close()
    assert parses.archives and parses.all_closed()
    assert _open_tahoe_fds() == []


def test_compaction_and_recreate_serve_fresh_bytes(tmp_path):
    """Files replaced by compaction, and a table dropped and created again
    at the same path, are never answered from stale readers or caches."""
    path = str(tmp_path / "wh")
    with tdb.connect(path, engine="auto", result_cache=False) as conn:
        conn.execute("CREATE TABLE c (x INT)")
        conn.execute("INSERT INTO c VALUES (1), (2)")
        conn.execute("INSERT INTO c VALUES (3)")
        assert conn.execute("SELECT SUM(x) FROM c").fetchall() == [(6,)]
        hms = conn.warehouse.hms
        tbl = AcidTable(hms.get_table("c"), hms)
        compact_partition(tbl, tbl.desc.location, "major", hms)
        conn.execute("INSERT INTO c VALUES (10)")
        assert conn.execute("SELECT SUM(x) FROM c").fetchall() == [(16,)]
        conn.execute("DROP TABLE c")
        conn.execute("CREATE TABLE c (x INT)")
        conn.execute("INSERT INTO c VALUES (100)")
        assert conn.execute("SELECT SUM(x) FROM c").fetchall() == [(100,)]


def test_tombstone_probe_equals_isin():
    """The merge-on-read anti-join probes the scan's sorted tombstones by
    binary search (``acid._in_sorted``): the same mask as ``np.isin``, keys
    below, between and above the tombstones included."""
    from repro_torch.core.acid import _in_sorted

    rng = np.random.default_rng(5)
    for n_tombs in (1, 7, 5000):
        tombs = np.unique(rng.integers(-1000, 1 << 40, n_tombs))
        keys = np.concatenate([rng.choice(tombs, 300),
                               rng.integers(-2000, (1 << 40) + 10, 3000),
                               [tombs[0] - 1, tombs[-1] + 1, tombs[-1]]])
        assert np.array_equal(_in_sorted(keys, tombs), np.isin(keys, tombs))
    assert _in_sorted(np.empty(0, np.int64), np.array([3])).size == 0
