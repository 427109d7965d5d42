"""ACID table storage: base/delta layout + snapshot merge-on-read (paper §3.2).

Directory scheme inside each table (or partition) directory::

    base_<w>/              all valid records up to WriteId w   (from compaction)
    delta_<w1>_<w2>/       inserted records for WriteIds [w1, w2]
    delete_delta_<w1>_<w2>/ tombstones written by WriteIds [w1, w2]

Every record carries hidden columns (__writeid__, __rowid__); the pair
uniquely identifies a row for the lifetime of the table (it survives
compaction), which is what lets delete tombstones — themselves just inserted
records pointing at a (writeid, rowid) — be applied by an anti-join at read
time.  Updates are split into delete + insert (paper §3.2).

Readers bind a per-table WriteIdList (projection of the snapshot) to each
scan: whole stores are discarded when their WriteId range is invisible, and
row-level masks handle open/aborted writers below the high watermark.
"""
from __future__ import annotations

import os
import re
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .bloomfilter import BloomFilter
from ..analysis.lockdep import make_lock
from .metastore import Metastore, TableDesc, WriteIdList
from .runtime.vector import ROWID_COL, WRITEID_COL, VectorBatch
from .stats import TableStats, compute_column_stats
from .storage import (
    FileMeta,
    SargPredicate,
    StripeFileReader,
    read_file_meta,
    stripe_may_match,
    write_stripe_file,
)

_BASE_RE = re.compile(r"^base_(\d+)$")
_DELTA_RE = re.compile(r"^delta_(\d+)_(\d+)$")
_DELETE_RE = re.compile(r"^delete_delta_(\d+)_(\d+)$")

# Tombstone target pointers (the record being deleted).
T_WRITEID_COL = "__t_writeid__"
T_ROWID_COL = "__t_rowid__"


# --------------------------------------------------------------------------
# Pluggable I/O: the plain reader here; LLAP's caching I/O elevator implements
# the same surface in core/runtime/llap.py.
# --------------------------------------------------------------------------
class PlainIO:
    """Cold reads straight off the file system (the "container" path)."""

    def read_file_chunks(
        self,
        path: str,
        columns: Optional[Sequence[str]] = None,
        sarg_preds: Sequence[SargPredicate] = (),
        runtime_blooms: Optional[Dict[str, BloomFilter]] = None,
    ) -> Iterator[VectorBatch]:
        """Stream one decoded ``VectorBatch`` per surviving stripe, so scans
        pipeline morsels instead of materializing whole files."""
        with StripeFileReader(path) as reader:  # one directory parse
            yield from _stripe_chunks(reader, reader.read_meta(), columns,
                                      sarg_preds, runtime_blooms)

    def read_file(
        self,
        path: str,
        columns: Optional[Sequence[str]] = None,
        sarg_preds: Sequence[SargPredicate] = (),
        runtime_blooms: Optional[Dict[str, BloomFilter]] = None,
    ) -> Tuple[FileMeta, VectorBatch]:
        with StripeFileReader(path) as reader:
            meta = reader.read_meta()
            cols = list(columns) if columns is not None else meta.columns
            chunks = list(_stripe_chunks(reader, meta, cols, sarg_preds,
                                         runtime_blooms))
        return meta, _concat_file_chunks(chunks, cols, meta)

    def read_meta(self, path: str) -> FileMeta:
        return read_file_meta(path)


def _stripe_chunks(
    reader: StripeFileReader,
    meta: FileMeta,
    columns: Optional[Sequence[str]],
    sarg_preds: Sequence[SargPredicate],
    runtime_blooms: Optional[Dict[str, BloomFilter]],
) -> Iterator[VectorBatch]:
    cols = list(columns) if columns is not None else meta.columns
    for si, smeta in enumerate(meta.stripes):
        if sarg_preds and not stripe_may_match(smeta, sarg_preds):
            continue  # row-group skip via min/max + file blooms (§5.1)
        stripe_cols = {c: reader.read_column(si, c) for c in cols}
        yield _bloom_masked(stripe_cols, cols, runtime_blooms)


def _bloom_masked(
    stripe_cols: Dict[str, np.ndarray],
    cols: Sequence[str],
    runtime_blooms: Optional[Dict[str, BloomFilter]],
) -> VectorBatch:
    """Apply runtime-filter bloom probes to one decoded stripe (§4.6)."""
    mask = None
    if runtime_blooms:
        for col, bf in runtime_blooms.items():
            if col in stripe_cols:
                m = bf.might_contain(stripe_cols[col])
                mask = m if mask is None else (mask & m)
    if mask is None:
        return VectorBatch({c: stripe_cols[c] for c in cols})
    return VectorBatch({c: stripe_cols[c][mask] for c in cols})


def _concat_file_chunks(chunks, cols, meta: FileMeta) -> VectorBatch:
    if chunks:
        return VectorBatch.concat(chunks)
    return VectorBatch({
        c: np.empty(0, dtype=meta.dtypes.get(c, "f8")) for c in cols
    })


@dataclass
class StoreDir:
    path: str
    kind: str  # base | delta | delete_delta
    min_writeid: int
    max_writeid: int


def list_stores(directory: str) -> List[StoreDir]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in sorted(os.listdir(directory)):
        full = os.path.join(directory, name)
        if not os.path.isdir(full):
            continue
        if m := _BASE_RE.match(name):
            w = int(m.group(1))
            out.append(StoreDir(full, "base", 0, w))
        elif m := _DELTA_RE.match(name):
            out.append(StoreDir(full, "delta", int(m.group(1)), int(m.group(2))))
        elif m := _DELETE_RE.match(name):
            out.append(StoreDir(full, "delete_delta", int(m.group(1)), int(m.group(2))))
    return out


def select_stores(
    directory: str, wid_list: WriteIdList
) -> Tuple[Optional[StoreDir], List[StoreDir], List[StoreDir]]:
    """Pick the newest visible base and the deltas above it (paper §3.2)."""
    stores = list_stores(directory)
    bases = [s for s in stores if s.kind == "base" and s.max_writeid <= wid_list.hwm]
    base = max(bases, key=lambda s: s.max_writeid, default=None)
    floor = base.max_writeid if base else 0
    deltas = [
        s
        for s in stores
        if s.kind == "delta" and s.max_writeid > floor and s.min_writeid <= wid_list.hwm
    ]
    deletes = [
        s
        for s in stores
        if s.kind == "delete_delta" and s.min_writeid <= wid_list.hwm
    ]
    return base, deltas, deletes


def _rowkey(writeids: np.ndarray, rowids: np.ndarray) -> np.ndarray:
    return writeids.astype(np.int64) * np.int64(1 << 32) + rowids.astype(np.int64)


def _in_sorted(keys: np.ndarray, sorted_keys: np.ndarray) -> np.ndarray:
    """``np.isin(keys, sorted_keys)`` for a sorted, non-empty
    ``sorted_keys``, by binary search: no sort of the tombstones per chunk
    (``np.isin`` sorts both arrays on every call)."""
    pos = np.minimum(np.searchsorted(sorted_keys, keys), len(sorted_keys) - 1)
    return sorted_keys[pos] == keys


class AcidTable:
    """Transactional read/write facade over one table's directory tree."""

    # registry of active reader snapshots per table-location, consulted by the
    # compaction cleaner so in-flight queries finish before files vanish (§3.2)
    _reader_leases: Dict[str, List[int]] = {}
    _lease_lock = make_lock("acid.lease")

    def __init__(self, desc: TableDesc, hms: Metastore):
        self.desc = desc
        self.hms = hms

    # ---------------------------------------------------------------- writes
    def _partition_dirs(self, batch: VectorBatch) -> Iterator[Tuple[tuple, str, VectorBatch]]:
        pcols = self.desc.partition_cols
        if not pcols:
            yield (), self.desc.location, batch
            return
        keys = [batch.cols[c] for c in pcols]
        rec = np.rec.fromarrays(keys)
        for uniq in np.unique(rec):
            vals = tuple(np.atleast_1d(uniq[c]).item() for c in rec.dtype.names)
            mask = rec == uniq
            sub = batch.select(mask).drop(pcols)
            loc = self.hms.add_partition(self.desc.name, vals)
            yield vals, loc, sub

    def insert(
        self,
        txn_id: int,
        batch: VectorBatch,
        *,
        bloom_columns: Sequence[str] = (),
        update_stats: bool = True,
    ) -> int:
        """INSERT rows under txn; allocates the table WriteId on first use."""
        wid = self.hms.allocate_write_id(txn_id, self.desc.name)
        for pvals, loc, sub in self._partition_dirs(batch):
            self.hms.acquire_lock(
                txn_id, self.desc.name, pvals if pvals else None, "shared"
            )
            self.hms.record_write_set(txn_id, self.desc.name, pvals, "insert")
            self._write_store(loc, f"delta_{wid}_{wid}", sub, wid, bloom_columns)
            if update_stats:
                stats = TableStats(
                    row_count=sub.num_rows,
                    columns={
                        c: compute_column_stats(sub.cols[c])
                        for c in sub.column_names
                        if not c.startswith("__")
                    },
                )
                for c in self.desc.partition_cols:
                    pass  # partition cols are directory-encoded, no file stats
                self.hms.merge_stats(self.desc.name, pvals, stats)
        return wid

    def delete(
        self, txn_id: int, targets_by_partition: Dict[tuple, np.ndarray]
    ) -> int:
        """DELETE: write tombstones pointing at (writeid, rowid) pairs.

        ``targets_by_partition`` maps partition values -> (n, 2) int64 array of
        [orig_writeid, orig_rowid].
        """
        wid = self.hms.allocate_write_id(txn_id, self.desc.name)
        for pvals, targets in targets_by_partition.items():
            if len(targets) == 0:
                continue
            loc = (
                self.hms.add_partition(self.desc.name, pvals)
                if self.desc.partition_cols
                else self.desc.location
            )
            self.hms.acquire_lock(
                txn_id, self.desc.name, pvals if pvals else None, "shared"
            )
            self.hms.record_write_set(txn_id, self.desc.name, pvals, "delete")
            tomb = VectorBatch(
                {
                    T_WRITEID_COL: targets[:, 0].astype(np.int64),
                    T_ROWID_COL: targets[:, 1].astype(np.int64),
                }
            )
            self._write_store(loc, f"delete_delta_{wid}_{wid}", tomb, wid, ())
        return wid

    def _write_store(
        self,
        location: str,
        store_name: str,
        batch: VectorBatch,
        wid: int,
        bloom_columns: Sequence[str],
    ) -> None:
        store_dir = os.path.join(location, store_name)
        os.makedirs(store_dir, exist_ok=True)
        existing = [f for f in os.listdir(store_dir) if f.endswith(".tahoe")]
        rowid_base = 0
        for f in existing:  # rowids stay unique within a WriteId across files
            rowid_base += read_file_meta(os.path.join(store_dir, f)).num_rows
        n = batch.num_rows
        full = batch.with_column(
            WRITEID_COL, np.full(n, wid, dtype=np.int64)
        ).with_column(ROWID_COL, np.arange(rowid_base, rowid_base + n, dtype=np.int64))
        path = os.path.join(store_dir, f"bucket_{len(existing):05d}.tahoe")
        write_stripe_file(path, full, writeid=wid, bloom_columns=bloom_columns)

    # ---------------------------------------------------------------- reads
    def _partition_tombstones(self, deletes, wid_list: WriteIdList,
                              io) -> np.ndarray:
        """The visible tombstones' row keys, sorted and unique."""
        # Deletes are usually small: load tombstones fully in memory (§3.2)
        tomb_keys = []
        for store in deletes:
            for f in self._store_files(store.path):
                meta, tb = io.read_file(
                    f, [T_WRITEID_COL, T_ROWID_COL, WRITEID_COL]
                )
                valid = wid_list.valid_mask(tb.cols[WRITEID_COL])
                tb = tb.select(valid)
                if tb.num_rows:
                    tomb_keys.append(
                        _rowkey(tb.cols[T_WRITEID_COL], tb.cols[T_ROWID_COL])
                    )
        # sorted once per scan: every stripe chunk probes them
        return (np.unique(np.concatenate(tomb_keys)) if tomb_keys
                else np.empty(0, np.int64))

    def iter_partition_chunks(
        self,
        location: str,
        part_values: tuple,
        wid_list: WriteIdList,
        columns: Optional[Sequence[str]] = None,
        sarg_preds: Sequence[SargPredicate] = (),
        runtime_blooms: Optional[Dict[str, BloomFilter]] = None,
        io=None,
        keep_acid_cols: bool = False,
    ) -> Iterator[VectorBatch]:
        """Stream one partition's visible rows stripe-by-stripe.

        The merge-on-read pipeline (WriteId visibility mask + tombstone
        anti-join + partition-column injection) applies per decoded stripe
        chunk, so a scan never materializes a whole partition."""
        io = io or PlainIO()
        base, deltas, deletes = select_stores(location, wid_list)
        tombs = self._partition_tombstones(deletes, wid_list, io)

        data_cols = None
        if columns is not None:
            pcols = set(self.desc.partition_cols)
            data_cols = [c for c in columns if c not in pcols]
            for c in (WRITEID_COL, ROWID_COL):
                if c not in data_cols:
                    data_cols = data_cols + [c]

        def finish(tb: VectorBatch) -> VectorBatch:
            # inject directory-encoded partition columns (§3.1 / Figure 3)
            for col, val in zip(self.desc.partition_cols, part_values):
                if columns is None or col in columns:
                    dtype = _np_dtype(self.desc.dtype_of(col))
                    tb = tb.with_column(
                        col, np.full(tb.num_rows, val, dtype=dtype))
            return tb if keep_acid_cols else tb.drop_acid_cols()

        stores = ([base] if base else []) + deltas
        for store in stores:
            for f in self._store_files(store.path):
                for tb in io.read_file_chunks(f, data_cols, sarg_preds,
                                              runtime_blooms):
                    mask = wid_list.valid_mask(tb.cols[WRITEID_COL])
                    if len(tombs):  # anti-join against delete tombstones
                        keys = _rowkey(tb.cols[WRITEID_COL],
                                       tb.cols[ROWID_COL])
                        mask &= ~_in_sorted(keys, tombs)
                    tb = tb.select(mask)
                    if tb.num_rows:
                        yield finish(tb)

    def scan_partition(
        self,
        location: str,
        part_values: tuple,
        wid_list: WriteIdList,
        columns: Optional[Sequence[str]] = None,
        sarg_preds: Sequence[SargPredicate] = (),
        runtime_blooms: Optional[Dict[str, BloomFilter]] = None,
        io=None,
        keep_acid_cols: bool = False,
    ) -> VectorBatch:
        chunks = list(self.iter_partition_chunks(
            location, part_values, wid_list, columns, sarg_preds,
            runtime_blooms, io, keep_acid_cols,
        ))
        if chunks:
            return VectorBatch.concat(chunks)
        data_cols = None
        if columns is not None:
            pcols = set(self.desc.partition_cols)
            data_cols = [c for c in columns if c not in pcols]
            for c in (WRITEID_COL, ROWID_COL):
                if c not in data_cols:
                    data_cols = data_cols + [c]
        out = self._empty_batch(data_cols)
        for col, val in zip(self.desc.partition_cols, part_values):
            if columns is None or col in columns:
                dtype = _np_dtype(self.desc.dtype_of(col))
                out = out.with_column(col, np.full(0, val, dtype=dtype))
        return out if keep_acid_cols else out.drop_acid_cols()

    def scan(
        self,
        wid_list: WriteIdList,
        columns: Optional[Sequence[str]] = None,
        sarg_preds: Sequence[SargPredicate] = (),
        runtime_blooms: Optional[Dict[str, BloomFilter]] = None,
        partition_filter=None,  # callable(part_values_tuple) -> bool
        io=None,
        keep_acid_cols: bool = False,
    ) -> Iterator[Tuple[tuple, VectorBatch]]:
        self._register_lease(wid_list.hwm)
        try:
            if self.desc.partition_cols:
                for pvals, loc in self.hms.list_partitions(self.desc.name):
                    if partition_filter is not None and not partition_filter(pvals):
                        continue  # static or dynamic partition pruning (§4.6)
                    yield pvals, self.scan_partition(
                        loc, pvals, wid_list, columns, sarg_preds,
                        runtime_blooms, io, keep_acid_cols,
                    )
            else:
                yield (), self.scan_partition(
                    self.desc.location, (), wid_list, columns, sarg_preds,
                    runtime_blooms, io, keep_acid_cols,
                )
        finally:
            self._release_lease(wid_list.hwm)

    def scan_chunks(
        self,
        wid_list: WriteIdList,
        columns: Optional[Sequence[str]] = None,
        sarg_preds: Sequence[SargPredicate] = (),
        runtime_blooms: Optional[Dict[str, BloomFilter]] = None,
        partition_filter=None,  # callable(part_values_tuple) -> bool
        io=None,
        keep_acid_cols: bool = False,
    ) -> Iterator[Tuple[tuple, VectorBatch]]:
        """Streaming variant of :meth:`scan`: yields ``(part_values, chunk)``
        per decoded stripe chunk instead of one batch per partition."""
        self._register_lease(wid_list.hwm)
        try:
            if self.desc.partition_cols:
                targets = [
                    (pvals, loc)
                    for pvals, loc in self.hms.list_partitions(self.desc.name)
                    if partition_filter is None or partition_filter(pvals)
                ]
            else:
                targets = [((), self.desc.location)]
            for pvals, loc in targets:
                for chunk in self.iter_partition_chunks(
                    loc, pvals, wid_list, columns, sarg_preds,
                    runtime_blooms, io, keep_acid_cols,
                ):
                    yield pvals, chunk
        finally:
            self._release_lease(wid_list.hwm)

    def read_all(self, wid_list: WriteIdList, **kw) -> VectorBatch:
        return VectorBatch.concat([b for _, b in self.scan(wid_list, **kw)])

    # ---------------------------------------------------------------- helpers
    def _store_files(self, store_dir: str) -> List[str]:
        return [
            os.path.join(store_dir, f)
            for f in sorted(os.listdir(store_dir))
            if f.endswith(".tahoe")
        ]

    def _empty_batch(self, columns: Optional[Sequence[str]]) -> VectorBatch:
        pcols = set(self.desc.partition_cols)
        names = columns or (
            [c for c, _ in self.desc.schema if c not in pcols]
            + [WRITEID_COL, ROWID_COL]
        )
        cols = {}
        for c in names:
            if c in (WRITEID_COL, ROWID_COL, T_WRITEID_COL, T_ROWID_COL):
                cols[c] = np.empty(0, dtype=np.int64)
            elif c not in pcols:
                cols[c] = np.empty(0, dtype=_np_dtype(self.desc.dtype_of(c)))
        return VectorBatch(cols)

    def _register_lease(self, hwm: int) -> None:
        with AcidTable._lease_lock:
            AcidTable._reader_leases.setdefault(self.desc.location, []).append(hwm)

    def _release_lease(self, hwm: int) -> None:
        with AcidTable._lease_lock:
            leases = AcidTable._reader_leases.get(self.desc.location, [])
            if hwm in leases:
                leases.remove(hwm)

    @classmethod
    def active_leases(cls, location: str) -> List[int]:
        with cls._lease_lock:
            return list(cls._reader_leases.get(location, []))


def _np_dtype(sql_type: str) -> np.dtype:
    t = sql_type.upper()
    if t.startswith(("INT", "BIGINT", "SMALLINT", "TINYINT")):
        return np.dtype(np.int64)
    if t.startswith("FLOAT"):
        return np.dtype(np.float32)  # Hive FLOAT is single-precision
    if t.startswith(("DECIMAL", "DOUBLE", "REAL")):
        return np.dtype(np.float64)
    if t.startswith(("VARCHAR", "CHAR", "STRING", "TEXT", "TIMESTAMP", "DATE")):
        return np.dtype("U64")
    if t.startswith("BOOL"):
        return np.dtype(np.bool_)
    raise ValueError(f"unsupported SQL type {sql_type}")
