"""Compaction: merging delta stores (paper §3.2 "Compaction").

* **minor** compaction merges delta directories with other delta directories
  (and delete_deltas with delete_deltas),
* **major** compaction merges deltas into the base, applying tombstones and
  dropping aborted history ("major compaction deletes history").

Compaction is triggered automatically when thresholds are surpassed (number
of delta directories, ratio of delta rows to base rows) and never takes locks
over the table: the merge phase writes new directories, and a *separated
cleaner* removes obsolete ones only once no active reader snapshot could
still reference them.
"""
from __future__ import annotations

import os
import shutil
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from .acid import (
    AcidTable,
    PlainIO,
    StoreDir,
    T_ROWID_COL,
    T_WRITEID_COL,
    _rowkey,
    list_stores,
    select_stores,
)
from .metastore import Metastore, WriteIdList
from .runtime.vector import ROWID_COL, WRITEID_COL, VectorBatch
from .storage import write_stripe_file


@dataclass
class CompactionConfig:
    minor_delta_threshold: int = 10  # #delta dirs that triggers a minor compaction
    major_ratio_threshold: float = 0.1  # delta rows / base rows triggering major
    enabled: bool = True


def _compaction_wid_list(hms: Metastore, table: str) -> WriteIdList:
    """Only WriteIds below every open transaction may be compacted."""
    snap = hms.get_snapshot()
    min_open = hms.min_open_txn()
    if min_open is not None:
        snap_hwm = min_open - 1
        snap = type(snap)(snap_hwm, frozenset(), snap.aborted_txns)
    wid = hms.writeid_list(table, snap)
    return wid


def _read_store_rows(table: AcidTable, store: StoreDir, io: PlainIO) -> VectorBatch:
    return VectorBatch.concat(
        [io.read_file(f)[1] for f in table._store_files(store.path)]
    )


def compact_partition(
    table: AcidTable,
    location: str,
    kind: str,
    hms: Metastore,
    clean: bool = True,
) -> Optional[str]:
    """Run a minor/major compaction over one partition directory."""
    assert kind in ("minor", "major")
    io = PlainIO()
    wid_list = _compaction_wid_list(hms, table.desc.name)
    base, deltas, deletes = select_stores(location, wid_list)
    if not deltas and not deletes:
        return None

    obsolete = []
    if kind == "minor":
        # merge insert deltas (keeping records + their original row ids) and
        # delete deltas into single multi-WriteId directories
        new_dirs = []
        if deltas:
            lo = min(d.min_writeid for d in deltas)
            hi = max(d.max_writeid for d in deltas)
            merged = VectorBatch.concat([_read_store_rows(table, d, io) for d in deltas])
            mask = wid_list.valid_mask(merged.cols[WRITEID_COL])
            merged = merged.select(mask)  # drop aborted history
            out = os.path.join(location, f"delta_{lo}_{hi}")
            if len(deltas) > 1 or deltas[0].path != out:
                _write_dir(out, merged)
                obsolete += [d.path for d in deltas if d.path != out]
                new_dirs.append(out)
        if deletes:
            lo = min(d.min_writeid for d in deletes)
            hi = max(d.max_writeid for d in deletes)
            merged = VectorBatch.concat([_read_store_rows(table, d, io) for d in deletes])
            mask = wid_list.valid_mask(merged.cols[WRITEID_COL])
            merged = merged.select(mask)
            out = os.path.join(location, f"delete_delta_{lo}_{hi}")
            if len(deletes) > 1 or deletes[0].path != out:
                _write_dir(out, merged)
                obsolete += [d.path for d in deletes if d.path != out]
        result = ",".join(new_dirs) if new_dirs else None
    else:  # major: fold everything into a new base at the compaction watermark
        hwm = wid_list.hwm
        chunks = []
        tomb_keys = []
        for store in deletes:
            tb = _read_store_rows(table, store, io)
            tb = tb.select(wid_list.valid_mask(tb.cols[WRITEID_COL]))
            if tb.num_rows:
                tomb_keys.append(_rowkey(tb.cols[T_WRITEID_COL], tb.cols[T_ROWID_COL]))
        tombs = np.concatenate(tomb_keys) if tomb_keys else np.empty(0, np.int64)
        for store in ([base] if base else []) + deltas:
            tb = _read_store_rows(table, store, io)
            mask = wid_list.valid_mask(tb.cols[WRITEID_COL])
            if len(tombs):
                keys = _rowkey(tb.cols[WRITEID_COL], tb.cols[ROWID_COL])
                mask &= ~np.isin(keys, tombs)
            tb = tb.select(mask)
            if tb.num_rows:
                chunks.append(tb)
        merged = (
            VectorBatch.concat(chunks) if chunks else table._empty_batch(None)
        )
        out = os.path.join(location, f"base_{hwm}")
        _write_dir(out, merged)
        obsolete += [d.path for d in deltas + deletes if d.path != out]
        if base and base.path != out:
            obsolete.append(base.path)
        result = out

    if clean:
        run_cleaner(location, obsolete, wid_list.hwm)
    else:
        _PENDING_CLEANUPS.setdefault(location, []).extend(
            (p, wid_list.hwm) for p in obsolete
        )
    return result


_PENDING_CLEANUPS: Dict[str, list] = {}


def run_cleaner(location: str, obsolete: list, compaction_hwm: int) -> int:
    """Cleaner phase, separated from merging (paper §3.2): only delete stores
    once no active reader snapshot predates the compaction watermark."""
    leases = AcidTable.active_leases(location)
    if any(h < compaction_hwm for h in leases):
        _PENDING_CLEANUPS.setdefault(location, []).extend(
            (p, compaction_hwm) for p in obsolete
        )
        return 0
    removed = 0
    for path in obsolete:
        if os.path.isdir(path):
            shutil.rmtree(path)
            removed += 1
    return removed


def drain_pending_cleanups(location: str) -> int:
    pend = _PENDING_CLEANUPS.pop(location, [])
    removed = 0
    for path, hwm in pend:
        removed += run_cleaner(location, [path], hwm)
    return removed


def _write_dir(out_dir: str, batch: VectorBatch) -> None:
    tmp = out_dir + "._tmp"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    wid = int(batch.cols[WRITEID_COL].max()) if batch.num_rows else 0
    write_stripe_file(os.path.join(tmp, "bucket_00000.tahoe"), batch, writeid=wid)
    if os.path.isdir(out_dir):
        shutil.rmtree(out_dir)
    os.replace(tmp, out_dir)


# --------------------------------------------------------------------------
# Initiator: automatic triggering on thresholds (paper §3.2)
# --------------------------------------------------------------------------
def maybe_compact(
    table: AcidTable, hms: Metastore, cfg: CompactionConfig = CompactionConfig()
) -> Dict[str, str]:
    if not cfg.enabled:
        return {}
    actions: Dict[str, str] = {}
    locations = (
        [loc for _, loc in hms.list_partitions(table.desc.name)]
        if table.desc.partition_cols
        else [table.desc.location]
    )
    io = PlainIO()
    for loc in locations:
        stores = list_stores(loc)
        deltas = [s for s in stores if s.kind != "base"]
        bases = [s for s in stores if s.kind == "base"]
        if not deltas:
            continue
        base_rows = sum(
            io.read_meta(f).num_rows
            for b in bases
            for f in table._store_files(b.path)
        )
        delta_rows = sum(
            io.read_meta(f).num_rows
            for d in deltas
            for f in table._store_files(d.path)
        )
        if base_rows and delta_rows / max(base_rows, 1) >= cfg.major_ratio_threshold:
            compact_partition(table, loc, "major", hms)
            actions[loc] = "major"
        elif len(deltas) >= cfg.minor_delta_threshold:
            compact_partition(table, loc, "minor", hms)
            actions[loc] = "minor"
    return actions
