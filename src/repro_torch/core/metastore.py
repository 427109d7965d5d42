"""Hive Metastore (HMS) analogue (paper §2 "Data catalog", §3.2, §5.2).

HMS is "a catalog for all data queryable by Hive", persisted in an RDBMS.  We
persist in sqlite3 (the stdlib RDBMS) — playing the role DataNucleus-managed
MySQL/Postgres plays for Hive — and expose a typed in-process API standing in
for the Thrift service.  Like HMS, this one component owns:

  * the table/partition catalog and column statistics (additive, HLL++ NDV),
  * the transaction manager state: TxnIds, per-table WriteIds, locks,
    write-sets for first-commit-wins conflict detection (paper §3.2),
  * the materialized-view registry incl. build-time snapshots (paper §4.4),
  * workload-management resource plans (paper §5.2),
  * a notification log consumed by storage-handler metastore hooks (paper §6.1).
"""
from __future__ import annotations

import dataclasses
import json
import os
import sqlite3
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..analysis.lockdep import make_rlock
from .stats import ColumnStats, TableStats

# --------------------------------------------------------------------------
# Public dataclasses
# --------------------------------------------------------------------------


@dataclasses.dataclass
class TableDesc:
    name: str
    schema: List[Tuple[str, str]]  # (column, dtype-string)
    partition_cols: List[str]
    location: str
    props: Dict[str, str]
    handler: Optional[str] = None  # storage-handler name for federated tables
    is_mv: bool = False
    mv_sql: Optional[str] = None
    table_id: int = 0

    @property
    def column_names(self) -> List[str]:
        return [c for c, _ in self.schema]

    def dtype_of(self, col: str) -> str:
        for c, d in self.schema:
            if c == col:
                return d
        raise KeyError(col)


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """Global transaction list: high watermark + open/aborted sets (§3.2)."""

    hwm: int
    open_txns: frozenset
    aborted_txns: frozenset

    def txn_visible(self, txn_id: int) -> bool:
        return (
            txn_id <= self.hwm
            and txn_id not in self.open_txns
            and txn_id not in self.aborted_txns
        )


@dataclasses.dataclass(frozen=True)
class WriteIdList:
    """Per-table projection of a Snapshot (§3.2).

    Readers keep per-table state that is much smaller than the global
    transaction list — the paper notes this is critical when many
    transactions are open.
    """

    table: str
    hwm: int  # highest writeid whose txn is at-or-below the snapshot hwm
    invalid: frozenset  # writeids from open or aborted txns

    def is_valid(self, writeid) -> bool:
        return writeid <= self.hwm and writeid not in self.invalid

    def valid_mask(self, writeids):
        import numpy as np

        mask = writeids <= self.hwm
        if self.invalid:
            mask &= ~np.isin(writeids, np.fromiter(self.invalid, dtype=writeids.dtype))
        return mask


class LockConflict(Exception):
    pass


class WriteConflict(Exception):
    """Raised at commit when first-commit-wins resolution loses (§3.2)."""


class TxnAborted(Exception):
    pass


_SCHEMA = """
CREATE TABLE IF NOT EXISTS tbls(
  table_id INTEGER PRIMARY KEY AUTOINCREMENT, name TEXT UNIQUE, schema_json TEXT,
  partition_cols TEXT, location TEXT, props TEXT, handler TEXT,
  is_mv INTEGER DEFAULT 0, mv_sql TEXT);
CREATE TABLE IF NOT EXISTS partitions(
  table_id INTEGER, part_values TEXT, location TEXT,
  PRIMARY KEY(table_id, part_values));
CREATE TABLE IF NOT EXISTS col_stats(
  table_id INTEGER, part_values TEXT, column_name TEXT, stats_json TEXT,
  PRIMARY KEY(table_id, part_values, column_name));
CREATE TABLE IF NOT EXISTS row_counts(
  table_id INTEGER, part_values TEXT, row_count INTEGER,
  PRIMARY KEY(table_id, part_values));
CREATE TABLE IF NOT EXISTS txns(
  txn_id INTEGER PRIMARY KEY AUTOINCREMENT, state TEXT, started_at REAL,
  begin_seq INTEGER, commit_seq INTEGER);
CREATE TABLE IF NOT EXISTS write_ids(
  table_id INTEGER, txn_id INTEGER, write_id INTEGER,
  PRIMARY KEY(table_id, txn_id));
CREATE TABLE IF NOT EXISTS next_write_id(
  table_id INTEGER PRIMARY KEY, next INTEGER);
CREATE TABLE IF NOT EXISTS write_sets(
  txn_id INTEGER, table_id INTEGER, part_values TEXT, kind TEXT,
  commit_seq INTEGER);
CREATE TABLE IF NOT EXISTS locks(
  lock_id INTEGER PRIMARY KEY AUTOINCREMENT, txn_id INTEGER, table_id INTEGER,
  part_values TEXT, mode TEXT);
CREATE TABLE IF NOT EXISTS mv_registry(
  name TEXT PRIMARY KEY, sql_text TEXT, source_tables TEXT,
  build_snapshot TEXT, rebuild_seconds REAL, staleness_window REAL,
  last_rebuild_at REAL);
CREATE TABLE IF NOT EXISTS resource_plans(
  name TEXT PRIMARY KEY, plan_json TEXT, is_active INTEGER DEFAULT 0);
CREATE TABLE IF NOT EXISTS notifications(
  event_id INTEGER PRIMARY KEY AUTOINCREMENT, event_type TEXT, payload TEXT,
  at REAL);
CREATE TABLE IF NOT EXISTS runtime_stats(
  query_fingerprint TEXT, op_id TEXT, est_rows REAL, actual_rows REAL,
  at REAL);
CREATE TABLE IF NOT EXISTS catalogs(
  name TEXT PRIMARY KEY, connector TEXT, props TEXT);
"""


class Metastore:
    def __init__(self, warehouse_dir: str, db_path: Optional[str] = None):
        self.warehouse_dir = warehouse_dir
        os.makedirs(warehouse_dir, exist_ok=True)
        self.db_path = db_path or os.path.join(warehouse_dir, "metastore.db")
        self._conn = sqlite3.connect(self.db_path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=MEMORY")
        self._conn.execute("PRAGMA synchronous=OFF")
        self._lock = make_rlock("metastore")
        with self._lock:
            self._conn.executescript(_SCHEMA)
        self._commit_seq = self._q1("SELECT COALESCE(MAX(commit_seq),0) FROM txns") or 0
        self._hooks = []  # metastore hooks registered by storage handlers (§6.1)

    # -- tiny query helpers ---------------------------------------------------
    def _exec(self, sql: str, args: tuple = ()):
        with self._lock:
            cur = self._conn.execute(sql, args)
            self._conn.commit()
            return cur

    def _q(self, sql: str, args: tuple = ()) -> list:
        with self._lock:
            return self._conn.execute(sql, args).fetchall()

    def _q1(self, sql: str, args: tuple = ()):
        rows = self._q(sql, args)
        return rows[0][0] if rows else None

    # ======================================================================
    # Catalog
    # ======================================================================
    def create_table(
        self,
        name: str,
        schema: Sequence[Tuple[str, str]],
        partition_cols: Sequence[str] = (),
        props: Optional[Dict[str, str]] = None,
        handler: Optional[str] = None,
        is_mv: bool = False,
        mv_sql: Optional[str] = None,
        location: Optional[str] = None,
    ) -> TableDesc:
        if self.table_exists(name):
            raise ValueError(f"table {name!r} already exists")
        loc = location or os.path.join(self.warehouse_dir, name)
        self._exec(
            "INSERT INTO tbls(name, schema_json, partition_cols, location, props,"
            " handler, is_mv, mv_sql) VALUES (?,?,?,?,?,?,?,?)",
            (
                name,
                json.dumps(list(map(list, schema))),
                json.dumps(list(partition_cols)),
                loc,
                json.dumps(props or {}),
                handler,
                int(is_mv),
                mv_sql,
            ),
        )
        self._notify("CREATE_TABLE", {"table": name, "handler": handler})
        return self.get_table(name)

    def table_exists(self, name: str) -> bool:
        return self._q1("SELECT COUNT(*) FROM tbls WHERE name=?", (name,)) > 0

    def get_table(self, name: str) -> TableDesc:
        rows = self._q(
            "SELECT table_id, name, schema_json, partition_cols, location, props,"
            " handler, is_mv, mv_sql FROM tbls WHERE name=?",
            (name,),
        )
        if not rows:
            raise KeyError(f"no such table: {name}")
        (tid, nm, schema_json, pcols, loc, props, handler, is_mv, mv_sql) = rows[0]
        return TableDesc(
            name=nm,
            schema=[tuple(x) for x in json.loads(schema_json)],
            partition_cols=json.loads(pcols),
            location=loc,
            props=json.loads(props),
            handler=handler,
            is_mv=bool(is_mv),
            mv_sql=mv_sql,
            table_id=tid,
        )

    def drop_table(self, name: str) -> None:
        t = self.get_table(name)
        for tbl in ("partitions", "col_stats", "row_counts", "write_ids",
                    "next_write_id", "write_sets", "locks"):
            self._exec(f"DELETE FROM {tbl} WHERE table_id=?", (t.table_id,))
        self._exec("DELETE FROM tbls WHERE table_id=?", (t.table_id,))
        self._exec("DELETE FROM mv_registry WHERE name=?", (name,))
        self._notify("DROP_TABLE", {"table": name})

    def list_tables(self) -> List[str]:
        return [r[0] for r in self._q("SELECT name FROM tbls ORDER BY name")]

    def add_partition(self, table: str, part_values: Sequence) -> str:
        t = self.get_table(table)
        key = json.dumps(list(part_values))
        sub = "/".join(f"{c}={v}" for c, v in zip(t.partition_cols, part_values))
        loc = os.path.join(t.location, sub)
        self._exec(
            "INSERT OR IGNORE INTO partitions(table_id, part_values, location)"
            " VALUES (?,?,?)",
            (t.table_id, key, loc),
        )
        return loc

    def list_partitions(self, table: str) -> List[Tuple[tuple, str]]:
        t = self.get_table(table)
        rows = self._q(
            "SELECT part_values, location FROM partitions WHERE table_id=?",
            (t.table_id,),
        )
        return [(tuple(json.loads(pv)), loc) for pv, loc in rows]

    # ======================================================================
    # Catalogs (paper §6: whole external systems mounted at once)
    # ======================================================================
    def create_catalog(self, name: str, connector: str,
                       props: Optional[Dict[str, str]] = None) -> None:
        if self._q1("SELECT COUNT(*) FROM catalogs WHERE name=?", (name,)):
            raise ValueError(f"catalog {name!r} already exists")
        self._exec(
            "INSERT INTO catalogs(name, connector, props) VALUES (?,?,?)",
            (name, connector, json.dumps(props or {})),
        )
        self._notify("CREATE_CATALOG", {"catalog": name, "connector": connector})

    def drop_catalog(self, name: str) -> None:
        self._exec("DELETE FROM catalogs WHERE name=?", (name,))
        self._notify("DROP_CATALOG", {"catalog": name})

    def list_catalogs(self) -> List[Tuple[str, str, Dict[str, str]]]:
        return [
            (n, c, json.loads(p)) for n, c, p in
            self._q("SELECT name, connector, props FROM catalogs ORDER BY name")
        ]

    # ======================================================================
    # Statistics (additive merge, §4.1)
    # ======================================================================
    def merge_stats(self, table: str, part_values, stats: TableStats) -> None:
        t = self.get_table(table)
        key = json.dumps(list(part_values)) if part_values else "[]"
        for col, cs in stats.columns.items():
            prev = self._q(
                "SELECT stats_json FROM col_stats WHERE table_id=? AND part_values=?"
                " AND column_name=?",
                (t.table_id, key, col),
            )
            if prev:
                cs = ColumnStats.from_dict(json.loads(prev[0][0])).merge(cs)
            self._exec(
                "INSERT OR REPLACE INTO col_stats VALUES (?,?,?,?)",
                (t.table_id, key, col, json.dumps(cs.to_dict())),
            )
        prev_rc = self._q1(
            "SELECT row_count FROM row_counts WHERE table_id=? AND part_values=?",
            (t.table_id, key),
        )
        self._exec(
            "INSERT OR REPLACE INTO row_counts VALUES (?,?,?)",
            (t.table_id, key, (prev_rc or 0) + stats.row_count),
        )

    def get_stats(self, table: str) -> TableStats:
        """Stats merged across all partitions (what the optimizer consumes)."""
        t = self.get_table(table)
        out = TableStats()
        for (pv,) in self._q(
            "SELECT DISTINCT part_values FROM row_counts WHERE table_id=?",
            (t.table_id,),
        ):
            cols = {
                col: ColumnStats.from_dict(json.loads(js))
                for col, js in self._q(
                    "SELECT column_name, stats_json FROM col_stats WHERE table_id=?"
                    " AND part_values=?",
                    (t.table_id, pv),
                )
            }
            rc = self._q1(
                "SELECT row_count FROM row_counts WHERE table_id=? AND part_values=?",
                (t.table_id, pv),
            )
            out = out.merge(TableStats(rc or 0, cols))
        return out

    # ======================================================================
    # Transactions (§3.2)
    # ======================================================================
    def open_txn(self) -> int:
        with self._lock:
            cur = self._exec(
                "INSERT INTO txns(state, started_at, begin_seq, commit_seq)"
                " VALUES ('open', ?, ?, NULL)",
                (time.time(), self._commit_seq),
            )
            return cur.lastrowid

    def txn_state(self, txn_id: int) -> str:
        st = self._q1("SELECT state FROM txns WHERE txn_id=?", (txn_id,))
        if st is None:
            raise KeyError(f"unknown txn {txn_id}")
        return st

    def allocate_write_id(self, txn_id: int, table: str) -> int:
        """Monotonic per-table WriteId; one per (txn, table) (§3.2)."""
        if self.txn_state(txn_id) != "open":
            raise TxnAborted(f"txn {txn_id} not open")
        t = self.get_table(table)
        with self._lock:
            existing = self._q1(
                "SELECT write_id FROM write_ids WHERE table_id=? AND txn_id=?",
                (t.table_id, txn_id),
            )
            if existing is not None:
                return existing
            nxt = self._q1(
                "SELECT next FROM next_write_id WHERE table_id=?", (t.table_id,)
            )
            wid = nxt or 1
            self._exec(
                "INSERT OR REPLACE INTO next_write_id VALUES (?,?)",
                (t.table_id, wid + 1),
            )
            self._exec(
                "INSERT INTO write_ids VALUES (?,?,?)", (t.table_id, txn_id, wid)
            )
            return wid

    def record_write_set(self, txn_id: int, table: str, part_values, kind: str):
        """Track update/delete write-sets for optimistic conflict resolution."""
        t = self.get_table(table)
        key = json.dumps(list(part_values)) if part_values else "[]"
        self._exec(
            "INSERT INTO write_sets(txn_id, table_id, part_values, kind, commit_seq)"
            " VALUES (?,?,?,?,NULL)",
            (txn_id, t.table_id, key, kind),
        )

    def commit_txn(self, txn_id: int) -> None:
        with self._lock:
            if self.txn_state(txn_id) != "open":
                raise TxnAborted(f"txn {txn_id} not open")
            # First-commit-wins (§3.2): abort if an overlapping update/delete
            # write-set committed after this transaction began.
            begin_seq = self._q1(
                "SELECT begin_seq FROM txns WHERE txn_id=?", (txn_id,)
            )
            mine = self._q(
                "SELECT table_id, part_values FROM write_sets WHERE txn_id=?"
                " AND kind IN ('update','delete')",
                (txn_id,),
            )
            for table_id, part_values in mine:
                conflict = self._q(
                    "SELECT w.txn_id FROM write_sets w JOIN txns t ON w.txn_id=t.txn_id"
                    " WHERE w.table_id=? AND w.part_values=? AND w.txn_id != ?"
                    " AND w.kind IN ('update','delete') AND t.state='committed'"
                    " AND t.commit_seq > ?",
                    (table_id, part_values, txn_id, begin_seq),
                )
                if conflict:
                    self.abort_txn(txn_id)
                    raise WriteConflict(
                        f"txn {txn_id} lost first-commit-wins to txn {conflict[0][0]}"
                    )
            self._commit_seq += 1
            self._exec(
                "UPDATE txns SET state='committed', commit_seq=? WHERE txn_id=?",
                (self._commit_seq, txn_id),
            )
            self._exec(
                "UPDATE write_sets SET commit_seq=? WHERE txn_id=?",
                (self._commit_seq, txn_id),
            )
            self.release_locks(txn_id)

    def abort_txn(self, txn_id: int) -> None:
        self._exec("UPDATE txns SET state='aborted' WHERE txn_id=?", (txn_id,))
        self.release_locks(txn_id)

    def get_snapshot(self) -> Snapshot:
        hwm = self._q1("SELECT COALESCE(MAX(txn_id),0) FROM txns")
        opens = frozenset(
            r[0] for r in self._q("SELECT txn_id FROM txns WHERE state='open'")
        )
        aborted = frozenset(
            r[0] for r in self._q("SELECT txn_id FROM txns WHERE state='aborted'")
        )
        return Snapshot(hwm, opens, aborted)

    def writeid_list(self, table: str, snapshot: Snapshot) -> WriteIdList:
        """Project the global txn list onto one table's WriteIds (§3.2)."""
        t = self.get_table(table)
        rows = self._q(
            "SELECT txn_id, write_id FROM write_ids WHERE table_id=?", (t.table_id,)
        )
        hwm_w = 0
        invalid = set()
        for txn_id, wid in rows:
            if txn_id <= snapshot.hwm:
                hwm_w = max(hwm_w, wid)
            if not snapshot.txn_visible(txn_id):
                invalid.add(wid)
        return WriteIdList(table, hwm_w, frozenset(invalid))

    def min_open_txn(self) -> Optional[int]:
        return self._q1("SELECT MIN(txn_id) FROM txns WHERE state='open'")

    # ======================================================================
    # Locks (§3.2: partition granularity when partitioned, else table)
    # ======================================================================
    def acquire_lock(self, txn_id: int, table: str, part_values, mode: str) -> int:
        assert mode in ("shared", "exclusive")
        t = self.get_table(table)
        key = json.dumps(list(part_values)) if part_values else None
        with self._lock:
            holders = self._q(
                "SELECT txn_id, part_values, mode FROM locks WHERE table_id=?",
                (t.table_id,),
            )
            for other_txn, other_key, other_mode in holders:
                if other_txn == txn_id:
                    continue
                overlap = key is None or other_key is None or key == other_key
                if overlap and ("exclusive" in (mode, other_mode)):
                    raise LockConflict(
                        f"{mode} lock on {table} blocked by txn {other_txn}"
                    )
            cur = self._exec(
                "INSERT INTO locks(txn_id, table_id, part_values, mode)"
                " VALUES (?,?,?,?)",
                (txn_id, t.table_id, key, mode),
            )
            return cur.lastrowid

    def release_locks(self, txn_id: int) -> None:
        self._exec("DELETE FROM locks WHERE txn_id=?", (txn_id,))

    # ======================================================================
    # Materialized views (§4.4)
    # ======================================================================
    def register_mv(
        self,
        name: str,
        sql_text: str,
        source_tables: Sequence[str],
        build_snapshot: Dict[str, int],
        rebuild_seconds: float = 0.0,
        staleness_window: float = 0.0,
    ) -> None:
        self._exec(
            "INSERT OR REPLACE INTO mv_registry VALUES (?,?,?,?,?,?,?)",
            (
                name,
                sql_text,
                json.dumps(list(source_tables)),
                json.dumps(build_snapshot),
                rebuild_seconds,
                staleness_window,
                time.time(),
            ),
        )

    def list_mvs(self) -> List[dict]:
        rows = self._q(
            "SELECT name, sql_text, source_tables, build_snapshot, rebuild_seconds,"
            " staleness_window, last_rebuild_at FROM mv_registry"
        )
        return [
            {
                "name": n,
                "sql": s,
                "source_tables": json.loads(st),
                "build_snapshot": {k: int(v) for k, v in json.loads(bs).items()},
                "rebuild_seconds": rs,
                "staleness_window": sw,
                "last_rebuild_at": lra,
            }
            for n, s, st, bs, rs, sw, lra in rows
        ]

    def update_mv_snapshot(self, name: str, build_snapshot: Dict[str, int]) -> None:
        self._exec(
            "UPDATE mv_registry SET build_snapshot=?, last_rebuild_at=? WHERE name=?",
            (json.dumps(build_snapshot), time.time(), name),
        )

    # ======================================================================
    # Resource plans (§5.2)
    # ======================================================================
    def save_resource_plan(self, name: str, plan: dict) -> None:
        self._exec(
            "INSERT OR REPLACE INTO resource_plans(name, plan_json, is_active)"
            " VALUES (?,?, COALESCE((SELECT is_active FROM resource_plans"
            " WHERE name=?),0))",
            (name, json.dumps(plan), name),
        )

    def activate_resource_plan(self, name: str) -> None:
        # only one plan may be active at a time (paper §5.2)
        self._exec("UPDATE resource_plans SET is_active=0")
        self._exec("UPDATE resource_plans SET is_active=1 WHERE name=?", (name,))

    def get_resource_plan(self, name: str) -> Optional[dict]:
        js = self._q1("SELECT plan_json FROM resource_plans WHERE name=?", (name,))
        return json.loads(js) if js else None

    def active_resource_plan(self) -> Optional[dict]:
        js = self._q1("SELECT plan_json FROM resource_plans WHERE is_active=1")
        return json.loads(js) if js else None

    # ======================================================================
    # Runtime stats persisted for re-optimization feedback (§4.2, §9 roadmap)
    # ======================================================================
    def record_runtime_stats(self, fingerprint: str, op_id: str, est: float, act: float):
        self._exec(
            "INSERT INTO runtime_stats VALUES (?,?,?,?,?)",
            (fingerprint, op_id, est, act, time.time()),
        )

    def runtime_stats_for(self, fingerprint: str) -> Dict[str, float]:
        rows = self._q(
            "SELECT op_id, actual_rows FROM runtime_stats WHERE query_fingerprint=?"
            " ORDER BY at",
            (fingerprint,),
        )
        return {op: act for op, act in rows}

    # ======================================================================
    # Notification log + metastore hooks (§6.1)
    # ======================================================================
    def register_hook(self, hook) -> None:
        self._hooks.append(hook)

    def _notify(self, event_type: str, payload: dict) -> None:
        self._exec(
            "INSERT INTO notifications(event_type, payload, at) VALUES (?,?,?)",
            (event_type, json.dumps(payload), time.time()),
        )
        for hook in self._hooks:
            fn = getattr(hook, "on_" + event_type.lower(), None)
            if fn is not None:
                fn(payload)

    def notifications(self) -> List[tuple]:
        return self._q("SELECT event_id, event_type, payload FROM notifications")

    def close(self) -> None:
        with self._lock:
            self._conn.close()
