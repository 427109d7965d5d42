"""Storage-handler / DataSource interface (paper §6.1, redesigned).

A handler (connector) consists of (i) a *scan builder* — the
capability-negotiated read path (filter/projection/aggregate/limit pushdown
plus split-parallel streaming readers; see
:mod:`repro_torch.core.federation.datasource`), (ii) a *writer* — a batched
``write_batch``/``commit`` output channel, (iii) a *SerDe* translating
between the warehouse's columnar representation and the engine's rows, and
(iv) a *metastore hook* receiving notifications for transactions against
HMS (table creation, row inserts, ...).

Handlers also expose a *catalog surface* (``list_schemas`` /
``list_tables`` / ``discover``) so a whole external system can be mounted
at once via ``CREATE CATALOG`` instead of table-by-table ``STORED BY``
(which stays supported on the same API).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..metastore import TableDesc
from ..runtime.vector import VectorBatch
from .datasource import ScanBuilder, Writer


class SerDe:
    """Serializer/deserializer between Tahoe columns and engine rows."""

    def serialize(self, batch: VectorBatch) -> List[dict]:
        names = batch.column_names
        return [dict(zip(names, row)) for row in batch.to_rows()]

    def deserialize(self, rows: List[dict], dtypes: Optional[Dict[str, str]] = None) -> VectorBatch:
        """Rows may have heterogeneous keys: columns are the *union* of the
        keys across all rows (not just ``rows[0]``), with missing values
        null-filled (NaN for numerics, empty string otherwise)."""
        if not rows:
            return VectorBatch({})
        keys: List[str] = []
        seen = set()
        for r in rows:
            for k in r:
                if k not in seen:
                    seen.add(k)
                    keys.append(k)
        cols: Dict[str, np.ndarray] = {}
        for k in keys:
            vals = [r.get(k) for r in rows]
            present = [v for v in vals if v is not None]
            numeric = all(isinstance(v, (int, float, np.integer, np.floating))
                          and not isinstance(v, bool) for v in present)
            if numeric and present:
                cols[k] = np.array(
                    [float(v) if v is not None else np.nan for v in vals])
            elif present:
                cols[k] = np.array(["" if v is None else str(v) for v in vals])
            else:  # all-null column: no type evidence, default numeric NULLs
                cols[k] = np.full(len(vals), np.nan)
        return VectorBatch(cols)


class StorageHandler:
    """Base connector; subclasses register under a handler name."""

    name: str = "base"
    serde: SerDe = SerDe()
    default_schema: str = "default"

    # ---- scan path (capability negotiation + split-parallel streams) -------
    def scan_builder(self, table: TableDesc,
                     config: Optional[dict] = None) -> ScanBuilder:
        """A fresh negotiation context for one scan of ``table``."""
        return ScanBuilder(self, table, config)

    # ---- write path ----------------------------------------------------------
    def writer(self, table: TableDesc) -> Writer:
        raise NotImplementedError(f"{self.name} handler is read-only")

    # ---- schema inference (CREATE EXTERNAL TABLE without column list) --------
    def infer_schema(self, props: Dict[str, str]) -> Optional[List[tuple]]:
        return None

    # ---- catalog surface (CREATE CATALOG ... USING <name>) -------------------
    def list_schemas(self) -> List[str]:
        return [self.default_schema]

    def list_tables(self, schema: str) -> List[str]:
        return []

    def discover(self, schema: str, table: str) -> Optional[List[Tuple[str, str]]]:
        """Remote schema of ``schema.table``; None when it does not exist."""
        return None

    def table_props(self, schema: str, table: str) -> Dict[str, str]:
        """Connector props identifying ``schema.table`` in a TableDesc."""
        return {}

    # ---- metastore hook --------------------------------------------------------
    def metastore_hook(self):
        return None


class HandlerRegistry:
    def __init__(self):
        self._handlers: Dict[str, StorageHandler] = {}

    def register(self, handler: StorageHandler, hms=None) -> None:
        self._handlers[handler.name] = handler
        hook = handler.metastore_hook()
        if hook is not None and hms is not None:
            hms.register_hook(hook)

    def get(self, name: str) -> Optional[StorageHandler]:
        # allow full class-style names like the paper's
        # 'org.apache.hadoop.hive.druid.DruidStorageHandler'
        if name in self._handlers:
            return self._handlers[name]
        for key, h in self._handlers.items():
            if key in name.lower():
                return h
        return None

    def as_dict(self) -> Dict[str, StorageHandler]:
        return dict(self._handlers)
