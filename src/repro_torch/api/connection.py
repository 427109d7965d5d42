"""Connection layer: ``connect()`` -> :class:`Connection` -> cursors.

Mirrors the HiveServer2/JDBC split of the paper's §2 architecture: the
connection owns client protocol state (config validation, session, prepared
statements) while all query driving lives in ``repro_torch.core`` behind the
staged ``QueryPipeline``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from ..core.config_keys import DEFAULT_CONFIG, check_value
from ..core.session import Warehouse, _VALID_ENGINES
from .cursor import Cursor, _params, _translate_error
from .exceptions import InterfaceError, NotSupportedError, ProgrammingError
from .handle import QueryHandle
from .prepared import PreparedStatement


def connect(warehouse_dir: Optional[str] = None, *,
            warehouse: Optional[Warehouse] = None, **config) -> "Connection":
    """Open a connection to a warehouse directory.

    Pass either ``warehouse_dir`` (a path; the warehouse is created/opened
    there and owned by the connection) or ``warehouse=`` (attach to an
    existing :class:`Warehouse`, e.g. to share one across connections).
    Remaining keyword arguments override session config defaults
    (declared once in ``repro_torch.core.config_keys``), e.g. ``engine="ref"`` or
    ``result_cache=False``.
    """
    if (warehouse_dir is None) == (warehouse is None):
        raise InterfaceError(
            "pass exactly one of warehouse_dir or warehouse="
        )
    unknown = set(config) - set(DEFAULT_CONFIG)
    if unknown:
        raise ProgrammingError(
            f"unknown config option(s): {sorted(unknown)}; "
            f"valid options: {sorted(DEFAULT_CONFIG)}"
        )
    for name, value in config.items():
        complaint = check_value(name, value)
        if complaint is not None:
            raise ProgrammingError(complaint)
    if config.get("engine", DEFAULT_CONFIG["engine"]) not in _VALID_ENGINES:
        raise ProgrammingError(
            f"engine must be one of {_VALID_ENGINES}"
        )
    owns = warehouse is None
    wh = warehouse if warehouse is not None else Warehouse(warehouse_dir)
    return Connection(wh, config, owns_warehouse=owns)


class Connection:
    """A client session over one warehouse; create with :func:`connect`."""

    def __init__(self, warehouse: Warehouse, config: dict,
                 owns_warehouse: bool = True):
        self._wh = warehouse
        self._session = warehouse.session(**config)
        self._owns_warehouse = owns_warehouse
        self._closed = False

    # ------------------------------------------------------------------
    @property
    def warehouse(self) -> Warehouse:
        return self._wh

    @property
    def session(self):
        """The underlying ``repro_torch.core.session.Session`` (escape hatch)."""
        return self._session

    @property
    def closed(self) -> bool:
        return self._closed

    def cursor(self) -> Cursor:
        self._check_open()
        return Cursor(self)

    def catalogs(self) -> dict:
        """Mounted federated catalogs: ``{name: connector}`` (paper §6).

        Catalogs are created with ``CREATE CATALOG name USING connector
        [WITH (...)]`` and queried with three-part names
        (``catalog.schema.table``); schemas are discovered lazily from the
        remote system.  Use ``conn.warehouse.catalogs.get(name)`` for the
        full :class:`~repro_torch.core.federation.catalog.Catalog` object
        (``list_schemas()`` / ``list_tables()``)."""
        self._check_open()
        return {name: cat.connector
                for name, cat in self._wh.catalogs.items()}

    def server_stats(self) -> dict:
        """Serving-tier counters for the shared warehouse: result-cache
        hits/misses/evictions/bytes, shared-scan publishes/attaches, and
        per-pool admission queue depths.  Counters are warehouse-wide
        (every connection sees the same serving tier)."""
        self._check_open()
        return self._wh.serving_stats()

    # ------------------------------------------------------------------
    # observability (PR 10)
    # ------------------------------------------------------------------
    def metrics(self) -> dict:
        """Snapshot of the warehouse :class:`MetricsRegistry` — every
        counter/gauge/histogram the serving tier, WLM, exchanges, and
        query driver report — plus per-``kernel[backend]`` dispatch counts
        from the engine registry and per-kernel CUDA launch counts
        (``kernels.launch.<name>``) from the kernel wrappers.  Shape:
        ``{"counters": {...}, "gauges": {...}, "histograms": {...}}``."""
        self._check_open()
        from ..kernels.registry import dispatch_counts, launch_counts

        out = self._wh.obs.metrics.snapshot()
        for name, n in dispatch_counts().items():
            out["counters"][f"kernels.dispatch.{name}"] = n
        for name, n in launch_counts().items():
            out["counters"][f"kernels.launch.{name}"] = n
        return out

    def query_log(self, limit: Optional[int] = None) -> List[dict]:
        """The warehouse's bounded ring of recently finished queries
        (always on, newest last): qid, sql, status, wall/queue-wait ms,
        rows, pool, cache_hit, error.  ``limit`` trims to the most recent
        N entries."""
        self._check_open()
        return self._wh.obs.query_log.entries(limit)

    def export_trace(self, query_id: str, path: str) -> str:
        """Write the stored :class:`QueryTrace` for ``query_id`` as Chrome
        trace-event JSON (open in Perfetto / ``chrome://tracing``).
        Requires the query to have run with tracing on (``obs.tracing``
        config or ``REPRO_OBS_TRACING=1``).  Returns ``path``."""
        self._check_open()
        return self._wh.obs.export_trace(query_id, path)

    def prepare(self, sql: str) -> PreparedStatement:
        """Parse + bind + optimize ``sql`` once; re-executions reuse the
        cached plan (see ``repro_torch.core.pipeline.PlanCache``)."""
        self._check_open()
        return PreparedStatement(self, sql)

    def execute(self, sql: str, params: Optional[Sequence] = None) -> Cursor:
        """Convenience: ``conn.cursor().execute(sql, params)``."""
        return self.cursor().execute(sql, params)

    def execute_async(self, sql: str,
                      params: Optional[Sequence] = None) -> QueryHandle:
        """Submit a statement without blocking; returns a
        :class:`~repro_torch.api.handle.QueryHandle` to poll, stream, cancel, or
        await.  Queries are admitted through the active workload-manager
        resource plan (per-pool ``query_parallelism``; paper §5.2) on the
        warehouse's shared scheduler.  Parsing runs synchronously, so syntax
        and parameter-arity errors raise here, not from the handle."""
        self._check_open()
        try:
            task = self._session.submit(sql, _params(params))
        except Exception as exc:  # noqa: BLE001 - translated to DB-API
            raise _translate_error(exc) from exc
        return QueryHandle(self, task)

    # ------------------------------------------------------------------
    # transaction surface: statements run under single-statement ACID
    # transactions (paper §3.2), i.e. autocommit
    # ------------------------------------------------------------------
    def commit(self) -> None:
        self._check_open()  # every statement auto-commits; nothing pending

    def rollback(self) -> None:
        self._check_open()
        raise NotSupportedError(
            "statements auto-commit under single-statement transactions"
        )

    # ------------------------------------------------------------------
    def close(self) -> None:
        if not self._closed and self._owns_warehouse:
            self._wh.close()  # attached warehouses outlive the connection
        self._closed = True

    def __enter__(self) -> "Connection":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _check_open(self) -> None:
        if self._closed:
            raise InterfaceError("connection is closed")
