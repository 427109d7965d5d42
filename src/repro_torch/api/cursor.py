"""DB-API-style cursor: execute/executemany + streamed fetches.

Results stay columnar (``VectorBatch``) inside the cursor; ``fetchone`` /
``fetchmany`` materialize row tuples only for the slice being fetched, so
paging through a large result never converts the whole batch at once.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..core.runtime.cancel import QueryCancelledError as _CoreCancelled
from ..core.runtime.exec import ExecError, MemoryPressureError
from ..core.runtime.wlm import QueryKilledError as _CoreKilled
from ..core.session import QueryResult
from ..core.sql.binder import BindError
from ..core.sql.parser import parse
from ..core.metastore import TxnAborted, WriteConflict
from .exceptions import (
    DatabaseError,
    Error,
    IntegrityError,
    InterfaceError,
    OperationalError,
    ProgrammingError,
    QueryCancelledError,
    QueryKilledError,
)

# numpy dtype kind -> SQL type name surfaced in Cursor.description
_TYPE_CODES = {"i": "BIGINT", "u": "BIGINT", "f": "DOUBLE", "b": "BOOLEAN"}

_DML_COUNTERS = ("inserted", "updated", "deleted")


def _translate_error(exc: Exception) -> Exception:
    if isinstance(exc, Error):
        return exc  # already a DB-API error; don't re-wrap
    if isinstance(exc, _CoreKilled):
        return QueryKilledError(str(exc))
    if isinstance(exc, _CoreCancelled):
        return QueryCancelledError(str(exc))
    if isinstance(exc, (SyntaxError, BindError, KeyError, ValueError)):
        return ProgrammingError(str(exc))
    if isinstance(exc, (WriteConflict, TxnAborted)):
        return IntegrityError(str(exc))
    if isinstance(exc, (MemoryPressureError, ExecError, OSError)):
        return OperationalError(str(exc))
    return DatabaseError(str(exc))


class Cursor:
    """Created via :meth:`repro_torch.api.Connection.cursor`."""

    def __init__(self, connection):
        self._conn = connection
        self._closed = False
        self.arraysize = 1  # DB-API default page size for fetchmany()
        self._reset()

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def execute(self, operation: str, params: Optional[Sequence] = None
                ) -> "Cursor":
        """Execute a statement; ``?`` placeholders bind from ``params``.

        A thin blocking wrapper over the asynchronous handle path: the
        statement is submitted via :meth:`Connection.execute_async` (so it
        takes the same WLM-admitted scheduler route as every other query)
        and awaited to completion.
        """
        self._check_open()
        handle = self._conn.execute_async(operation, params)
        self._install(handle._wait_result())  # noqa: SLF001 - same package
        return self

    def executemany(self, operation: str,
                    seq_of_params: Sequence[Sequence]) -> "Cursor":
        """Run one statement against every parameter set (parsed once)."""
        self._check_open()
        try:
            stmt = parse(operation)
        except SyntaxError as exc:
            raise ProgrammingError(str(exc)) from exc
        total = 0
        result = None
        for params in seq_of_params:
            try:
                result = self._session.execute_stmt(stmt, operation,
                                                    _params(params))
            except Exception as exc:  # noqa: BLE001
                raise _translate_error(exc) from exc
            total += max(_rowcount_of(result), 0)
        if result is None:
            self._reset()
        else:
            self._install(result)
        self.rowcount = total
        return self

    # ------------------------------------------------------------------
    # fetching
    # ------------------------------------------------------------------
    def fetchone(self) -> Optional[tuple]:
        rows = self.fetchmany(1)
        return rows[0] if rows else None

    def fetchmany(self, size: Optional[int] = None) -> List[tuple]:
        self._check_open()
        if self._batch is None:
            raise InterfaceError("no result set: call execute() first")
        size = self.arraysize if size is None else size
        if size <= 0:
            return []
        page = self._batch.slice(self._pos, self._pos + size)
        self._pos += page.num_rows
        return page.to_rows()

    def fetchall(self) -> List[tuple]:
        self._check_open()
        if self._batch is None:
            raise InterfaceError("no result set: call execute() first")
        rest = self._batch.slice(self._pos, self._batch.num_rows)
        self._pos = self._batch.num_rows
        return rest.to_rows()

    def __iter__(self):
        return self

    def __next__(self) -> tuple:
        row = self.fetchone()
        if row is None:
            raise StopIteration
        return row

    # ------------------------------------------------------------------
    # metadata / lifecycle
    # ------------------------------------------------------------------
    @property
    def connection(self):
        return self._conn

    @property
    def info(self) -> dict:
        """Engine-side execution info of the last statement (cache hits,
        per-stage timings, DAG edges, ...)."""
        return dict(self._info)

    def setinputsizes(self, sizes) -> None:  # PEP 249: may be a no-op
        pass

    def setoutputsize(self, size, column=None) -> None:
        pass

    def close(self) -> None:
        self._closed = True
        self._reset()

    def __enter__(self) -> "Cursor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    @property
    def _session(self):
        return self._conn._session  # noqa: SLF001 - same package

    def _check_open(self) -> None:
        if self._closed:
            raise InterfaceError("cursor is closed")
        self._conn._check_open()  # noqa: SLF001

    def _reset(self) -> None:
        self._batch = None
        self._pos = 0
        self._info: dict = {}
        self.description: Optional[List[Tuple]] = None
        self.rowcount = -1

    def _install(self, result: QueryResult) -> None:
        self._info = result.info
        is_query = bool(result.batch.cols) or not any(
            k in result.info for k in _DML_COUNTERS
        )
        if result.batch.cols:
            self._batch = result.batch
            self._pos = 0
            self.description = [
                (_base_name(c), _TYPE_CODES.get(v.dtype.kind, "STRING"),
                 None, None, None, None, True)
                for c, v in result.batch.cols.items()
            ]
            self.rowcount = result.num_rows
        else:
            self._batch = None
            self._pos = 0
            self.description = None
            self.rowcount = _rowcount_of(result) if not is_query else 0


def _params(params: Optional[Sequence]) -> tuple:
    if params is None:
        return ()
    if isinstance(params, (str, bytes)):
        raise ProgrammingError("params must be a sequence of values, "
                               "not a string")
    return tuple(params)


def _rowcount_of(result: QueryResult) -> int:
    if any(k in result.info for k in _DML_COUNTERS):
        return sum(int(result.info.get(k, 0)) for k in _DML_COUNTERS)
    return result.num_rows if result.batch.cols else -1


def _base_name(qualified: str) -> str:
    return qualified.split(".", 1)[1] if "." in qualified else qualified
