"""Prepared statements: parse/bind/optimize once, execute many times.

``prepare()`` runs the planning half of the query pipeline immediately and
parks the optimized logical plan in the warehouse-wide plan cache (keyed by
statement text + planning config, like the query-result cache is keyed by
resolved query identity).  ``execute(params)`` then enters the pipeline with
the pre-parsed AST; the Bind stage's plan-cache probe skips parse + bind +
optimize, and only compile + execute run per invocation.  ``?`` placeholders
remain :class:`repro_torch.core.sql.ast.Param` nodes inside the cached plan, so
one plan serves every parameter binding.
"""
from __future__ import annotations

from typing import Optional, Sequence

from ..core.pipeline import (
    PlanCache,
    QueryContext,
    QueryPipeline,
    plan_only_stages,
)
from ..core.sql import ast as A
from ..core.sql.binder import BindError
from ..core.sql.parser import parse
from .cursor import Cursor, _params, _translate_error
from .exceptions import ProgrammingError


class PreparedStatement:
    """Created via :meth:`repro_torch.api.Connection.prepare`."""

    def __init__(self, connection, sql: str):
        self._conn = connection
        self.sql = sql
        try:
            self._stmt = parse(sql)
        except SyntaxError as exc:
            raise ProgrammingError(str(exc)) from exc
        if isinstance(self._stmt, A.Explain):
            raise ProgrammingError("cannot prepare EXPLAIN statements")
        self.is_query = isinstance(self._stmt, (A.Select, A.SetOp))
        self.param_count = A.count_params(self._stmt)
        if self.is_query:
            self._warm_plan_cache()

    def _warm_plan_cache(self) -> None:
        """Bind + optimize now so the first execute() already skips planning;
        also surfaces name-resolution errors at prepare time, like JDBC.
        The pipeline's Optimize stage fills the plan cache as a side effect
        (the context carries sql, so the cache key resolves)."""
        session = self._conn.session
        key = PlanCache.key_of(self.sql, session.config)
        if session.wh.plan_cache.get(key, session.hms) is not None:
            return
        try:
            q = QueryContext(session=session, sql=self.sql, stmt=self._stmt,
                             config=session.config)
            QueryPipeline(session, plan_only_stages()).run(q)
        except (BindError, KeyError) as exc:
            raise ProgrammingError(str(exc)) from exc

    def execute(self, params: Optional[Sequence] = None) -> Cursor:
        """Execute with the given parameter values; returns a fresh cursor."""
        values = _params(params)
        if len(values) != self.param_count:
            raise ProgrammingError(
                f"statement takes {self.param_count} parameter(s), "
                f"got {len(values)}"
            )
        cursor = self._conn.cursor()
        try:
            result = self._conn.session.execute_stmt(
                self._stmt, self.sql, values
            )
        except Exception as exc:  # noqa: BLE001 - translated to DB-API
            raise _translate_error(exc) from exc
        cursor._install(result)  # noqa: SLF001 - same package
        return cursor

    def __repr__(self):
        kind = "query" if self.is_query else "statement"
        return (f"PreparedStatement({kind}, params={self.param_count}, "
                f"sql={self.sql!r})")
