"""DB-API 2.0 (PEP 249) exception hierarchy for the client layer."""
from __future__ import annotations


class Warning(Exception):  # noqa: A001 - PEP 249 name
    """Important warnings, e.g. data truncation during inserts."""


class Error(Exception):
    """Base of all other error exceptions."""


class InterfaceError(Error):
    """Errors related to the interface itself (e.g. closed cursor use)."""


class DatabaseError(Error):
    """Errors related to the warehouse."""


class DataError(DatabaseError):
    """Problems with the processed data (bad cast, value out of range)."""


class OperationalError(DatabaseError):
    """Errors in the warehouse's operation (memory pressure, I/O, ...)."""


class IntegrityError(DatabaseError):
    """Relational integrity violations (write conflicts, aborted txns)."""


class InternalError(DatabaseError):
    """The warehouse hit an internal inconsistency."""


class ProgrammingError(DatabaseError):
    """SQL syntax errors, missing tables, wrong parameter counts, ..."""


class NotSupportedError(DatabaseError):
    """A method or API the warehouse does not support (e.g. rollback)."""


class QueryKilledError(OperationalError):
    """The workload manager killed the query via a trigger rule (§5.2)."""


class QueryCancelledError(OperationalError):
    """The query was cancelled through :meth:`QueryHandle.cancel`."""
