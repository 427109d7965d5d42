"""Public client API for the warehouse (DB-API 2.0 flavored).

The paper's §2 architecture keeps the client protocol (HiveServer2 / JDBC)
separate from the query driver; this package is that front-end for the
reproduction:

    import repro_torch.api as db

    with db.connect("/data/warehouse", engine="auto") as conn:
        cur = conn.cursor()
        cur.execute("SELECT region, SUM(amount) FROM sales "
                    "WHERE amount > ? GROUP BY region", (100.0,))
        print(cur.description)
        for row in cur.fetchmany(64):
            ...

    ps = conn.prepare("SELECT * FROM sales WHERE region = ?")
    ps.execute(("EMEA",)).fetchall()   # plan cached across executions

Statements can also run without blocking: ``conn.execute_async(sql)``
returns a :class:`~repro_torch.api.handle.QueryHandle` immediately.  The query
executes on the warehouse's scheduler worker pool behind workload-manager
admission (per-pool ``query_parallelism``; paper §5.2); the handle can be
polled for progress, cancelled, awaited (``result(timeout)``), or iterated
with ``fetch_stream()``, which yields row batches while the query is still
running.  The blocking ``Cursor.execute`` is a thin wrapper over this same
path, so there is one execution route for all clients.

Module globals follow PEP 249: ``apilevel``, ``threadsafety`` (connections
may be shared across threads), and ``paramstyle`` (``qmark``: ``?``).
"""
from .connection import Connection, connect
from .cursor import Cursor
from .exceptions import (
    DatabaseError,
    DataError,
    Error,
    IntegrityError,
    InterfaceError,
    InternalError,
    NotSupportedError,
    OperationalError,
    ProgrammingError,
    QueryCancelledError,
    QueryKilledError,
    Warning,
)
from .handle import QueryHandle
from .prepared import PreparedStatement

apilevel = "2.0"
threadsafety = 2
paramstyle = "qmark"

__all__ = [
    "Connection", "Cursor", "PreparedStatement", "QueryHandle", "connect",
    "apilevel", "threadsafety", "paramstyle",
    "Warning", "Error", "InterfaceError", "DatabaseError", "DataError",
    "OperationalError", "IntegrityError", "InternalError",
    "ProgrammingError", "NotSupportedError",
    "QueryKilledError", "QueryCancelledError",
]
