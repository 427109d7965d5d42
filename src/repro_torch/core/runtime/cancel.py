"""Cooperative cancellation for in-flight queries.

A :class:`CancelToken` travels with a query from the client handle through
``QueryContext``/``ExecContext`` into the DAG scheduler; vertex boundaries
(and the WLM admission wait) poll it.  Two trip kinds exist, because the
paper distinguishes them (§5.2): a *cancel* originates from the client
(``QueryHandle.cancel()``) and surfaces as :class:`QueryCancelledError`,
while a *kill* originates from a workload-manager trigger rule and surfaces
as :class:`repro_torch.core.runtime.wlm.QueryKilledError`.
"""
from __future__ import annotations

import threading
from typing import Optional

from ...analysis.lockdep import make_lock
from .wlm import QueryKilledError


class QueryCancelledError(Exception):
    """The query was cancelled by the client before it completed."""


class CancelToken:
    """Thread-safe, single-trip cancellation flag (first trip wins)."""

    def __init__(self):
        self._event = threading.Event()
        self._lock = make_lock("cancel_token")
        self.reason: str = ""
        self.kind: Optional[str] = None  # 'cancel' | 'kill'

    def cancel(self, reason: str = "cancelled by client") -> None:
        self._trip("cancel", reason)

    def kill(self, reason: str = "killed by workload manager") -> None:
        self._trip("kill", reason)

    def _trip(self, kind: str, reason: str) -> None:
        with self._lock:
            if self.kind is None:
                self.kind = kind
                self.reason = reason
        self._event.set()

    def is_set(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def check(self) -> None:
        """Raise at a cancellation point if the token has tripped."""
        if not self._event.is_set():
            return
        if self.kind == "kill":
            raise QueryKilledError(self.reason)
        raise QueryCancelledError(self.reason)
