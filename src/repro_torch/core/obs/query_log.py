"""Always-on bounded ring buffer of completed queries.

The warehouse records one entry per completed query — status, wall time,
rows, admission wait, cache / shared-scan disposition — regardless of
whether tracing is on, so ``Connection.query_log()`` can answer "what ran
here lately" with zero configuration.  Capacity comes from the declared
``obs.query_log_size`` default (the ring is warehouse-wide; oldest entries
evict first).
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

from ...analysis.lockdep import make_lock


class QueryLog:
    def __init__(self, capacity: int = 128):
        self.capacity = max(int(capacity), 1)
        self._lock = make_lock("obs.query_log")
        self._entries: deque = deque(maxlen=self.capacity)

    def record(self, entry: Dict) -> None:
        with self._lock:
            self._entries.append(dict(entry))

    def entries(self, limit: Optional[int] = None) -> List[Dict]:
        """Oldest-first list of retained entries (copies); ``limit`` keeps
        only the most recent N."""
        with self._lock:
            out = [dict(e) for e in self._entries]
        return out[-int(limit):] if limit else out

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
