"""Query results cache (paper §4.3).

Keyed by the *resolved* query text (table references qualified) so two
queries with identical text against different databases don't collide.  Each
entry remembers the per-table WriteId snapshot it was computed under; a hit
is only served when the participating tables still have the same
transactional state.  A *pending entry* mode serializes a thundering herd of
identical queries behind the first executor (§4.3).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from ...analysis.lockdep import make_lock
from ..metastore import Metastore, WriteIdList
from ..runtime.vector import VectorBatch


@dataclass
class CacheEntry:
    result: Optional[VectorBatch]
    snapshot: Dict[str, Tuple[int, frozenset]]  # table -> (hwm, invalid set)
    created_at: float = field(default_factory=time.time)
    hits: int = 0
    pending: Optional[threading.Event] = None


class QueryResultCache:
    def __init__(self, max_entries: int = 256, ttl_seconds: float = 3600.0):
        self.max_entries = max_entries
        self.ttl = ttl_seconds
        self._lock = make_lock("optimizer.result_cache")
        self._entries: Dict[str, CacheEntry] = {}
        self.stats = {"hits": 0, "misses": 0, "pending_waits": 0}

    # -- snapshot helpers ------------------------------------------------------
    @staticmethod
    def _current_state(hms: Metastore, tables) -> Dict[str, Tuple[int, frozenset]]:
        snap = hms.get_snapshot()
        return {
            t: (wl.hwm, wl.invalid)
            for t in tables
            for wl in [hms.writeid_list(t, snap)]
        }

    def lookup(self, key: str, hms: Metastore, tables) -> Optional[VectorBatch]:
        """Return cached results if valid; may block on a pending entry."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.stats["misses"] += 1
                return None
            pending = entry.pending
        if pending is not None:
            self.stats["pending_waits"] += 1
            pending.wait(timeout=60)
            with self._lock:
                entry = self._entries.get(key)
                if entry is None or entry.pending is not None:
                    self.stats["misses"] += 1
                    return None
        if time.time() - entry.created_at > self.ttl:
            with self._lock:
                self._entries.pop(key, None)
            self.stats["misses"] += 1
            return None
        # transactional validity: tables must not contain new/modified data
        if self._current_state(hms, entry.snapshot.keys()) != entry.snapshot:
            with self._lock:
                self._entries.pop(key, None)
            self.stats["misses"] += 1
            return None
        entry.hits += 1
        self.stats["hits"] += 1
        return entry.result

    def begin_pending(self, key: str, hms: Metastore, tables) -> bool:
        """Install a pending entry; True if we are the filling query."""
        with self._lock:
            if key in self._entries:
                return False
            self._entries[key] = CacheEntry(
                result=None,
                snapshot=self._current_state(hms, tables),
                pending=threading.Event(),
            )
            return True

    def fill(self, key: str, result: VectorBatch) -> None:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return
            entry.result = result
            entry.created_at = time.time()
            ev, entry.pending = entry.pending, None
        if ev is not None:
            ev.set()
        self._expunge()

    def cancel_pending(self, key: str) -> None:
        with self._lock:
            entry = self._entries.pop(key, None)
        if entry is not None and entry.pending is not None:
            entry.pending.set()

    def _expunge(self) -> None:
        with self._lock:
            if len(self._entries) <= self.max_entries:
                return
            # drop stale/least-hit entries first
            victims = sorted(
                self._entries.items(), key=lambda kv: (kv[1].hits, kv[1].created_at)
            )
            for k, _ in victims[: len(self._entries) - self.max_entries]:
                self._entries.pop(k, None)

    def invalidate_all(self) -> None:
        with self._lock:
            self._entries.clear()
