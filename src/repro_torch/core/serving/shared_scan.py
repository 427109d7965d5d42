"""Shared scans: attach concurrent queries to an in-flight scan's exchange.

When two queries race over the same table, the second one normally re-reads
every stripe through LLAP.  The registry instead lets the first query's scan
vertex *publish* its output :class:`~..runtime.exchange.Exchange`; a later
query whose DAG contains an identical scan vertex (same fused
scan/filter/project subtree, same parameters, same per-table write-ID
state) attaches a second replaying reader to that exchange and never
touches storage.

Retention is refcounted: publishing forces ``retain = True`` on the
exchange, and the producer query's teardown *retires* the entry instead of
discarding the exchange outright — the last attached consumer to release
performs the actual ``discard()`` (and any deferred scratch-dir cleanup).
Attachment is race-safe against completion: ``attach`` fails once the entry
is retired, and the caller falls back to a fresh scan.  A snapshot or
write-ID difference changes the key itself, so stale data can never be
served.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from ...analysis.lockdep import make_lock
from ..obs.metrics import MetricsRegistry

_STAT_NAMES = ("published", "attached", "attach_misses", "fallbacks",
               "invalidated")


class _Entry:
    __slots__ = ("key", "table", "exchange", "refcount", "retired",
                 "on_final")

    def __init__(self, key, table: str, exchange):
        self.key = key
        self.table = table
        self.exchange = exchange
        self.refcount = 0
        self.retired = False
        # callbacks to run after the exchange is discarded (deferred
        # scratch-dir cleanup for the producer query)
        self.on_final: List[Callable[[], None]] = []


class SharedScanHandle:
    """One attached consumer's claim on a published scan exchange."""

    def __init__(self, registry: "SharedScanRegistry", entry: _Entry):
        self._registry = registry
        self._entry = entry
        self._released = False

    def reader(self) -> Iterator:
        return self._entry.exchange.reader()

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._registry._release(self._entry)


class SharedScanRegistry:
    """Warehouse-wide map of live scan-vertex exchanges keyed by identity.

    The key is built by the DAG scheduler from the vertex plan's ``key()``
    (which covers table, columns, pushed/partition filters and min
    write-ID), the query parameters, and the table's ``(hwm, invalid)``
    write-ID state — so only transactionally identical scans ever share.
    """

    def __init__(self, metrics: Optional[MetricsRegistry] = None):
        self._lock = make_lock("serving.shared_scans")
        self._entries: Dict[object, _Entry] = {}
        # counters live in the warehouse MetricsRegistry (PR 10): the
        # legacy ``stats`` dict shape is *derived* from it (see property)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._c = {name: self.metrics.counter(f"serving.shared_scans.{name}")
                   for name in _STAT_NAMES}

    @property
    def stats(self) -> Dict[str, int]:
        return {name: c.value for name, c in self._c.items()}

    # ------------------------------------------------------------- producer
    def publish(self, key, table: str, exchange) -> bool:
        """Register ``exchange`` as the live producer for ``key``.

        Returns False when another producer already holds the key (the
        caller keeps its exchange private and runs normally)."""
        with self._lock:
            if key in self._entries:
                return False
            self._entries[key] = _Entry(key, table, exchange)
            self._c["published"].inc()
            return True

    def retire(self, key, exchange,
               on_final: Optional[Callable[[], None]] = None) -> bool:
        """Producer teardown: drop the entry once no consumer needs it.

        Returns True when the exchange was fully released — the registry
        discarded it (or it was never published) and the caller runs its
        own cleanup.  Returns False when attached consumers are still
        replaying: the registry then owns the discard and runs ``on_final``
        after the last consumer releases."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or entry.exchange is not exchange:
                return True  # never published, or already torn down
            if entry.refcount > 0:
                entry.retired = True
                if on_final is not None:
                    entry.on_final.append(on_final)
                return False
            del self._entries[key]
        exchange.discard()
        return True

    # ------------------------------------------------------------- consumer
    def attach(self, key) -> Optional[SharedScanHandle]:
        """Attach a replaying reader to a live entry; None => fresh scan."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or entry.retired:
                self._c["attach_misses"].inc()
                return None
            entry.refcount += 1
            self._c["attached"].inc()
            return SharedScanHandle(self, entry)

    def note_fallback(self) -> None:
        with self._lock:
            self._c["fallbacks"].inc()

    def _release(self, entry: _Entry) -> None:
        with self._lock:
            entry.refcount -= 1
            last = entry.retired and entry.refcount == 0
            if last:
                self._entries.pop(entry.key, None)
                callbacks = list(entry.on_final)
        if last:
            entry.exchange.discard()
            for cb in callbacks:
                cb()

    # ------------------------------------------------------------ invalidate
    def invalidate_table(self, table: str) -> None:
        """DDL invalidation (DROP/rename): stop NEW attachments to scans of
        ``table``.  Consumers already attached keep replaying exchange
        chunks — those live in exchange memory/scratch, not table files —
        so a concurrent purge cannot corrupt them."""
        with self._lock:
            for key in [k for k, e in self._entries.items()
                        if e.table == table]:
                self._entries[key].retired = True
                self._c["invalidated"].inc()

    def invalidate_all(self) -> None:
        with self._lock:
            for e in self._entries.values():
                e.retired = True
                self._c["invalidated"].inc()

    # ------------------------------------------------------------ stats
    def stats_snapshot(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self.stats)
            out["live_entries"] = len(self._entries)
            return out
