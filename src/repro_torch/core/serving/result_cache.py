"""Byte-bounded serving result cache (paper §4.3 + §5 serving story).

A drop-in replacement for :class:`~..optimizer.result_cache.QueryResultCache`
(the warehouse wires it in as ``Warehouse.result_cache``) with the bounds a
serving tier needs: entries are charged by result bytes against a fixed
budget and evicted with the same LRFU policy LLAP's chunk cache uses
(``core/runtime/lrfu.py``), instead of a flat entry-count cap.  Validity is
unchanged — per-table write-ID snapshots, checked at lookup — so a hit is
always transactionally current, and the scheduler can serve it without
admission or execution.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

from ...analysis.lockdep import make_lock
from ..metastore import Metastore
from ..obs.metrics import MetricsRegistry
from ..obs.trace import current_trace, make_span
from ..optimizer.result_cache import CacheEntry
from ..runtime.exchange import batch_nbytes
from ..runtime.lrfu import LRFUPolicy
from ..runtime.vector import VectorBatch

DEFAULT_CACHE_BYTES = 64 << 20

_STAT_NAMES = ("hits", "misses", "pending_waits", "evictions", "fills",
               "invalidations")


class ResultCacheServer:
    def __init__(self, max_bytes: int = DEFAULT_CACHE_BYTES,
                 ttl_seconds: float = 3600.0, lrfu_lambda: float = 0.01,
                 metrics: Optional[MetricsRegistry] = None):
        self.max_bytes = int(max_bytes)
        self.ttl = ttl_seconds
        self._lock = make_lock("serving.result_cache")
        self._entries: Dict[str, CacheEntry] = {}
        self._sizes: Dict[str, int] = {}
        self._used = 0
        self._policy = LRFUPolicy(lrfu_lambda)
        # counters live in the warehouse MetricsRegistry (PR 10): the
        # legacy ``stats`` dict shape is *derived* from it (see property),
        # so server_stats()/metrics() can never drift apart
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._c = {name: self.metrics.counter(f"serving.result_cache.{name}")
                   for name in _STAT_NAMES}

    @property
    def stats(self) -> Dict[str, int]:
        return {name: c.value for name, c in self._c.items()}

    # -- snapshot helpers -----------------------------------------------------
    @staticmethod
    def _current_state(hms: Metastore, tables) -> Dict[str, Tuple[int, frozenset]]:
        snap = hms.get_snapshot()
        return {
            t: (wl.hwm, wl.invalid)
            for t in tables
            for wl in [hms.writeid_list(t, snap)]
        }

    # -- probe ----------------------------------------------------------------
    def lookup(self, key: str, hms: Metastore, tables) -> Optional[VectorBatch]:
        """Return cached results if still valid; may block on a pending
        entry (thundering-herd serialization, §4.3)."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self._c["misses"].inc()
                return None
            pending = entry.pending
        if pending is not None:
            self._c["pending_waits"].inc()
            # the waiter's own span (inside its stage:cache_probe), so the
            # wait is not read as planning
            with make_span(current_trace(), "cache:pending_wait", "serving"):
                pending.wait(timeout=60)
            with self._lock:
                entry = self._entries.get(key)
                if entry is None or entry.pending is not None:
                    self._c["misses"].inc()
                    return None
        if time.time() - entry.created_at > self.ttl:
            self._drop(key)
            self._c["misses"].inc()
            return None
        # transactional validity: tables must not contain new/modified data
        if self._current_state(hms, entry.snapshot.keys()) != entry.snapshot:
            self._drop(key)
            self._c["misses"].inc()
            return None
        with self._lock:
            entry.hits += 1
            self._c["hits"].inc()
            self._policy.on_access(key)
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

    # -- fill / cancel --------------------------------------------------------
    def fill(self, key: str, result: VectorBatch) -> None:
        nbytes = batch_nbytes(result)
        ev = None
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return
            if nbytes > self.max_bytes:
                # oversized result: release waiters, don't cache
                self._entries.pop(key, None)
                ev = entry.pending
            else:
                while (self._used + nbytes > self.max_bytes and self._sizes):
                    victim = self._policy.victim()
                    if victim is None:
                        break
                    self._evict(victim)
                entry.result = result
                entry.created_at = time.time()
                ev, entry.pending = entry.pending, None
                self._sizes[key] = nbytes
                self._used += nbytes
                self._policy.on_access(key)
                self._c["fills"].inc()
        if ev is not None:
            ev.set()

    def cancel_pending(self, key: str) -> None:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return
            if entry.pending is None:
                return  # already filled — keep the valid entry
            self._entries.pop(key, None)
            ev = entry.pending
        ev.set()

    # -- eviction / invalidation ----------------------------------------------
    def _evict(self, key: str) -> None:
        """Caller holds the lock.  Pending entries are never in the policy,
        so a victim is always a filled entry."""
        entry = self._entries.pop(key, None)
        if entry is not None:
            self._used -= self._sizes.pop(key, 0)
            self._c["evictions"].inc()
        self._policy.on_remove(key)

    def _drop(self, key: str) -> None:
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is not None:
                self._used -= self._sizes.pop(key, 0)
                self._policy.on_remove(key)

    def invalidate_all(self) -> None:
        with self._lock:
            pendings = [e.pending for e in self._entries.values()
                        if e.pending is not None]
            self._entries.clear()
            self._sizes.clear()
            self._used = 0
            self._policy = LRFUPolicy(self._policy.lam)
            self._c["invalidations"].inc()
        for ev in pendings:
            ev.set()

    # -- stats ----------------------------------------------------------------
    def stats_snapshot(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self.stats)
            out["entries"] = len(self._entries)
            out["bytes_used"] = self._used
            out["bytes_budget"] = self.max_bytes
            return out
