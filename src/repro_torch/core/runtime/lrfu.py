"""LRFU (Least Recently/Frequently Used) eviction policy (paper §5.1).

LLAP's default cache policy: each cached item carries a CRF (combined
recency-frequency) score ``F(0) + sum 2^(-lambda * age_i)`` over its past
accesses.  ``lambda`` interpolates between LRU (lambda -> large) and LFU
(lambda -> 0); the default is tuned for analytic scan-heavy workloads.
Eviction removes the lowest-CRF item.  The unit of eviction is the *chunk*
(row-group x column), matching the paper's compromise between bookkeeping
overhead and storage efficiency.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Dict, Hashable, Optional, Tuple


class LRFUPolicy:
    def __init__(self, lam: float = 0.01):
        self.lam = lam
        self.clock = itertools.count()
        self._crf: Dict[Hashable, float] = {}
        self._last: Dict[Hashable, int] = {}
        self._heap: list = []  # (crf_snapshot, tiebreak, key) lazy heap

    def _decay(self, crf: float, dt: int) -> float:
        return crf * (2.0 ** (-self.lam * dt))

    def on_access(self, key: Hashable) -> None:
        now = next(self.clock)
        old = self._crf.get(key, 0.0)
        dt = now - self._last.get(key, now)
        crf = 1.0 + self._decay(old, dt)
        self._crf[key] = crf
        self._last[key] = now
        heapq.heappush(self._heap, (crf, now, key))

    def on_remove(self, key: Hashable) -> None:
        self._crf.pop(key, None)
        self._last.pop(key, None)

    def victim(self) -> Optional[Hashable]:
        """Pop the key with the lowest current CRF (lazy-invalidated heap)."""
        while self._heap:
            crf_snap, at, key = heapq.heappop(self._heap)
            if key not in self._crf:
                continue
            # stale heap entry? current CRF recomputed at its last access
            if self._crf[key] > crf_snap + 1e-12 or self._last[key] != at:
                continue
            return key
        # fallback: linear scan (heap starved by staleness)
        if self._crf:
            now = next(self.clock)
            return min(
                self._crf,
                key=lambda k: self._decay(self._crf[k], now - self._last[k]),
            )
        return None
