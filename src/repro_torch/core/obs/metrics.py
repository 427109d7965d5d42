"""Warehouse-wide metrics registry: counters, gauges, bucketed histograms.

One :class:`MetricsRegistry` per warehouse is the single source for every
counter the surfaces report — WLM admission, serving-tier hits, exchange
spill volume, query outcomes/latency.  The existing dict shapes
(``server_stats()``, ``poll()["serving"]``, ``stats_snapshot()``) are
*derived* from registry-backed counters so the surfaces can't drift from
the registry, and ``Connection.metrics()`` exposes the whole snapshot.

Counters are registry-locked (increments happen on cold paths: spills,
admissions, query completion — never per morsel).  Gauges are callables
evaluated at snapshot time.  Histograms use fixed millisecond buckets with
rank-interpolated p50/p99 estimates.
"""
from __future__ import annotations

import bisect
from typing import Callable, Dict, List, Optional, Sequence

from ...analysis.lockdep import make_lock

#: Latency buckets (milliseconds), upper bounds; one overflow bucket above.
DEFAULT_BUCKETS_MS = (1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0, 2500.0, 5000.0, 10000.0)


class Counter:
    __slots__ = ("_lock", "_v")

    def __init__(self, lock):
        self._lock = lock
        self._v = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._v


class Histogram:
    __slots__ = ("_lock", "buckets", "_counts", "_sum", "_n")

    def __init__(self, lock, buckets: Sequence[float] = DEFAULT_BUCKETS_MS):
        self._lock = lock
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._counts: List[int] = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._n = 0

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.buckets, float(value))
        with self._lock:
            self._counts[i] += 1
            self._sum += float(value)
            self._n += 1

    def _quantile(self, q: float) -> Optional[float]:
        """Bucket-resolution quantile: the upper bound of the bucket the
        rank lands in (overflow bucket reports the largest bound)."""
        if self._n == 0:
            return None
        rank = q * self._n
        seen = 0
        for i, c in enumerate(self._counts):
            seen += c
            if seen >= rank:
                return self.buckets[min(i, len(self.buckets) - 1)]
        return self.buckets[-1]

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            total, n = self._sum, self._n
            p50, p99 = self._quantile(0.50), self._quantile(0.99)
        bucket_counts = {
            f"le_{self.buckets[i]:g}": counts[i]
            for i in range(len(self.buckets))
        }
        bucket_counts["overflow"] = counts[-1]
        return {"count": n, "sum": round(total, 3),
                "mean": round(total / n, 3) if n else None,
                "p50": p50, "p99": p99, "buckets": bucket_counts}


class MetricsRegistry:
    """Named counters / gauges / histograms with a JSON-able snapshot."""

    def __init__(self):
        self._lock = make_lock("obs.metrics")
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Callable[[], object]] = {}
        self._hists: Dict[str, Histogram] = {}

    # -- instruments --------------------------------------------------------
    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(self._lock)
            return c

    def inc(self, name: str, n: int = 1) -> None:
        self.counter(name).inc(n)

    def gauge(self, name: str, fn: Callable[[], object]) -> None:
        """Register (or replace) a gauge evaluated at snapshot time."""
        with self._lock:
            self._gauges[name] = fn

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_BUCKETS_MS) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(self._lock, buckets)
            return h

    def observe(self, name: str, value: float) -> None:
        self.histogram(name).observe(value)

    # -- snapshot -----------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            counters = {k: c._v for k, c in sorted(self._counters.items())}
            gauges = dict(self._gauges)
            hists = dict(self._hists)
        gauge_vals = {}
        for name, fn in sorted(gauges.items()):
            try:
                gauge_vals[name] = fn()
            except Exception:  # noqa: BLE001 - telemetry must not raise
                gauge_vals[name] = None
        return {"counters": counters, "gauges": gauge_vals,
                "histograms": {k: h.snapshot()
                               for k, h in sorted(hists.items())}}
