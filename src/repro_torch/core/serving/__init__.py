"""Serving tier for high-concurrency workloads (ROADMAP open item 3).

The paper's LLAP layer (§5) exists so that many concurrent queries share
IO, cache and daemon capacity instead of each re-reading the warehouse.
This package holds the warehouse-wide pieces of that story:

  * :class:`SharedScanRegistry` — in-flight scan vertices publish their
    output exchange; a concurrent query whose DAG contains the same scan
    (same plan subtree, same write-ID snapshot) *attaches* as a second
    consumer instead of re-reading through LLAP.
  * :class:`ResultCacheServer` — byte-bounded, LRFU-evicted, write-ID
    invalidated full-result cache, so repeated dashboard queries are
    served without admission or execution.

Sharded WLM admission (lock striping per pool) lives in
``core/runtime/wlm.py``; the session config knobs are
``serving.shared_scans`` and ``serving.result_cache``.
"""
from .result_cache import ResultCacheServer
from .shared_scan import SharedScanHandle, SharedScanRegistry

__all__ = ["ResultCacheServer", "SharedScanHandle", "SharedScanRegistry"]
