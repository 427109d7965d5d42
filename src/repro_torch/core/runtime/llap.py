"""LLAP — Live Long and Process (paper §5.1).

A persistent daemon providing:

  * an **I/O elevator**: column batches are read stripe-by-stripe on separate
    I/O threads, decoded into the internal columnar format, and handed to
    execution as soon as each batch is ready; projections, sargable
    predicates and bloom filters are pushed into the reader so entire row
    groups are skipped before any decode happens;
  * a **multi-tenant chunk cache**: decoded (file, stripe, column) chunks in
    an LRFU-evicted buffer pool.  Cache identity is the content-derived
    ``file_id`` (HDFS unique-id / S3 ETag analogue), so the cache remains an
    MVCC view: ACID visibility is decided at the file level by the snapshot,
    never by the cache;
  * a **bulk metadata cache**: file footers (incl. min/max + bloom indexes)
    are cached even for data never admitted to the cache, so predicate
    evaluation can decide what to load without touching the data;
  * persistent **executors** that query fragments are scheduled onto (the
    DAG scheduler uses this pool when LLAP is enabled; otherwise it spins up
    throwaway "containers").
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ...analysis.lockdep import make_rlock
from ..bloomfilter import BloomFilter
from ..storage import (
    FileMeta,
    SargPredicate,
    read_file_meta,
    read_stripe_column,
    stripe_may_match,
)
from .lrfu import LRFUPolicy
from .vector import VectorBatch


class LlapDaemon:
    """One in-process daemon standing in for the per-node daemon fleet."""

    def __init__(
        self,
        cache_bytes: int = 256 << 20,
        num_executors: int = 4,
        io_threads: int = 4,
        lrfu_lambda: float = 0.01,
    ):
        self.cache_bytes = cache_bytes
        self._chunks: Dict[Tuple[str, int, str], np.ndarray] = {}
        self._chunk_sizes: Dict[Tuple[str, int, str], int] = {}
        self._used = 0
        self._policy = LRFUPolicy(lrfu_lambda)
        self._meta: Dict[str, Tuple[float, FileMeta]] = {}  # path -> (mtime, meta)
        self._lock = make_rlock("llap")
        self.executors = ThreadPoolExecutor(
            max_workers=num_executors, thread_name_prefix="llap-exec"
        )
        self.io_pool = ThreadPoolExecutor(
            max_workers=io_threads, thread_name_prefix="llap-io"
        )
        self.counters = {
            "cache_hits": 0,
            "cache_misses": 0,
            "meta_hits": 0,
            "meta_misses": 0,
            "stripes_skipped": 0,
            "stripes_read": 0,
            "bytes_cached": 0,
            "evictions": 0,
        }

    def shutdown(self) -> None:
        """Release the executor/IO thread pools (daemon decommission)."""
        self.executors.shutdown(wait=False)
        self.io_pool.shutdown(wait=False)

    # ------------------------------------------------------------- metadata
    def file_meta(self, path: str) -> FileMeta:
        mtime = os.path.getmtime(path)
        with self._lock:
            hit = self._meta.get(path)
            if hit is not None and hit[0] == mtime:
                self.counters["meta_hits"] += 1
                return hit[1]
        meta = read_file_meta(path)
        with self._lock:
            self._meta[path] = (mtime, meta)
            self.counters["meta_misses"] += 1
        return meta

    # ------------------------------------------------------------- chunks
    def _get_chunk(self, path: str, meta: FileMeta, stripe: int, col: str) -> np.ndarray:
        key = (meta.file_id, stripe, col)
        with self._lock:
            if key in self._chunks:
                self.counters["cache_hits"] += 1
                self._policy.on_access(key)
                return self._chunks[key]
        arr = read_stripe_column(path, stripe, col)
        nbytes = arr.nbytes
        with self._lock:
            self.counters["cache_misses"] += 1
            if key not in self._chunks:
                while self._used + nbytes > self.cache_bytes and self._chunks:
                    victim = self._policy.victim()
                    if victim is None:
                        break
                    self._evict(victim)
                if self._used + nbytes <= self.cache_bytes:
                    self._chunks[key] = arr
                    self._chunk_sizes[key] = nbytes
                    self._used += nbytes
                    self.counters["bytes_cached"] += nbytes
                    self._policy.on_access(key)
        return arr

    def _evict(self, key) -> None:
        arr = self._chunks.pop(key, None)
        if arr is not None:
            self._used -= self._chunk_sizes.pop(key, 0)
            self.counters["evictions"] += 1
        self._policy.on_remove(key)

    def invalidate_file(self, file_id: str) -> None:
        with self._lock:
            for key in [k for k in self._chunks if k[0] == file_id]:
                self._evict(key)

    def invalidate_location(self, location: str) -> None:
        """DDL invalidation: drop cached footers and data chunks for every
        file under ``location`` (e.g. a dropped table's directory), so a
        table re-created at the same path never serves the old bytes."""
        prefix = location.rstrip(os.sep) + os.sep
        with self._lock:
            victims = [p for p in self._meta
                       if p == location or p.startswith(prefix)]
            file_ids = {self._meta[p][1].file_id for p in victims}
            for p in victims:
                del self._meta[p]
            for key in [k for k in self._chunks if k[0] in file_ids]:
                self._evict(key)

    def cache_usage(self) -> Tuple[int, int]:
        return self._used, self.cache_bytes

    def reset_counters(self) -> None:
        for k in self.counters:
            self.counters[k] = 0


class LlapIO:
    """The I/O-elevator facade handed to scans (drop-in for PlainIO)."""

    def __init__(self, daemon: LlapDaemon):
        self.daemon = daemon

    def read_meta(self, path: str) -> FileMeta:
        return self.daemon.file_meta(path)

    def read_file_chunks(
        self,
        path: str,
        columns: Optional[Sequence[str]] = None,
        sarg_preds: Sequence[SargPredicate] = (),
        runtime_blooms: Optional[Dict[str, BloomFilter]] = None,
    ):
        """Stream one decoded ``VectorBatch`` per surviving stripe.

        The I/O elevator fans stripe loads out on the I/O pool and hands each
        column batch to the operator pipeline as soon as it lands — the
        consumer processes stripe N while stripes N+1.. are still loading,
        instead of waiting for the whole file to decode."""
        from ..acid import _bloom_masked

        # metadata first — in bulk, before any data I/O (paper §5.1)
        meta = self.daemon.file_meta(path)
        cols = list(columns) if columns is not None else meta.columns

        wanted_stripes = []
        for si, smeta in enumerate(meta.stripes):
            if sarg_preds and not stripe_may_match(smeta, sarg_preds):
                self.daemon.counters["stripes_skipped"] += 1
                continue
            wanted_stripes.append(si)

        def load(si: int) -> Dict[str, np.ndarray]:
            return {c: self.daemon._get_chunk(path, meta, si, c) for c in cols}

        futures = [self.daemon.io_pool.submit(load, si) for si in wanted_stripes]
        for fut in futures:
            stripe_cols = fut.result()
            self.daemon.counters["stripes_read"] += 1
            yield _bloom_masked(stripe_cols, cols, runtime_blooms)

    def read_file(
        self,
        path: str,
        columns: Optional[Sequence[str]] = None,
        sarg_preds: Sequence[SargPredicate] = (),
        runtime_blooms: Optional[Dict[str, BloomFilter]] = None,
    ) -> Tuple[FileMeta, VectorBatch]:
        meta = self.daemon.file_meta(path)
        cols = list(columns) if columns is not None else meta.columns
        chunks = list(self.read_file_chunks(path, columns, sarg_preds,
                                            runtime_blooms))
        if chunks:
            return meta, VectorBatch.concat(chunks)
        return meta, VectorBatch({
            c: np.empty(0, dtype=meta.dtypes.get(c, "f8")) for c in cols
        })
