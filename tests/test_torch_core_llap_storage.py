"""LLAP cache + I/O elevator (§5.1), stripe files, stats sketches."""
from _torch_core import star_schema  # noqa: F401
import os

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

from repro_torch.core.bloomfilter import BloomFilter
from repro_torch.core.runtime.lrfu import LRFUPolicy
from repro_torch.core.runtime.vector import VectorBatch
from repro_torch.core.stats import HyperLogLogPP, compute_column_stats
from repro_torch.core.storage import (
    SargPredicate,
    read_file_meta,
    write_stripe_file,
)


def test_stripe_file_roundtrip_and_sarg_skip(tmp_path):
    from repro_torch.core.runtime.llap import LlapDaemon, LlapIO

    n = 40_000
    batch = VectorBatch({
        "k": np.arange(n, dtype=np.int64),
        "v": np.linspace(0, 1, n),
    })
    path = str(tmp_path / "f.tahoe")
    meta = write_stripe_file(path, batch, stripe_rows=8192, bloom_columns=["k"])
    assert meta.num_rows == n and len(meta.stripes) == 5

    daemon = LlapDaemon(cache_bytes=64 << 20)
    io = LlapIO(daemon)
    # predicate selecting only the first stripe -> 4 stripes skipped
    m2, out = io.read_file(path, ["k", "v"],
                           sarg_preds=[SargPredicate("k", "<", 100)])
    assert daemon.counters["stripes_skipped"] == 4
    assert out.num_rows == 8192  # stripe granularity; row filter comes later


def test_llap_cache_hits_and_mvcc_identity(tmp_path):
    from repro_torch.core.runtime.llap import LlapDaemon, LlapIO

    batch = VectorBatch({"x": np.arange(10_000)})
    p1 = str(tmp_path / "a.tahoe")
    write_stripe_file(p1, batch)
    daemon = LlapDaemon()
    io = LlapIO(daemon)
    io.read_file(p1, ["x"])
    misses = daemon.counters["cache_misses"]
    io.read_file(p1, ["x"])
    assert daemon.counters["cache_misses"] == misses  # warm
    assert daemon.counters["cache_hits"] > 0
    # a different file with identical rows has a different content file_id:
    # cache entries never collide across file versions (MVCC at file level)
    p2 = str(tmp_path / "b.tahoe")
    write_stripe_file(p2, VectorBatch({"x": np.arange(10_000) + 1}))
    io.read_file(p2, ["x"])
    assert daemon.counters["cache_misses"] > misses


def test_llap_eviction_under_pressure(tmp_path):
    from repro_torch.core.runtime.llap import LlapDaemon, LlapIO

    daemon = LlapDaemon(cache_bytes=200_000)  # tiny pool
    io = LlapIO(daemon)
    for i in range(6):
        p = str(tmp_path / f"f{i}.tahoe")
        # distinct content per file (identical content shares a file_id
        # and deduplicates in the cache — by design)
        write_stripe_file(p, VectorBatch({"x": np.arange(10_000) * (i + 1)}))
        io.read_file(p, ["x"])
    used, cap = daemon.cache_usage()
    assert used <= cap
    assert daemon.counters["evictions"] > 0


def test_lrfu_policy_prefers_frequent():
    pol = LRFUPolicy(lam=0.1)
    for _ in range(5):
        pol.on_access("hot")
    pol.on_access("cold")
    pol.on_access("hot")
    assert pol.victim() == "cold"


def test_hll_accuracy_and_merge():
    h1, h2 = HyperLogLogPP(12), HyperLogLogPP(12)
    for i in range(3000):
        h1.add(i)
    for i in range(2000, 5000):
        h2.add(i)
    merged = h1.merge(h2)
    assert abs(merged.cardinality() - 5000) / 5000 < 0.05
    # serialization roundtrip
    again = HyperLogLogPP.deserialize(merged.serialize())
    assert again.cardinality() == merged.cardinality()


def test_column_stats_additive(star_schema):
    st_ = star_schema.hms.get_stats("store_sales")
    assert st_.row_count == 8000
    cs = st_.columns["ss_customer_sk"]
    assert abs(cs.ndv - 300) / 300 < 0.06


@settings(max_examples=25, deadline=None)
@given(members=st.sets(st.integers(0, 10_000), min_size=1, max_size=300),
       probes=st.lists(st.integers(0, 10_000), min_size=1, max_size=100))
def test_property_bloom_no_false_negatives(members, probes):
    bf = BloomFilter.for_expected(len(members))
    bf.add(np.array(sorted(members)))
    got = bf.might_contain(np.array(probes))
    for p, g in zip(probes, got):
        if p in members:
            assert g  # bloom filters never produce false negatives
