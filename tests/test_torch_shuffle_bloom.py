"""The port's hash_partition and bloom_probe against the JAX package's.

The same numpy inputs, made from a seed, go through the JAX Pallas kernel
(interpret mode on the CPU), the JAX plain version, the numpy host paths of
both packages (``partition_codes``, ``BloomFilter.might_contain``) and the
port's plain torch version and wrapper.  On the CPU the wrapper takes the
plain version because its tensors lie on the CPU; the CUDA kernels are
tested in test_torch_cuda.py.  Every comparison is exact: both functions are
integer maps, and lanes must agree bit for bit across the kernel and host
paths because one edge of a shuffle join may take either.
"""
import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.core.bloomfilter import BloomFilter as JxBloomFilter
from repro.core.runtime.shuffle import partition_codes as jx_partition_codes
from repro.core.runtime.vector import VectorBatch as JxVectorBatch
from repro.kernels.bloom.ops import probe_bloom_filter as jx_probe
from repro.kernels.hash_partition.ops import hash_partition as jx_hash_partition
from repro_torch.core.bloomfilter import BloomFilter, hash_values
from repro_torch.core.runtime.shuffle import partition_codes
from repro_torch.core.runtime.vector import VectorBatch
from repro_torch.kernels import registry
from repro_torch.kernels.bloom.ops import (bloom_probe, bloom_probe_cuda,
                                           probe_bloom_filter)
from repro_torch.kernels.bloom.ref import bloom_probe_ref
from repro_torch.kernels.hash_partition.ops import (hash_partition,
                                                    hash_partition_cuda)
from repro_torch.kernels.hash_partition.ref import hash_partition_ref
from test_torch_cuda import _np, _t

PARTITIONS = (1, 2, 4, 7, 8)


# ---------------------------------------------------------------------------
# hash_partition
# ---------------------------------------------------------------------------
def _keys(n, k, seed):
    """K key columns: ints, floats and int-valued floats in turn, with
    -0.0, +0.0 and NaN (the executor's NULL) at random rows."""
    rng = np.random.default_rng(seed)
    cols = []
    for i in range(k):
        if i % 3 == 0:
            cols.append(rng.integers(-5000, 5000, n).astype(np.int64))
            continue
        c = (rng.normal(size=n) * 100 if i % 3 == 1
             else rng.integers(-50, 50, n).astype(np.float64))
        for v in (-0.0, 0.0, np.nan, -np.nan):
            c[rng.integers(0, max(n, 1), max(1, n // 16))[: n]] = v
        cols.append(c)
    return cols


@pytest.mark.parametrize("n", [0, 1, 1023, 8193])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_hash_partition_matches_jax_and_host(n, k):
    cols = _keys(n, k, seed=10 * n + k)
    f32 = tuple(c.astype(np.float32) for c in cols)
    names = [f"c{i}" for i in range(k)]
    batch = VectorBatch(dict(zip(names, cols)))
    jx_batch = JxVectorBatch(dict(zip(names, cols)))
    for p in PARTITIONS:
        port = _np(hash_partition_ref([_t(c) for c in f32], p))
        assert port.dtype == np.int32 and port.shape == (n,)
        assert ((port >= 0) & (port < p)).all()
        wrap = _np(hash_partition_cuda([_t(c) for c in f32], p))
        assert np.array_equal(wrap, port), p
        for eng in ("ref", "pallas"):
            jx = np.asarray(jx_hash_partition(f32, p, engine=eng))
            assert np.array_equal(port, jx), (eng, p)
        host = partition_codes(batch, names, p, engine="auto")
        assert np.array_equal(host, port.astype(np.int64)), p
        assert np.array_equal(
            jx_partition_codes(jx_batch, names, p, engine="auto"), host), p
        assert np.array_equal(partition_codes(batch, names, p, engine="ref"),
                              host), p


def test_hash_partition_ref_casts_like_numpy():
    """The plain version takes float32(col) of any numeric column, as the
    host path does, including NaN payloads of float64 NULLs."""
    cols = _keys(4096, 3, seed=3)
    for p in (4, 8):
        port = _np(hash_partition(tuple(_t(c) for c in cols), p,
                                  engine="ref"))
        host = partition_codes(VectorBatch({"a": cols[0], "b": cols[1],
                                            "c": cols[2]}),
                               ["a", "b", "c"], p, engine="auto")
        assert np.array_equal(port.astype(np.int64), host)


def test_hash_partition_zero_signs_and_nan_share_lanes():
    x = np.array([0.0, -0.0, np.nan, np.nan, 7.0, 7.0], dtype=np.float32)
    lanes = _np(hash_partition_ref([_t(x)], 8))
    assert lanes[0] == lanes[1] and lanes[2] == lanes[3]
    assert lanes[4] == lanes[5]


def test_partition_codes_mixed_keys_take_host_path():
    """A string key keeps the whole key set on the host path, so no
    kernel is dispatched and the lanes equal the reference's."""
    rng = np.random.default_rng(4)
    a = rng.integers(0, 100, 2000)
    s = np.array(["x", "yy", "zzz"])[rng.integers(0, 3, 2000)]
    before = registry.dispatch_counts().get("hash_partition[ref]", 0)
    got = partition_codes(VectorBatch({"a": a, "s": s}), ["a", "s"], 4,
                          engine="ref")
    assert registry.dispatch_counts().get("hash_partition[ref]", 0) == before
    exp = jx_partition_codes(JxVectorBatch({"a": a, "s": s}), ["a", "s"], 4)
    assert np.array_equal(got, exp)


# ---------------------------------------------------------------------------
# bloom_probe
# ---------------------------------------------------------------------------
def _filters(num_bits, k, members, seed):
    """The same filter built by both packages from the same members."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 4 * members + 1000, members)
    bf, jbf = BloomFilter(num_bits, k), JxBloomFilter(num_bits, k)
    bf.add(keys)
    jbf.add(keys)
    assert np.array_equal(bf.bits, jbf.bits)
    queries = np.concatenate([keys, rng.integers(0, 4 * members + 1000,
                                                 8192)])
    return bf, jbf, queries


@pytest.mark.parametrize("num_bits,k,members", [
    (64, 6, 5), (512, 6, 60), (32768, 6, 4000), (1 << 20, 6, 20_000),
    (4096, 1, 400), (4096, 3, 400), (4096, 8, 400), (128, 2, 40)])
def test_bloom_probe_matches_jax_and_host(num_bits, k, members):
    bf, jbf, queries = _filters(num_bits, k, members, seed=num_bits + k)
    host = bf.might_contain(queries)
    assert np.array_equal(host, jbf.might_contain(queries))
    assert host[:members].all()  # no false negatives
    port = probe_bloom_filter(bf, queries, engine="ref")
    assert port.dtype == np.bool_ and np.array_equal(port, host)
    # the cuda wrapper on the CPU takes the plain version
    on_cpu = probe_bloom_filter(bf, queries, engine="cuda",
                                device=torch.device("cpu"))
    assert np.array_equal(on_cpu, host)
    for eng in ("ref", "pallas"):
        assert np.array_equal(np.asarray(jx_probe(jbf, queries, engine=eng)),
                              host), eng


def test_bloom_probe_ref_equals_wrapper_on_tensors():
    bf, _, queries = _filters(2048, 5, 300, seed=9)
    h = hash_values(queries)
    h1 = _t((h & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    h2 = _t((h >> np.uint64(32)).astype(np.uint32))
    bits = _t(bf.bits.view(np.uint32))
    exp = bloom_probe_ref(h1, h2, bits, 5, 2048)
    assert torch.equal(bloom_probe_cuda(h1, h2, bits, 5, 2048), exp)
    assert torch.equal(bloom_probe(h1, h2, bits, 5, 2048, engine="ref"), exp)
    # int32 views of the same words give the same answer
    assert torch.equal(bloom_probe_ref(h1.view(torch.int32),
                                       h2.view(torch.int32),
                                       bits.view(torch.int32), 5, 2048), exp)


def test_bloom_probe_strings_and_floats():
    for values in (np.array([f"k{i}" for i in range(300)]),
                   np.linspace(-5, 5, 300)):
        bf = BloomFilter.for_expected(100)
        bf.add(values[:100])
        assert np.array_equal(probe_bloom_filter(bf, values, engine="ref"),
                              bf.might_contain(values))


def test_bloom_probe_empty_and_bad_shapes():
    bf = BloomFilter.for_expected(10)
    out = probe_bloom_filter(bf, np.zeros(0, np.int64), engine="ref")
    assert out.shape == (0,) and out.dtype == np.bool_
    z = _t(np.zeros(4, np.uint32))
    with pytest.raises(ValueError, match="power of two"):
        bloom_probe_cuda(z, z, _t(np.zeros(3, np.uint32)), 6, 96)
    with pytest.raises(ValueError, match="num_bits/32"):
        bloom_probe_cuda(z, z, _t(np.zeros(3, np.uint32)), 6, 64)


@settings(max_examples=20, deadline=None)
@given(n=st.integers(1, 2000), k=st.integers(1, 500))
def test_property_bloom_bridge_matches_host(n, k):
    rng = np.random.default_rng(n * 1000 + k)
    members = rng.integers(0, 1_000_000, k)
    bf = BloomFilter.for_expected(k)
    bf.add(members)
    jbf = JxBloomFilter.for_expected(k)
    jbf.add(members)
    queries = np.concatenate([members, rng.integers(0, 1_000_000, n)])
    got = probe_bloom_filter(bf, queries, engine="ref")
    assert (got == bf.might_contain(queries)).all()
    assert (got == jbf.might_contain(queries)).all()
    assert got[:k].all()


# ---------------------------------------------------------------------------
# registry and devices
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["hash_partition", "bloom_probe"])
def test_new_kernels_registered(name):
    assert registry.backends(name) == ("cuda", "ref")
    cuda = registry.resolve(name, "cuda")
    assert registry.resolve(name, "pallas") is cuda
    assert registry.resolve(name, "ref") is not cuda


def test_new_wrappers_never_launch_on_cpu():
    before = registry.launch_counts()
    x = _t(np.ones(8, np.float32))
    hash_partition_cuda([x] * 9, 4)  # K > 8 only matters on the card
    u = _t(np.ones(8, np.uint32))
    bloom_probe_cuda(u, u, _t(np.ones(2, np.uint32)), 12, 64)
    assert registry.launch_counts() == before


def test_cuda_engine_without_gpu_raises():
    batch = VectorBatch({"a": np.arange(10)})
    bf = BloomFilter.for_expected(4)
    if registry.on_gpu():
        assert partition_codes(batch, ["a"], 4, engine="cuda").shape == (10,)
        return
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        partition_codes(batch, ["a"], 4, engine="cuda")
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        probe_bloom_filter(bf, np.arange(10), engine="cuda")
