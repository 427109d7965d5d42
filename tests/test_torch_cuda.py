"""The port's CUDA kernels on the card against their plain torch versions.

Imports no JAX, so it runs on a GPU machine without it:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Every test skips without a GPU of compute capability >= 9.0.  Tolerances
of the SQL kernels:
filter_eval, key_lookup, hash_partition, bloom_probe, counts, integer-valued
sums and MIN/MAX are exact;
sums of random floats agree at atol 1e-3, because the kernels add in
another order, on some paths with atomics in an order that changes from
run to run; hash_group's morsel path up to 1,800 groups adds in a fixed
order, and equals its emulation (kernels/hash_group/order.py) bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.bloomfilter import BloomFilter, hash_values
from repro_torch.core.runtime.shuffle import partition_codes
from repro_torch.core.runtime.vector import VectorBatch
from repro_torch.kernels import registry
from repro_torch.kernels.bloom.ops import bloom_probe_cuda, probe_bloom_filter
from repro_torch.kernels.bloom.ref import bloom_probe_ref
from repro_torch.kernels.filter_eval.ops import filter_eval_cuda
from repro_torch.kernels.filter_eval.ref import filter_eval_ref
from repro_torch.kernels.hash_group.ops import (hash_group_cuda,
                                                hash_group_minmax_cuda)
from repro_torch.kernels.hash_group.ref import (hash_group_minmax_ref,
                                                hash_group_ref)
from repro_torch.kernels.hash_partition.ops import hash_partition_cuda
from repro_torch.kernels.hash_partition.ref import hash_partition_ref
from repro_torch.kernels.key_lookup.ops import key_lookup_cuda
from repro_torch.kernels.key_lookup.ref import key_lookup_ref

FILTER_CASES = [(100, 1), (1024, 2), (5000, 3), (8192, 2)]
GROUP_CASES = [(100, 5), (4096, 128), (10_000, 37), (2048, 1000)]


def _filter_inputs(n, ncols, dtype):
    rng = np.random.default_rng(n)
    cols = [rng.uniform(0, 100, n).astype(dtype) for _ in range(ncols)]
    ops = tuple((i % 6) for i in range(ncols))
    lits = tuple(float(rng.uniform(20, 80)) for _ in range(ncols))
    return cols, ops, lits


def _t(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _np(t):
    return t.cpu().numpy()


@pytest.fixture()
def cuda():
    if not registry.on_gpu():
        pytest.skip("needs an NVIDIA GPU of compute capability >= 9.0")
    return torch.device("cuda")


@pytest.mark.parametrize("n,ncols", FILTER_CASES + [(0, 1), (3_000_000, 8)])
def test_cuda_filter_eval_bit_exact(cuda, n, ncols):
    cols, ops, lits = _filter_inputs(n, ncols, np.float32)
    got = filter_eval_cuda([_t(c, cuda) for c in cols], ops, lits)
    exp = filter_eval_ref([_t(c) for c in cols], ops, lits)
    assert torch.equal(got.cpu(), exp)


# the path's shapes (1,024-row morsels, 8,192-row stripes) and 4M rows;
# either side of the four-rows-a-thread threshold (135,168) with ragged
# tails; the largest staged dictionary (12,288 keys) and the first one
# searched in place
@pytest.mark.parametrize("g,n", [(200, 1024), (2556, 1024), (1, 5),
                                 (20_000, 100_000), (2556, 3_000_000),
                                 (2556, 8192), (2556, 4_000_000),
                                 (2556, 135_167), (2556, 135_171),
                                 (3, 1), (12_288, 1024), (12_289, 1024),
                                 (12_289, 300_001)])
def test_cuda_key_lookup_exact(cuda, g, n):
    rng = np.random.default_rng(g)
    uniq = np.unique(rng.integers(0, 3 * g + 1, g)).astype(np.float32)
    probe = rng.integers(-50, 3 * g + 50, n).astype(np.float32)
    got = key_lookup_cuda(_t(uniq, cuda), _t(probe, cuda))
    assert torch.equal(got.cpu(), key_lookup_ref(_t(uniq), _t(probe)))


@pytest.mark.parametrize("n,g", GROUP_CASES + [(1024, 6144), (50_000, 7000),
                                               (3_000_000, 3000)])
def test_cuda_hash_group(cuda, n, g):
    rng = np.random.default_rng(g)
    codes = rng.integers(-1, g, n).astype(np.int32)
    vals = rng.normal(size=n).astype(np.float32)
    ints = rng.integers(-3, 4, n).astype(np.float32)
    s, c = hash_group_cuda(_t(codes, cuda), _t(vals, cuda), g)
    es, ec = hash_group_ref(_t(codes), _t(vals), g)
    np.testing.assert_allclose(_np(s), _np(es), atol=1e-3)
    assert torch.equal(c.cpu(), ec)
    si, _ = hash_group_cuda(_t(codes, cuda), _t(ints, cuda), g)
    assert torch.equal(si.cpu(), hash_group_ref(_t(codes), _t(ints), g)[0])
    m, x = hash_group_minmax_cuda(_t(codes, cuda), _t(vals, cuda), g)
    em, ex = hash_group_minmax_ref(_t(codes), _t(vals), g)
    assert torch.equal(m.cpu(), em) and torch.equal(x.cpu(), ex)


def test_cuda_launches_are_counted(cuda):
    before = registry.launch_counts().get("key_lookup", 0)
    key_lookup_cuda(_t(np.ones(3, np.float32), cuda),
                    _t(np.ones(8, np.float32), cuda))
    key_lookup_cuda(_t(np.ones(3, np.float32), cuda),
                    _t(np.ones(0, np.float32), cuda))  # empty: no launch
    assert registry.launch_counts()["key_lookup"] == before + 1


def test_cuda_filter_rejects_too_many_columns(cuda):
    cols = [_t(np.ones(4, np.float32), cuda) for _ in range(9)]
    with pytest.raises(ValueError, match="at most 8"):
        filter_eval_cuda(cols, (0,) * 9, (1.0,) * 9)


@pytest.mark.parametrize("n,k", [(1, 1), (1024, 1), (8192, 3), (5000, 8),
                                 (3_000_000, 2)])
@pytest.mark.parametrize("p", [1, 4, 7, 8])
def test_cuda_hash_partition_bit_exact(cuda, n, k, p):
    """Equal to the plain version and to the numpy host path, with -0.0
    and NaN (NULL) keys among the rows."""
    rng = np.random.default_rng(n + k)
    keys = [rng.normal(size=n).astype(np.float32) * 100 for _ in range(k)]
    for c in keys:
        for v in (-0.0, 0.0, np.nan, -np.float32(np.nan)):
            c[rng.integers(0, n, max(1, n // 32))] = v
    got = hash_partition_cuda([_t(c, cuda) for c in keys], p)
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), hash_partition_ref([_t(c) for c in keys], p))
    batch = VectorBatch({f"k{i}": c for i, c in enumerate(keys)})
    host = partition_codes(batch, list(batch.cols), p, engine="auto")
    assert np.array_equal(_np(got).astype(np.int64), host)


def test_cuda_hash_partition_rejects_bad_input(cuda):
    x = _t(np.ones(4, np.float32), cuda)
    with pytest.raises(ValueError, match="at most 8"):
        hash_partition_cuda([x] * 9, 4)
    with pytest.raises(ValueError, match="float32"):
        hash_partition_cuda([_t(np.ones(4), cuda)], 4)


@pytest.mark.parametrize("num_bits,k,n", [(64, 6, 8192), (512, 6, 8192),
                                          (32768, 6, 8192), (1 << 20, 6, 8192),
                                          (4096, 1, 1000), (4096, 8, 1000),
                                          (32768, 6, 3_000_000),
                                          (512, 6, 4_000_000),
                                          (32768, 6, 4_000_000),
                                          (64, 6, 135_171), (64, 3, 7),
                                          (1 << 20, 6, 300_001)])
def test_cuda_bloom_probe_exact(cuda, num_bits, k, n):
    """Equal to the plain version and BloomFilter.might_contain; 2**20 bits
    and calls of 135,168 rows or more read the bitset in place, the rest
    stage it (64 bits: no whole 16-byte unit for the bulk copy)."""
    rng = np.random.default_rng(num_bits + k)
    bf = BloomFilter(num_bits, k)
    bf.add(rng.integers(0, 40_000, max(5, num_bits // 10)))
    queries = rng.integers(0, 40_000, n)
    h = hash_values(queries)
    h1 = _t((h & np.uint64(0xFFFFFFFF)).astype(np.uint32), cuda)
    h2 = _t((h >> np.uint64(32)).astype(np.uint32), cuda)
    bits = _t(bf.bits.view(np.uint32), cuda)
    got = bloom_probe_cuda(h1, h2, bits, k, num_bits)
    assert torch.equal(got.cpu(), bloom_probe_ref(h1.cpu(), h2.cpu(),
                                                  bits.cpu(), k, num_bits))
    assert np.array_equal(_np(got), bf.might_contain(queries))
    assert np.array_equal(
        probe_bloom_filter(bf, queries, engine="cuda"),
        bf.might_contain(queries))


@pytest.mark.parametrize("g,n", [(2556, 1024), (2556, 200_001)])
def test_cuda_key_lookup_unaligned_views(cuda, g, n):
    """Views that start 4 bytes into their storage: the dictionary is
    copied to an aligned buffer for the bulk copy, the probe and output
    take the one-row-a-thread loads."""
    rng = np.random.default_rng(n)
    uniq = np.arange(g + 1, dtype=np.float32) * 3
    probe = rng.integers(-5, 3 * g + 5, n + 1).astype(np.float32)
    d, p = _t(uniq, cuda)[1:], _t(probe, cuda)[1:]
    assert d.data_ptr() % 16 and p.data_ptr() % 16
    got = key_lookup_cuda(d, p)
    assert torch.equal(got.cpu(), key_lookup_ref(_t(uniq)[1:], _t(probe)[1:]))


def test_cuda_bloom_probe_unaligned_views(cuda):
    rng = np.random.default_rng(5)
    bf = BloomFilter(4096, 6)
    bf.add(rng.integers(0, 9000, 400))
    queries = rng.integers(0, 9000, 200_001)
    h = hash_values(queries)
    lo = (h & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (h >> np.uint64(32)).astype(np.uint32)
    words = bf.bits.view(np.uint32)
    pad = np.zeros(1, np.uint32)
    h1, h2, bits = (_t(np.concatenate([pad, a]), cuda)[1:]
                    for a in (lo, hi, words))
    got = bloom_probe_cuda(h1, h2, bits, 6, 4096)
    assert np.array_equal(_np(got), bf.might_contain(queries))


def _path_calls(rng, device, morsels):
    """key_lookup, bloom_probe, hash_group and filter_eval as the executor
    calls them (numpy morsels; the dictionary and bitset made once by
    registry.upload), each with its plain version's answers."""
    uniq = np.arange(0, 2556 * 3, 3, dtype=np.float32)
    bf = BloomFilter(32768, 6)
    bf.add(rng.integers(0, 20_000, 3000))
    dictionary = registry.upload(uniq, device, "key_lookup")
    bits = registry.upload(bf.bits.view(np.uint32), device, "bloom_probe")
    calls = []
    for i in range(morsels):
        n = int(rng.integers(1, 8193))
        probe = rng.integers(-10, 2556 * 3 + 10, n).astype(np.float32)
        calls.append(("key_lookup", (dictionary, probe),
                      _np(key_lookup_ref(_t(uniq), _t(probe)))))
        h = hash_values(rng.integers(0, 20_000, n))
        h1 = (h & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        h2 = (h >> np.uint64(32)).astype(np.uint32)
        calls.append(("bloom_probe", (h1, h2, bits, 6, 32768),
                      _np(bloom_probe_ref(_t(h1), _t(h2),
                                          _t(bf.bits.view(np.uint32)), 6,
                                          32768))))
        codes = rng.integers(-1, 7, n).astype(np.int32)
        vals = rng.integers(1, 50, n).astype(np.float32)
        calls.append(("hash_group", (codes, vals, 7),
                      tuple(_np(t) for t in hash_group_ref(
                          _t(codes), _t(vals), 7))))
        col = rng.integers(0, 100, n).astype(np.float32)
        calls.append(("filter_eval", ((col,), (i % 6,), (50.0,)),
                      _np(filter_eval_ref([_t(col)], (i % 6,), (50.0,)))))
    return calls


def _same(got, exp):
    if isinstance(exp, tuple):
        return all(_same(g, e) for g, e in zip(got, exp))
    return got.dtype == exp.dtype and np.array_equal(got, exp)


def test_cuda_host_call_four_threads_equal_plain(cuda):
    """Four threads, each with its own stream and staging buffers, make
    many calls of morsels of random length at once; every answer equals
    the plain version's (float sums of integers: exact)."""
    from concurrent.futures import ThreadPoolExecutor

    fns = {k: registry.host_call(registry.resolve(k, "cuda"), cuda)
           for k in ("key_lookup", "bloom_probe", "hash_group",
                     "filter_eval")}
    work = [_path_calls(np.random.default_rng(t), cuda, 25)
            for t in range(4)]

    def run(calls):
        return [(k, fns[k](*args), exp) for k, args, exp in calls]

    with ThreadPoolExecutor(4) as pool:
        done = list(pool.map(run, work))
    for results in done:
        for k, got, exp in results:
            assert _same(got, exp), k


def test_cuda_kernel_spans_carry_the_launch_shape(cuda):
    """Untraced, host_call's call is the plain one; on a thread working for
    a traced query each call is a kernel:<name> span with the morsel's rows
    and the launch's shape under the cost model's keys, answers unchanged;
    hash_partition's too, as the shuffle calls it."""
    from repro_torch.core.obs.trace import (QueryTrace, bind_trace,
                                            restore_trace)
    from repro_torch.kernels.hash_partition.ops import hash_partition_ref

    keys = {"key_lookup": {"n", "g"}, "bloom_probe": {"n", "words", "hashes"},
            "hash_group": {"n", "g"}, "filter_eval": {"n", "k"},
            "hash_partition": {"n", "k"}}
    calls = _path_calls(np.random.default_rng(5), cuda, 3)
    col = np.random.default_rng(6).integers(0, 1000, 3000).astype(np.float32)
    calls.append(("hash_partition", ((col,), 4),
                  _np(hash_partition_ref([_t(col)], 4))))
    plain = registry.host_call(registry.resolve("key_lookup", "cuda"), cuda)
    assert plain.__name__ == "on_card" and not hasattr(plain, "__wrapped__")
    trace = QueryTrace("q1")
    prev = bind_trace(trace)
    try:
        for k, args, exp in calls:
            fn = registry.host_call(registry.resolve(k, "cuda"), cuda)
            assert _same(fn(*args), exp), k
    finally:
        restore_trace(prev)
    spans = [(name, args) for name, _c, _b, _e, _t, args in trace._spans]
    assert [name for name, _a in spans] == [f"kernel:{k}"
                                            for k, _a, _e in calls]
    for (name, args), (k, call_args, _e) in zip(spans, calls):
        assert set(args) == keys[k] | {"rows", "cpu_ms"}, name
        assert args["n"] == args["rows"] > 0
    assert spans[0][1]["g"] == 2556
    assert (spans[1][1]["words"], spans[1][1]["hashes"]) == (1024, 6)


def test_cuda_host_call_results_are_not_the_staging_buffer(cuda):
    """A result stays as it was after the same thread's next call, which
    reuses the staging buffers."""
    rng = np.random.default_rng(3)
    dictionary = registry.upload(np.arange(100, dtype=np.float32), cuda,
                                 "key_lookup")
    call = registry.host_call(registry.resolve("key_lookup", "cuda"), cuda)
    first = call(dictionary, np.arange(50, dtype=np.float32))
    kept = first.copy()
    second = call(dictionary, rng.integers(200, 300, 50).astype(np.float32))
    assert np.array_equal(first, kept) and (second == -1).all()
    assert not np.shares_memory(first, second)


def test_cuda_state_uploaded_on_one_thread_probed_on_another(cuda):
    """The dictionary and bitset uploaded by one thread (on its stream) are
    complete for the calls of threads that did not make them."""
    import threading

    rng = np.random.default_rng(11)
    uniq = np.unique(rng.integers(0, 100_000, 2556)).astype(np.float32)
    bf = BloomFilter(32768, 6)
    bf.add(rng.integers(0, 50_000, 4000))
    made = {}

    def build():
        with torch.cuda.stream(torch.cuda.Stream()):
            made["dict"] = registry.upload(uniq, cuda, "key_lookup")
            made["bits"] = registry.upload(bf.bits.view(np.uint32), cuda,
                                           "bloom_probe")

    t = threading.Thread(target=build)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    probe = rng.integers(0, 100_000, 8192).astype(np.float32)
    queries = rng.integers(0, 50_000, 8192)
    lookup = registry.host_call(registry.resolve("key_lookup", "cuda"), cuda)
    got = {}

    def use():
        got["codes"] = lookup(made["dict"], probe)
        got["mask"] = probe_bloom_filter(bf, queries, "cuda", cuda,
                                         bits=made["bits"])

    t = threading.Thread(target=use)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert np.array_equal(got["codes"],
                          _np(key_lookup_ref(_t(uniq), _t(probe))))
    assert np.array_equal(got["mask"], bf.might_contain(queries))


def test_cuda_new_kernels_count_launches(cuda):
    before = registry.launch_counts()
    bf = BloomFilter.for_expected(100)
    probe_bloom_filter(bf, np.arange(50), engine="cuda")
    partition_codes(VectorBatch({"a": np.arange(50)}), ["a"], 4,
                    engine="cuda")
    after = registry.launch_counts()
    for name in ("bloom_probe", "hash_partition"):
        assert after.get(name, 0) == before.get(name, 0) + 1, name


# ---------------------------------------------------------------------------
# LM side: ssd_scan and flash_attention.  Tolerances: ssd_scan atol 5e-5
# and rtol 1e-3, the JAX kernel's own (float32 sums in another order);
# flash_attention atol 3e-5 in float32, as the JAX package's sweep states
# it; in bfloat16 both versions sum in float32 and round once, so they
# differ by at most one bfloat16 step (2^-7 of |exp|) beside float32 noise
# (atol 1e-4), and never by more than the JAX sweep's 3e-2.
# ---------------------------------------------------------------------------
SSD_CASES = [(1, 32, 2, 8, 4, 8), (2, 64, 3, 16, 8, 16),
             (1, 128, 4, 32, 16, 32), (2, 96, 2, 8, 8, 48)]
FLASH_SHAPES = [(1, 1, 64, 16), (2, 3, 128, 32), (2, 2, 256, 64),
                (1, 4, 96, 8)]


def ssd_inputs(B, S, H, P, N, seed=None, decay=0.2):
    """The JAX package's sweep inputs: x * 0.1, dA = -|n| * decay, B and C
    * 0.3, from numpy's generator seeded with S (or ``seed``)."""
    rng = np.random.default_rng(S if seed is None else seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32) * 0.1
    dA = -np.abs(rng.normal(size=(B, S, H)).astype(np.float32)) * decay
    Bm = rng.normal(size=(B, S, N)).astype(np.float32) * 0.3
    Cm = rng.normal(size=(B, S, N)).astype(np.float32) * 0.3
    return x, dA, Bm, Cm


def flash_inputs(shape, dtype):
    rng = np.random.default_rng(shape[2])
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
            for _ in range(3)]


@pytest.mark.parametrize("cfg", SSD_CASES + [(2, 1024, 24, 64, 128, 256),
                                             (1, 512, 4, 64, 64, 256)])
def test_cuda_ssd_scan(cuda, cfg):
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    B, S, H, P, N, Q = cfg
    arrs = ssd_inputs(B, S, H, P, N)
    got, _ = ssd_scan_cuda(*[_t(a, cuda) for a in arrs], chunk=Q)
    exp = ssd_scan_ref(*[_t(a) for a in arrs], chunk=Q)
    assert got.dtype == torch.float32 and got.shape == (B, S, H, P)
    np.testing.assert_allclose(_np(got), _np(exp), atol=5e-5, rtol=1e-3)


def test_cuda_ssd_scan_chunk_invariance_and_strong_decay(cuda):
    """Chunk 64 and 256 agree; mamba2-130m's decays (dA near -6 a step, so
    cum near -1500 in a chunk) stay finite: L is never factored."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    arrs = [_t(a, cuda) for a in ssd_inputs(2, 512, 3, 64, 128, seed=7,
                                            decay=6.0)]
    y64, _ = ssd_scan_cuda(*arrs, chunk=64)
    y256, _ = ssd_scan_cuda(*arrs, chunk=256)
    assert torch.isfinite(y256).all()
    np.testing.assert_allclose(_np(y64), _np(y256), atol=5e-5, rtol=1e-3)
    exp = ssd_scan_ref(*[a.cpu() for a in arrs], chunk=256)
    np.testing.assert_allclose(_np(y256), _np(exp), atol=5e-5, rtol=1e-3)


def test_cuda_ssd_scan_bf16_inputs(cuda):
    """bfloat16 inputs are read as they are and computed in float32."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    arrs = [_t(a).to(torch.bfloat16) for a in ssd_inputs(2, 128, 2, 64, 32)]
    got, _ = ssd_scan_cuda(*[a.to(cuda) for a in arrs], chunk=64)
    exp = ssd_scan_ref(*arrs, chunk=64)
    np.testing.assert_allclose(_np(got), _np(exp), atol=5e-5, rtol=1e-3)


def test_cuda_ssd_scan_rejects_mixed_dtypes(cuda):
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_cuda

    x, dA, Bm, Cm = (_t(a, cuda) for a in ssd_inputs(1, 32, 2, 8, 4))
    with pytest.raises(ValueError, match="one dtype"):
        ssd_scan_cuda(x, dA, Bm.to(torch.bfloat16), Cm, chunk=8)
    with pytest.raises(ValueError, match="one dtype"):
        ssd_scan_cuda(*(a.half() for a in (x, dA, Bm, Cm)), chunk=8)


@pytest.mark.parametrize("shape", FLASH_SHAPES + [(1, 2, 256, 128),
                                                  (1, 2, 192, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention(cuda, shape, dtype, causal):
    from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref

    q, k, v = flash_inputs(shape, dtype)
    bq = 32 if shape[2] % 32 == 0 else shape[2]
    got = flash_attention_cuda(q.to(cuda), k.to(cuda), v.to(cuda),
                               causal=causal, block_q=bq, block_k=bq)
    exp = attention_ref(q, k, v, causal=causal)
    assert got.dtype == dtype
    if dtype == torch.float32:
        atol, rtol = 3e-5, 0.0
    else:
        atol, rtol = 1e-4, 2 ** -7
    np.testing.assert_allclose(_np(got.float()), _np(exp.float()), atol=atol,
                               rtol=rtol)
    assert float((got.float().cpu() - exp.float()).abs().max()) <= 3e-2


def test_cuda_lm_kernels_count_launches(cuda):
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    before = registry.launch_counts()
    ssd_scan(*[_t(a, cuda) for a in ssd_inputs(1, 32, 2, 8, 4)], chunk=8)
    q, k, v = (t.to(cuda) for t in flash_inputs((1, 1, 64, 16),
                                                 torch.float32))
    flash_attention(q, k, v)
    after = registry.launch_counts()
    for name in ("ssd_scan", "flash_attention"):
        assert after.get(name, 0) == before.get(name, 0) + 1, name


def test_cuda_mamba2_prefill_and_decode(cuda):
    """Reduced mamba2-130m on the card: the kernel prefill matches the
    plain scan's, and decoding token by token matches the prefill's last
    logits (atol/rtol 0.15, the JAX package's decode-vs-forward bound)."""
    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.models import model as M

    cfg = reduced_config(get_config("mamba2-130m"))
    gen = torch.Generator(device=cuda).manual_seed(0)
    model = M.init_params(cfg, gen, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen,
                           device=cuda)
    before = registry.launch_counts().get("ssd_scan", 0)
    with torch.inference_mode():
        with_kernel = M.forward(model, tokens)
        assert registry.launch_counts()["ssd_scan"] == \
            before + cfg.num_layers
        plain = M.forward(model, tokens, use_kernel=False)
    np.testing.assert_allclose(_np(with_kernel.float()), _np(plain.float()),
                               atol=2e-2)
    cache = M.init_cache(cfg, 2, 32, device=cuda)
    for t in range(32):
        logits, cache = M.decode_step(model, cache, tokens[:, t], t)
    np.testing.assert_allclose(_np(logits.float()),
                               _np(with_kernel[:, -1].float()),
                               atol=0.15, rtol=0.15)


# ---------------------------------------------------------------------------
# The flash_attention routes and the two hash_group_minmax paths.
# Tensor-core route (bfloat16, d a multiple of 16 up to 128; 48 and 96 pad
# to the kernel's 64- and 128-column tiles): against the plain version run
# on the card, at the bfloat16 tolerance above (atol 1e-4 + 2^-7 |exp|,
# never beyond 3e-2).  MIN/MAX: bit-exact, -0.0 below +0.0 (order keys).
# ---------------------------------------------------------------------------
WGMMA_DIMS = [16, 32, 48, 64, 96, 128]
WGMMA_LENGTHS = [64, 96, 128, 256, 4096]


@pytest.mark.parametrize("d", WGMMA_DIMS)
@pytest.mark.parametrize("S", WGMMA_LENGTHS)
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_wgmma(cuda, d, S, causal):
    from repro_torch.kernels.flash_attention.ops import (flash_attention_cuda,
                                                         route)
    from repro_torch.kernels.flash_attention.ref import attention_ref

    assert route(torch.bfloat16, d) == "wgmma"
    shape = (1, 2, S, d) if S == 4096 else (2, 3, S, d)
    q, k, v = (t.to(cuda) for t in flash_inputs(shape, torch.bfloat16))
    before = registry.launch_counts().get("flash_attention.wgmma", 0)
    got = flash_attention_cuda(q, k, v, causal=causal)
    assert registry.launch_counts()["flash_attention.wgmma"] == before + 1
    exp = attention_ref(q, k, v, causal=causal).float()
    assert got.dtype == torch.bfloat16 and got.shape == shape
    err = (got.float() - exp).abs()
    assert float(err.max()) <= 3e-2
    np.testing.assert_allclose(_np(got.float()), _np(exp), atol=1e-4,
                               rtol=2 ** -7)


def test_cuda_flash_attention_route_counters(cuda):
    from repro_torch.kernels.flash_attention.ops import flash_attention

    def run(dtype, d):
        q, k, v = (t.to(cuda) for t in flash_inputs((1, 2, 128, d), dtype))
        flash_attention(q, k, v)

    before = registry.launch_counts()
    run(torch.bfloat16, 64)
    run(torch.float32, 64)
    run(torch.bfloat16, 256)
    run(torch.bfloat16, 8)
    run(torch.float32, 256)
    after = registry.launch_counts()
    moved = {k: after.get(k, 0) - before.get(k, 0) for k in
             ("flash_attention", "flash_attention.wgmma",
              "flash_attention.tf32x3", "flash_attention.simt")}
    assert moved == {"flash_attention": 5, "flash_attention.wgmma": 1,
                     "flash_attention.tf32x3": 1, "flash_attention.simt": 3}


# The float32 route on the tensor cores (three TF32 terms, d a multiple of
# 8 up to 128; csrc/flash_attention_tf32.cu): the JAX sweep, d 8, 64 and
# 128 at S = 96 (no multiple of its 64- or 32-key tiles) and the path
# shape, both masks, against the plain version at the float32 atol 3e-5.
TF32_SHAPES = FLASH_SHAPES + [(2, 3, 96, 8), (2, 3, 96, 64), (2, 3, 96, 128),
                              (2, 3, 256, 128), (1, 2, 4096, 64)]


@pytest.mark.parametrize("shape", TF32_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_tf32x3(cuda, shape, causal):
    from repro_torch.kernels.flash_attention.ops import (flash_attention_cuda,
                                                         route)
    from repro_torch.kernels.flash_attention.ref import attention_ref

    assert route(torch.float32, shape[3]) == "tf32x3"
    q, k, v = (t.to(cuda) for t in flash_inputs(shape, torch.float32))
    before = registry.launch_counts()
    got = flash_attention_cuda(q, k, v, causal=causal, block_q=shape[2],
                               block_k=shape[2])
    after = registry.launch_counts()
    assert [after.get(k, 0) - before.get(k, 0) for k in
            ("flash_attention.tf32x3", "flash_attention.simt")] == [1, 0]
    exp = attention_ref(q, k, v, causal=causal)
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(_np(got), _np(exp), atol=3e-5, rtol=0.0)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64),
                                     (torch.bfloat16, 64),
                                     (torch.float32, 256)])
def test_cuda_flash_attention_unaligned_inputs(cuda, dtype, d):
    """Contiguous inputs that start off a 16-byte boundary (a view at an
    odd element offset) reach the kernels' 16-byte loads aligned."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref

    shape = (1, 2, 96, d)
    n = int(np.prod(shape))
    q, k, v = (torch.empty(n + 1, dtype=dtype, device=cuda)[1:].view(shape)
               .copy_(t) for t in flash_inputs(shape, dtype))
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    got = flash_attention_cuda(q, k, v)
    exp = attention_ref(q, k, v).float()
    if dtype == torch.float32:
        atol, rtol = 3e-5, 0.0
    else:
        atol, rtol = 1e-4, 2 ** -7
    np.testing.assert_allclose(_np(got.float()), _np(exp), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("d", [8, 64, 128])
def test_cuda_flash_attention_simt_keeps_float32(cuda, d):
    """The CUDA-core route, which chip_smoke times beside the tensor-core
    one, still computes float32 at d <= 128 when launched by hand."""
    from repro_torch.kernels.flash_attention.ops import launch_route
    from repro_torch.kernels.flash_attention.ref import attention_ref

    q, k, v = (t.to(cuda) for t in flash_inputs((2, 3, 96, d),
                                                 torch.float32))
    got = launch_route(q, k, v, True, "simt")
    np.testing.assert_allclose(_np(got), _np(attention_ref(q, k, v)),
                               atol=3e-5, rtol=0.0)


def _bits(t):
    return _np(t).view(np.int32)


@pytest.mark.parametrize("g", [1, 7, 640, 6144])
def test_cuda_minmax_one_launch_bit_exact(cuda, g):
    """At the SQL path's 1,024-row morsels: one launch, the plain version's
    bits, masked rows and +-inf among the values."""
    from repro_torch.kernels.hash_group.ops import minmax_path

    rng = np.random.default_rng(g + 1)
    codes = rng.integers(-1, g, 1024).astype(np.int32)
    vals = rng.normal(size=1024).astype(np.float32)
    vals[rng.integers(0, 1024, 8)] = np.inf
    vals[rng.integers(0, 1024, 8)] = -np.inf
    assert minmax_path(1024, g) == "one_block"
    before = registry.launch_counts()
    m, x = hash_group_minmax_cuda(_t(codes, cuda), _t(vals, cuda), g)
    after = registry.launch_counts()
    em, ex = hash_group_minmax_ref(_t(codes), _t(vals), g)
    assert np.array_equal(_bits(m), _bits(em))
    assert np.array_equal(_bits(x), _bits(ex))
    for name, step in (("hash_group_minmax", 1),
                       ("hash_group_minmax.one_block", 1),
                       ("hash_group_minmax.multi_block", 0)):
        assert after.get(name, 0) == before.get(name, 0) + step, name


@pytest.mark.parametrize("path", ["one_block", "multi_block"])
def test_cuda_minmax_signed_zero_and_empty_groups(cuda, path):
    """Group 0 holds -0.0 and +0.0 (min -0.0, max +0.0 whatever the order),
    group 1 nothing (+inf / -inf), group 2 only -inf, group 3 only +inf."""
    from repro_torch.kernels.hash_group.ops import _prepare, launch_minmax

    codes = np.array([0, 0, 0, 0, 2, 3, -1, -1], np.int32)
    vals = np.array([0.0, -0.0, 0.0, -0.0, -np.inf, np.inf, 5.0, -5.0],
                    np.float32)
    for order in (slice(None), slice(None, None, -1)):
        c, v = _prepare(_t(codes[order], cuda), _t(vals[order], cuda), 4)
        out = _np(launch_minmax(c, v, 4, path))
        want_min = np.array([-0.0, np.inf, -np.inf, np.inf], np.float32)
        want_max = np.array([0.0, -np.inf, -np.inf, np.inf], np.float32)
        assert np.array_equal(out[0].view(np.int32), want_min.view(np.int32))
        assert np.array_equal(out[1].view(np.int32), want_max.view(np.int32))


def test_cuda_minmax_paths_at_the_limit(cuda):
    from repro_torch.kernels.hash_group.ops import ONE_BLOCK_ROWS

    rng = np.random.default_rng(9)
    for n, path in ((ONE_BLOCK_ROWS, "one_block"),
                    (ONE_BLOCK_ROWS + 1, "multi_block")):
        codes = rng.integers(-1, 7, n).astype(np.int32)
        vals = rng.normal(size=n).astype(np.float32)
        key = f"hash_group_minmax.{path}"
        before = registry.launch_counts().get(key, 0)
        m, x = hash_group_minmax_cuda(_t(codes, cuda), _t(vals, cuda), 7)
        assert registry.launch_counts()[key] == before + 1
        em, ex = hash_group_minmax_ref(_t(codes), _t(vals), 7)
        assert np.array_equal(_bits(m), _bits(em))
        assert np.array_equal(_bits(x), _bits(ex))


# ---------------------------------------------------------------------------
# ssd_scan's four chunk-parallel passes (csrc/ssd_scan.cu).  Whole scans
# against the plain version at the tolerance above (atol 5e-5, rtol 1e-3);
# then each pass launched on its own through its C entry point, on the
# emulation's inputs for it (tests/test_torch_ssd_passes.py), against the
# emulation's output of it, so a failure names the pass.
# ---------------------------------------------------------------------------
SSD_KERNEL_CASES = {
    "zamba2-1.2b heads": ((1, 1024, 64, 64, 64, 256), 0.2, torch.float32),
    "chunk 1024": ((1, 2048, 4, 64, 128, 1024), 0.2, torch.float32),
    "one chunk": ((2, 256, 8, 64, 128, 256), 0.2, torch.float32),
    "three chunks": ((1, 768, 6, 64, 128, 256), 0.2, torch.float32),
    "decay 6 at path width": ((2, 1024, 24, 64, 128, 256), 6.0,
                              torch.float32),
    "bf16 at path width": ((2, 1024, 24, 64, 128, 256), 0.2, torch.bfloat16),
}


@pytest.mark.parametrize("name", list(SSD_KERNEL_CASES))
def test_cuda_ssd_scan_shapes(cuda, name):
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    (B, S, H, P, N, Q), decay, dtype = SSD_KERNEL_CASES[name]
    arrs = [_t(a).to(dtype) for a in ssd_inputs(B, S, H, P, N, seed=11,
                                                decay=decay)]
    before = registry.launch_counts().get("ssd_scan", 0)
    got, _ = ssd_scan_cuda(*[a.to(cuda) for a in arrs], chunk=Q)
    assert registry.launch_counts()["ssd_scan"] == before + 1
    exp = ssd_scan_ref(*arrs, chunk=Q)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    np.testing.assert_allclose(_np(got), _np(exp), atol=5e-5, rtol=1e-3)


@pytest.mark.parametrize("cfg,decay", [((1, 768, 3, 64, 128, 256), 6.0),
                                       ((2, 1024, 24, 64, 128, 256), 0.2),
                                       ((1, 512, 2, 64, 64, 256), 0.2),
                                       ((2, 96, 2, 8, 8, 48), 0.2),
                                       ((1, 32, 2, 8, 4, 8), 0.2)])
def test_cuda_ssd_passes_one_by_one(cuda, cfg, decay):
    from repro_torch.kernels.ssd_scan.ops import buffers, launch_pass
    from test_torch_ssd_passes import causal_tiles, emulate_passes

    B, S, H, P, N, Q = cfg
    cpu = [_t(a) for a in ssd_inputs(B, S, H, P, N, seed=5, decay=decay)]
    x, dA, Bm, Cm = (a.to(cuda) for a in cpu)
    emu = emulate_passes(*cpu, Q)
    bufs = buffers(x, Bm, Q)

    def check(name, got, exp):
        torch.cuda.synchronize()
        err = float((got.cpu() - exp).abs().max())
        assert torch.allclose(got.cpu(), exp, atol=5e-5, rtol=1e-3), \
            f"pass {name}: max error {err}"

    launch_pass("chunk_state", x, dA, Bm, Cm, bufs, Q)
    check("chunk_state (cum)", bufs["cum"], emu["cum"])
    check("chunk_state (states)", bufs["states"], emu["states"])
    bufs["cum"].copy_(emu["cum"])
    bufs["states"].copy_(emu["states"])
    launch_pass("state_pass", x, dA, Bm, Cm, bufs, Q)
    check("state_pass", bufs["states"], emu["prev"])
    launch_pass("bmm", x, dA, Bm, Cm, bufs, Q)
    mask = causal_tiles(Q)
    check("bmm", bufs["cb"].cpu()[..., mask], emu["cb"][..., mask])
    bufs["states"].copy_(emu["prev"])
    bufs["cb"].copy_(emu["cb"])
    bufs["y"].fill_(float("nan"))
    launch_pass("chunk_scan", x, dA, Bm, Cm, bufs, Q)
    check("chunk_scan", bufs["y"], emu["y"])


def test_cuda_ssd_scan_one_count_per_call(cuda):
    """Four launches, one count: the prefill's 24 counts are one call per
    layer; each pass counts its own launches."""
    from repro_torch.kernels.ssd_scan.ops import PASSES, ssd_scan

    arrs = [_t(a, cuda) for a in ssd_inputs(1, 512, 4, 64, 128, seed=2)]
    keys = ["ssd_scan"] + [f"ssd_scan.{p}" for p in PASSES]
    before = registry.launch_counts()
    for _ in range(3):
        ssd_scan(*arrs, chunk=256)
    after = registry.launch_counts()
    assert {k: after[k] - before.get(k, 0) for k in keys} == \
        dict.fromkeys(keys, 3)


def test_cuda_ssd_scan_odd_widths(cuda):
    """Widths off the 16-byte copies (P 5, N 7) and a chunk off the 64-row
    tiles (Q 40) take the element-wise loads; bf16 with N 12 too."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    for (B, S, H, P, N, Q), dtype in (((2, 120, 3, 5, 7, 40), torch.float32),
                                      ((1, 200, 2, 20, 12, 100),
                                       torch.bfloat16)):
        arrs = [_t(a).to(dtype) for a in ssd_inputs(B, S, H, P, N, seed=4)]
        got, _ = ssd_scan_cuda(*[a.to(cuda) for a in arrs], chunk=Q)
        exp = ssd_scan_ref(*arrs, chunk=Q)
        np.testing.assert_allclose(_np(got), _np(exp), atol=5e-5, rtol=1e-3)


# ---------------------------------------------------------------------------
# hash_group's three paths (one launch each) and filter_eval's row split
# ---------------------------------------------------------------------------
def _kernels_launched(fn) -> int:
    """The kernels ``fn`` launches: the kernel nodes of a CUDA graph
    captured around it (torch.profiler lost some of these short kernels'
    records in runs on the card).  ``fn`` runs once before, outside the
    capture."""
    import ctypes

    from repro_torch.kernels import _build

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    count = ctypes.c_int64()
    _build.check(_build.library().repro_graph_kernel_nodes(
        graph.raw_cuda_graph(), ctypes.byref(count)), "graph nodes")
    return count.value


def _group_inputs(n, g, seed):
    """Codes from -1 to g + 2; normal values; integers of |v| <= 3, so up
    to 4M rows every partial sum is an integer below 2^24 and exact in
    float32 in any order."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(-1, g + 3, n).astype(np.int32)
    vals = rng.normal(size=n).astype(np.float32)
    ints = rng.integers(-3, 4, n).astype(np.float32)
    return codes, vals, ints


def _float64_sums(codes, vals, g):
    """The grouped sums in float64 (a float32 sum in sequence drifts by
    more than 1e-3 over hundreds of thousands of rows a group)."""
    keep = (codes >= 0) & (codes < g)
    return np.bincount(codes[keep], weights=vals[keep].astype(np.float64),
                       minlength=g)


@pytest.mark.parametrize("n", [1, 31, 1024, "morsel_rows"])
@pytest.mark.parametrize("g", [1, 7, 8, 9, 31, 32, 33, 900, 1800])
def test_cuda_hash_group_morsel_equals_its_order(cuda, n, g):
    """The morsel path's sums equal the CPU emulation of its order bit for
    bit (registers up to 32 groups, a copy per warp up to 1,800)."""
    from repro_torch.kernels.hash_group.ops import group_path, morsel_rows
    from repro_torch.kernels.hash_group.order import morsel_order

    n = morsel_rows(g) if n == "morsel_rows" else n
    assert group_path(n, g) == "morsel"
    codes, vals, _ = _group_inputs(n, g, seed=n + g)
    s, c = hash_group_cuda(_t(codes, cuda), _t(vals, cuda), g)
    es, ec = morsel_order(_t(codes), _t(vals), g)
    assert np.array_equal(_bits(s), _bits(es))
    assert torch.equal(c.cpu(), ec)


def test_cuda_hash_group_limits_are_the_kernels(cuda):
    """The wrapper's copy of the kernel's limits (path codes, block,
    group limits, shared memory, blocks a SM) equals the built kernel's."""
    from repro_torch.kernels.hash_group.ops import kernel_limits, limits

    assert limits() == kernel_limits()


def test_cuda_hash_group_repeats_at_the_path_shape(cuda):
    """G 7, n 1,024: the same bits in 100 calls, the emulation's, through
    the tensor wrapper and the executor's trip alike."""
    from repro_torch.kernels.hash_group.order import morsel_order

    codes, vals, _ = _group_inputs(1024, 7, seed=7)
    want = _bits(morsel_order(_t(codes), _t(vals), 7)[0])
    tc, tv = _t(codes, cuda), _t(vals, cuda)
    trip = registry.host_call(hash_group_cuda, cuda)
    for _ in range(100):
        assert np.array_equal(_bits(hash_group_cuda(tc, tv, 7)[0]), want)
        assert np.array_equal(trip(codes, vals, 7)[0].view(np.int32), want)


@pytest.mark.parametrize("n,g,path", [(1024, 7, "morsel"), (1024, 33, "morsel"),
                                      (1024, 6145, "grid"),
                                      ("morsel_rows+1", 7, "grid"),
                                      (200_000, 40, "grid"),
                                      (200_000, 3000, "grid"),
                                      (1024, "smem_groups+1", "global"),
                                      (200_000, "smem_groups+1", "global")])
def test_cuda_hash_group_one_launch_per_call(cuda, n, g, path):
    """One kernel on the card per call on every path (a captured graph's
    kernel nodes), and one count of the path's own."""
    from repro_torch.kernels.hash_group.ops import (SMEM_GROUPS, group_path,
                                                    morsel_rows)

    g = SMEM_GROUPS + 1 if g == "smem_groups+1" else g
    n = morsel_rows(g) + 1 if n == "morsel_rows+1" else n
    assert group_path(n, g) == path
    codes, vals, ints = _group_inputs(n, g, seed=n % 1000 + g)
    tc, tv = _t(codes, cuda), _t(vals, cuda)
    assert _kernels_launched(lambda: hash_group_cuda(tc, tv, g)) == 1
    before = registry.launch_counts()
    hash_group_cuda(tc, tv, g)
    after = registry.launch_counts()
    for key in ("hash_group", f"hash_group.{path}"):
        assert after.get(key, 0) == before.get(key, 0) + 1, key
    s, c = hash_group_cuda(tc, _t(ints, cuda), g)
    es, ec = hash_group_ref(_t(codes), _t(ints), g)
    assert torch.equal(s.cpu(), es) and torch.equal(c.cpu(), ec)


def test_cuda_hash_group_grid_from_four_threads(cuda):
    """Four threads, each on its own stream, make the executor's call on
    the grid path at once (cooperative launches from concurrent streams,
    each with its scratch in the thread's staging buffer): every answer is
    the plain version's (integer sums, exact)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.hash_group.ops import group_path

    call = registry.host_call(hash_group_cuda, cuda)
    work = []
    for t in range(4):
        calls = []
        for i in range(12):
            g = (7, 40, 3000)[i % 3]
            codes, _, ints = _group_inputs(20_000 + 97 * i, g, seed=t * 50 + i)
            assert group_path(codes.shape[0], g) == "grid"
            calls.append((codes, ints, g, tuple(
                _np(x) for x in hash_group_ref(_t(codes), _t(ints), g))))
        work.append(calls)

    def run(calls):
        return [(call(c, v, g), exp) for c, v, g, exp in calls]

    with ThreadPoolExecutor(4) as pool:
        done = list(pool.map(run, work, timeout=120))
    for results in done:
        for got, exp in results:
            assert all(np.array_equal(a, b) for a, b in zip(got, exp))


@pytest.mark.parametrize("n,g", [(1024, 32), (1024, 33), (1024, 6144),
                                 (1024, 6145), (1024, "warp_copy"),
                                 (1024, "warp_copy+1"), (1024, "smem"),
                                 (1024, "smem+1"), ("morsel_rows", 7),
                                 ("morsel_rows+1", 7), ("morsel_rows+1", 32),
                                 ("morsel_rows+1", 33), (100_003, "smem"),
                                 (100_003, "smem+1"), (4_000_000, 7),
                                 (4_000_000, 3000), (4_000_000, 8000)])
def test_cuda_hash_group_shape_boundaries(cuda, n, g):
    """Either side of each limit: counts and integer sums exact, float sums
    at atol 1e-3 of the float64 sums, on inputs whose arrays are and are
    not 16-byte aligned."""
    from repro_torch.kernels.hash_group.ops import (SMEM_GROUPS,
                                                    WARP_COPY_GROUPS,
                                                    morsel_rows)

    limits = {"warp_copy": WARP_COPY_GROUPS,
              "warp_copy+1": WARP_COPY_GROUPS + 1, "smem": SMEM_GROUPS,
              "smem+1": SMEM_GROUPS + 1}
    g = limits.get(g, g)
    n = {"morsel_rows": morsel_rows(g),
         "morsel_rows+1": morsel_rows(g) + 1}.get(n, n)
    codes, vals, ints = _group_inputs(n, g, seed=g)
    for offset in (0, 1):
        pc, pv, pi = (_t(np.concatenate([np.zeros(offset, a.dtype), a]),
                         cuda)[offset:] for a in (codes, vals, ints))
        s, c = hash_group_cuda(pc, pv, g)
        ec = hash_group_ref(_t(codes), _t(vals), g)[1]
        np.testing.assert_allclose(_np(s), _float64_sums(codes, vals, g),
                                   atol=1e-3, rtol=0)
        assert torch.equal(c.cpu(), ec)
        si, _ = hash_group_cuda(pc, pi, g)
        assert torch.equal(si.cpu(), hash_group_ref(_t(codes), _t(ints),
                                                    g)[0])


FILTER_OPS_K = [(k, tuple((k + i) % 6 for i in range(k))) for k in range(1, 9)]


@pytest.mark.parametrize("k,ops", FILTER_OPS_K)
@pytest.mark.parametrize("n", [1, 3, 4, 7, 1029, 100_003])
def test_cuda_filter_eval_unaligned_views(cuda, k, ops, n):
    """Columns at offsets 0-3 (all alike, and mixed), n not a multiple of 4,
    NaN and -0.0 in the columns: bit-exact against the plain version, one
    kernel a call."""
    rng = np.random.default_rng(k * 100 + n)
    bases = []
    for _ in range(k):
        a = rng.integers(-3, 4, n + 4).astype(np.float32)
        for v in (-0.0, 0.0, np.nan):
            a[rng.integers(0, n + 4, max(1, n // 8))] = v
        bases.append(a)
    lits = tuple([0.0, -0.0, 1.0, 2.0, -1.0, 0.0, 3.0, -2.0][:k])
    patterns = [(o,) * k for o in range(4)] + [tuple(i % 4 for i in range(k))]
    calls = []
    for offsets in patterns:
        cols = [_t(b, cuda)[o:o + n] for b, o in zip(bases, offsets)]
        exp = filter_eval_ref([_t(b)[o:o + n] for b, o in zip(bases, offsets)],
                              ops, lits)
        got = filter_eval_cuda(cols, ops, lits)
        assert got.shape == (n,) and torch.equal(got.cpu(), exp), offsets
        calls.append(lambda cols=cols: filter_eval_cuda(cols, ops, lits))
    assert _kernels_launched(lambda: [call() for call in calls]) == \
        len(calls)


# ---------------------------------------------------------------------------
# training on the card
# ---------------------------------------------------------------------------
def test_cuda_lm_kernels_refuse_autograd(cuda):
    """The LM kernels have no backward: their wrappers raise where autograd
    records, and run under no_grad."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_cuda

    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(1, 64, 2, 16, device=cuda, generator=g,
                    requires_grad=True)
    dA = -torch.rand(1, 64, 2, device=cuda, generator=g)
    Bm, Cm = (torch.randn(1, 64, 8, device=cuda, generator=g)
              for _ in range(2))
    with pytest.raises(RuntimeError, match="ssd_reference"):
        ssd_scan_cuda(x, dA, Bm, Cm, chunk=16)
    with torch.no_grad():
        assert ssd_scan_cuda(x, dA, Bm, Cm, chunk=16)[0].shape == x.shape
    q = torch.randn(1, 2, 64, 16, device=cuda, generator=g,
                    requires_grad=True)
    with pytest.raises(RuntimeError, match="attention_ref"):
        flash_attention_cuda(q, q.detach(), q.detach())


def test_cuda_train_step_matches_cpu(cuda):
    """Reduced mamba2-130m: one train step (two microbatches, remat) on the
    card and on the CPU from the same weights; the loss to rtol 1e-3 and
    the grad norm to rtol 1e-2 (bfloat16 products in another order), and
    no ssd_scan launch (training takes the plain scan)."""
    import copy

    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.steps import make_train_step

    cfg = reduced_config(get_config("mamba2-130m"))
    model = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = copy.deepcopy(model).to(cuda)
    tokens = torch.randint(0, cfg.vocab_size, (4, 33),
                           generator=torch.Generator().manual_seed(1))
    batch = {"inputs": tokens[:, :-1], "labels": tokens[:, 1:]}
    step = make_train_step(cfg, microbatches=2, lr=3e-3)
    before = registry.launch_counts().get("ssd_scan", 0)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        _, _, got = step(card, adamw_init(card),
                         {k: v.to(cuda) for k, v in batch.items()})
    _, _, exp = step(model, adamw_init(model), batch)
    assert registry.launch_counts().get("ssd_scan", 0) == before
    np.testing.assert_allclose(float(got["loss"]), float(exp["loss"]),
                               rtol=1e-3)
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(exp["grad_norm"]), rtol=1e-2)


# ---------------------------------------------------------------------------
# the MoE FFN on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["random", "skewed"])
def test_cuda_moe_ffn_matches_cpu(cuda, kind):
    """Reduced olmoe-1b-7b's MoE FFN on the card and on the CPU from the
    same weights and inputs: equal experts, positions and kept slots, gates
    to float32 roundings (the skewed input, 32 copies of one row, drops 16
    of 64 slots), and outputs to bfloat16 roundings (relative L2 1e-2, max
    2^-5 of the largest |y|, chip_smoke's MOE_ROUNDING_TOL); the per-expert
    loop on the card keeps the same slots."""
    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.models import moe

    cfg = reduced_config(get_config("olmoe-1b-7b"))
    p = moe.init_moe(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = moe.MoE(cfg, device=cuda)
    card.load_state_dict(p.state_dict())
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, cfg.d_model)) if kind == "random" else \
        np.repeat(rng.normal(size=(1, 1, cfg.d_model)), 32, axis=1)
    x = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    with torch.inference_mode():
        r, r_card = moe.route(p, x, cfg), moe.route(card, x.to(cuda), cfg)
        for name in ("topi", "pos", "keep"):
            assert torch.equal(getattr(r, name), getattr(r_card, name).cpu())
        torch.testing.assert_close(r.gates, r_card.gates.cpu())
        assert int((~r.keep).sum()) == (0 if kind == "random" else 16)
        exp = moe.moe_ffn(p, x, cfg).float()
        got = moe.moe_ffn(card, x.to(cuda), cfg).float().cpu()
        assert torch.equal(moe.moe_ffn_loop(card, x.to(cuda), cfg)[1].cpu(),
                           r.keep)
    d = got - exp
    assert float(d.norm() / exp.norm()) <= 1e-2
    assert float(d.abs().max()) <= 2 ** -5 * float(exp.abs().max())


def test_cuda_moe_train_step_matches_cpu(cuda):
    """Reduced olmoe-1b-7b: one train step (two microbatches, remat) on the
    card and on the CPU from the same weights; the loss to rtol 5e-3 and
    the grad norm to rtol 2e-2.  Looser than mamba2's (1e-3, 1e-2): the
    card's bfloat16 products round otherwise, and a token whose k-th and
    next router logits nearly tie may go to another expert (on the CPU
    against the JAX package's compiled step such a flip read 1.5e-3 on the
    loss and 3.1e-3 on the grad norm, tests/test_torch_train.py; a step on
    half the batch reads 3e-2 and more)."""
    import copy

    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.steps import make_train_step

    cfg = reduced_config(get_config("olmoe-1b-7b"))
    model = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = copy.deepcopy(model).to(cuda)
    tokens = torch.randint(0, cfg.vocab_size, (4, 33),
                           generator=torch.Generator().manual_seed(1))
    batch = {"inputs": tokens[:, :-1], "labels": tokens[:, 1:]}
    step = make_train_step(cfg, microbatches=2, lr=3e-3)
    _, _, got = step(card, adamw_init(card),
                     {k: v.to(cuda) for k, v in batch.items()})
    _, _, exp = step(model, adamw_init(model), batch)
    np.testing.assert_allclose(float(got["loss"]), float(exp["loss"]),
                               rtol=5e-3)
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(exp["grad_norm"]), rtol=2e-2)


def test_cuda_distributed_operators_over_nccl(cuda, tmp_path):
    """The distributed layer at world size 1 over NCCL (one card), on SSB
    columns of 100,000 rows, against numpy: the group sum (counts exact,
    float32 sums within count x 2^-23 of numpy's float64 sums), the shuffle
    and broadcast joins (equal to numpy's joins row for row, overflow 0),
    and the compressed psum (its result equal to the same computation on
    the CPU, within 2% of the plain all-reduce)."""
    import torch.distributed as dist

    from repro_torch.distributed.compression import (
        compressed_psum, psum_with_optional_compression)
    from repro_torch.distributed.relational import (
        make_broadcast_join, make_distributed_group_sum, make_shuffle_join)
    from repro_torch.launch.mesh import init_process_group, make_mesh
    from repro_torch.workloads.ssb import ssb_columns

    assert init_process_group(
        0, 1, init_method=f"file://{tmp_path / 'rdv'}") == "nccl"
    try:
        mesh = make_mesh((1,), ("data",))
        cols = ssb_columns(100_000, 0)
        lo = cols["lineorder"]
        date = _t(lo["lo_orderdate"].astype(np.int32), cuda)
        cust = _t(lo["lo_custkey"].astype(np.int32), cuda)
        rev32 = lo["lo_revenue"].astype(np.float32)
        rev = _t(rev32, cuda)
        G = len(cols["date_dim"]["d_datekey"])
        sums, counts = make_distributed_group_sum(mesh, G)(date, rev)
        exp_c = np.bincount(lo["lo_orderdate"], minlength=G)
        exp_s = np.bincount(lo["lo_orderdate"], weights=rev32, minlength=G)
        assert np.array_equal(_np(counts), exp_c.astype(np.float32))
        rel = np.abs(_np(sums).astype(np.float64) - exp_s) / exp_s
        assert (rel <= np.maximum(exp_c, 1) * 2.0 ** -23).all()

        ckey = _t(cols["customer"]["c_custkey"].astype(np.int32), cuda)
        cval32 = np.arange(len(ckey), dtype=np.float32) * 0.5
        k, lv, rv, ovf = make_shuffle_join(mesh, len(rev32))(
            cust, rev, ckey, _t(cval32, cuda))
        k, lv, rv = _np(k), _np(lv), _np(rv)
        assert int(ovf) == 0
        got, exp = np.lexsort((lv, k)), np.lexsort((rev32, lo["lo_custkey"]))
        assert np.array_equal(k[got], lo["lo_custkey"][exp])
        assert np.array_equal(lv[got], rev32[exp])
        assert np.array_equal(rv, cval32[k])

        dval32 = cols["date_dim"]["d_yearmonthnum"].astype(np.float32)
        k, lv, rv = make_broadcast_join(mesh)(
            date, rev, _t(cols["date_dim"]["d_datekey"].astype(np.int32), cuda),
            _t(dval32, cuda))
        assert np.array_equal(_np(k), lo["lo_orderdate"])
        assert np.array_equal(_np(lv), rev32)
        assert np.array_equal(_np(rv), dval32[lo["lo_orderdate"]])

        gen = torch.Generator().manual_seed(0)
        tree = {"w": torch.randn(3, 5000, generator=gen),
                "b": {"x": torch.randn(1024, generator=gen) * 100}}
        group = mesh.get_group("data")
        on_card = {"w": tree["w"].to(cuda), "b": {"x": tree["b"]["x"].to(cuda)}}
        got = compressed_psum(on_card, group)
        plain = psum_with_optional_compression(on_card, group, False)
        cpu_group = dist.new_group([0], backend="gloo")
        exp = compressed_psum(tree, cpu_group)
        for g, p, e in ((got["w"], plain["w"], exp["w"]),
                        (got["b"]["x"], plain["b"]["x"], exp["b"]["x"])):
            assert torch.equal(g.cpu(), e)
            assert float((g - p).abs().max() / p.abs().max()) < 0.02
    finally:
        dist.destroy_process_group()


def test_cuda_dryrun_cell_on_a_cuda_mesh(cuda, tmp_path):
    """launch/dryrun.py's default device: the debug-mesh cell on a cuda
    mesh of the fake process group (torch's own version on the card, whose
    DTensor lacks strategies the CPU's has: launch/strategies.py) counts
    the FLOPs, arguments and parameter bytes the same cell counts on a cpu
    mesh, and allocates nothing.  Its collectives (and the temporaries
    they make) may differ: DTensor picks them by the mesh's device (on a
    cpu mesh an all-to-all is an all-gather)."""
    from repro_torch.launch import dryrun

    before = torch.cuda.memory_allocated()
    got, exp = (dryrun.run_cell("qwen3-14b", "decode_32k", False, True,
                                out_dir=str(tmp_path / str(dev)), device=dev)
                for dev in (None, "cpu"))
    assert got["device"] == "cuda" and exp["device"] == "cpu"
    assert torch.cuda.memory_allocated() == before
    assert got["param_bytes_per_device"] == exp["param_bytes_per_device"]
    for key in ("argument_size_in_bytes", "output_size_in_bytes",
                "alias_size_in_bytes"):
        assert got["memory_analysis"][key] == exp["memory_analysis"][key]
    assert got["hlo_corrected"]["per_device_flops"] == \
        exp["hlo_corrected"]["per_device_flops"]
    assert got["collectives"]["op_count"] > 0


def test_cuda_surface_small(cuda, tmp_path):
    """The four-axes scenario (workloads/surface.py) at 60,000 lineorder
    rows under cuda, every result held to auto's on the same state (rows
    in any order, floats within np.allclose's defaults); each step's SQL
    kernel launches rise from 0, the federated joins and grouped count
    reaching key_lookup and hash_group, the view's build hash_group."""
    import repro_torch.api as db
    from repro_torch.core.session import Warehouse
    from repro_torch.workloads import surface
    from repro_torch.workloads.ssb import load_ssb

    kernels = ("filter_eval", "key_lookup", "hash_group",
               "hash_group_minmax", "hash_partition", "bloom_probe")
    must = {"federation": ("key_lookup", "hash_group"),
            "mv": ("hash_group",)}
    wh = Warehouse(str(tmp_path / "wh"))
    try:
        load_ssb(wh, scale_rows=60_000, seed=42)
        cfg = {"result_cache": False, "shuffle.partitions": 4}
        for name, step in surface.STEPS:
            registry.reset_launch_counts()
            step(db, wh, "cuda", cfg, against="auto")
            launches = registry.launch_counts()
            assert any(launches.get(k, 0) for k in kernels), (name, launches)
            for k in must.get(name, ()):
                assert launches.get(k, 0) > 0, (name, k, launches)
    finally:
        wh.close()
