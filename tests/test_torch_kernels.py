"""The port's kernels (repro_torch.kernels) against the JAX package's.

The same numpy inputs, made from a seed, go through the JAX Pallas kernel
(interpret mode on the CPU, as the JAX package's own tests run it), the JAX
plain version, and the port's plain torch version and wrapper.  On the CPU
the wrapper takes the plain version because its tensors lie on the CPU; the
CUDA kernels themselves are tested in test_torch_cuda.py, which needs a
card and imports no JAX.

Tolerances: filter_eval, key_lookup and hash_group_minmax are exact; grouped
counts are exact; grouped sums of random floats agree at atol 1e-3, because
the kernels add in another order (float atomics on the card, a one-hot
matmul in JAX).
"""
import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

from repro.kernels.filter_eval.ops import filter_eval as jx_filter_eval
from repro.kernels.hash_group.ops import hash_group as jx_hash_group
from repro.kernels.hash_group.ops import hash_group_minmax as jx_minmax
from repro.kernels.key_lookup.ops import key_lookup as jx_key_lookup
from repro_torch.kernels import registry
from repro_torch.kernels.filter_eval.ops import filter_eval, filter_eval_cuda
from repro_torch.kernels.filter_eval.ref import filter_eval_ref
from repro_torch.kernels.hash_group.ops import (hash_group, hash_group_cuda,
                                                hash_group_minmax,
                                                hash_group_minmax_cuda)
from repro_torch.kernels.hash_group.ref import (hash_group_minmax_ref,
                                                hash_group_ref)
from repro_torch.kernels.key_lookup.ops import key_lookup, key_lookup_cuda
from repro_torch.kernels.key_lookup.ref import key_lookup_ref
from test_torch_cuda import FILTER_CASES, GROUP_CASES, _filter_inputs, _np, _t

JAX_ENGINES = ("pallas", "ref")


# ---------------------------------------------------------------------------
# filter_eval
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,ncols", FILTER_CASES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64])
def test_filter_eval_matches_jax(n, ncols, dtype):
    cols, ops, lits = _filter_inputs(n, ncols, dtype)
    tcols = [_t(c) for c in cols]
    port_ref = _np(filter_eval_ref(tcols, ops, lits))
    port_wrap = _np(filter_eval_cuda(tcols, ops, lits))
    assert port_ref.dtype == np.bool_
    assert np.array_equal(port_wrap, port_ref)
    for eng in JAX_ENGINES:
        jx = np.asarray(jx_filter_eval(cols, ops, lits, engine=eng))
        assert np.array_equal(port_ref, jx), eng


def test_filter_eval_all_ops_and_nan():
    x = np.array([np.nan, -1.0, 0.0, 2.5, 3.0, 1e7], dtype=np.float32)
    for op in range(6):
        got = _np(filter_eval([_t(x)], (op,), (2.5,), engine="ref"))
        exp = np.asarray(jx_filter_eval([x], (op,), (2.5,), engine="ref"))
        assert np.array_equal(got, exp), op


def test_filter_eval_empty():
    cols = [np.zeros(0, np.float32), np.zeros(0, np.float32)]
    got = filter_eval_cuda([_t(c) for c in cols], (0, 4), (1.0, 2.0))
    exp = np.asarray(jx_filter_eval(cols, (0, 4), (1.0, 2.0), engine="ref"))
    assert got.shape == (0,) and exp.shape == (0,)
    assert got.dtype == torch.bool


# ---------------------------------------------------------------------------
# key_lookup
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("g,n", [(900, 5000), (200, 1024), (2556, 1024),
                                 (1, 7), (1000, 1)])
def test_key_lookup_matches_jax(g, n):
    rng = np.random.default_rng(11 + g)
    uniq = np.unique(rng.integers(0, 3 * g + 1, g)).astype(np.float32)
    probe = rng.integers(-50, 3 * g + 50, n).astype(np.float32)
    port = _np(key_lookup(_t(uniq), _t(probe), engine="ref"))
    assert port.dtype == np.int32
    assert np.array_equal(_np(key_lookup_cuda(_t(uniq), _t(probe))), port)
    for eng in JAX_ENGINES:
        jx = np.asarray(jx_key_lookup(uniq, probe, engine=eng))
        assert np.array_equal(port, jx), eng
    hit = port >= 0
    assert np.array_equal(uniq[port[hit]], probe[hit])
    assert not np.isin(probe[~hit], uniq).any()


@pytest.mark.parametrize("g,n", [(0, 5), (5, 0), (0, 0)])
def test_key_lookup_empty(g, n):
    uniq = np.arange(g, dtype=np.float32)
    probe = np.arange(n, dtype=np.float32)
    port = _np(key_lookup_cuda(_t(uniq), _t(probe)))
    jx = np.asarray(jx_key_lookup(uniq, probe, engine="ref"))
    assert np.array_equal(port, jx)
    assert port.dtype == np.int32


# ---------------------------------------------------------------------------
# hash_group / hash_group_minmax
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,g", GROUP_CASES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_hash_group_matches_jax(n, g, dtype):
    rng = np.random.default_rng(g)
    codes = rng.integers(0, g, n).astype(np.int32)
    vals = rng.normal(size=n).astype(dtype)
    s, c = (_np(x) for x in hash_group(_t(codes), _t(vals), g, engine="ref"))
    ws, wc = (_np(x) for x in hash_group_cuda(_t(codes), _t(vals), g))
    assert np.array_equal(ws, s) and np.array_equal(wc, c)
    for eng in JAX_ENGINES:
        js, jc = jx_hash_group(codes, vals, g, engine=eng)
        np.testing.assert_allclose(s, np.asarray(js), atol=1e-3)
        np.testing.assert_array_equal(c, np.asarray(jc))


def test_hash_group_masked_and_integer_sums_exact():
    rng = np.random.default_rng(2)
    codes = rng.integers(-1, 50, 6000).astype(np.int32)  # -1 = masked
    vals = rng.integers(1, 50, 6000).astype(np.float32)
    s, c = (_np(x) for x in hash_group_ref(_t(codes), _t(vals), 50))
    for eng in JAX_ENGINES:
        js, jc = jx_hash_group(codes, vals, 50, engine=eng)
        assert np.array_equal(s, np.asarray(js)), eng
        assert np.array_equal(c, np.asarray(jc)), eng
    assert c.sum() == (codes >= 0).sum()


@pytest.mark.parametrize("n,g", GROUP_CASES + [(10_000, 200)])
def test_hash_group_minmax_matches_jax(n, g):
    rng = np.random.default_rng(5 + g)
    codes = rng.integers(0, g, n).astype(np.int32)
    vals = rng.integers(-1000, 1000, n).astype(np.float32)
    mins, maxs = (_np(x) for x in
                  hash_group_minmax(_t(codes), _t(vals), g, engine="ref"))
    wm, wx = (_np(x) for x in hash_group_minmax_cuda(_t(codes), _t(vals), g))
    assert np.array_equal(wm, mins) and np.array_equal(wx, maxs)
    for eng in JAX_ENGINES:
        jm, jx = jx_minmax(codes, vals, g, engine=eng)
        assert np.array_equal(mins, np.asarray(jm)), eng
        assert np.array_equal(maxs, np.asarray(jx)), eng


def test_hash_group_minmax_empty_groups_hold_inf():
    codes = np.array([0, 0, 2, -1], dtype=np.int32)
    vals = np.array([3.0, -1.5, 7.0, 99.0], dtype=np.float32)
    mins, maxs = (_np(x) for x in hash_group_minmax_ref(_t(codes), _t(vals), 4))
    jm, jx = jx_minmax(codes, vals, 4, engine="ref")
    assert np.array_equal(mins, np.asarray(jm))
    assert np.array_equal(maxs, np.asarray(jx))
    assert mins.tolist() == [-1.5, np.inf, 7.0, np.inf]
    assert maxs.tolist() == [3.0, -np.inf, 7.0, -np.inf]


@pytest.mark.parametrize("g", [1, 37])
def test_hash_group_empty_input(g):
    codes = np.zeros(0, np.int32)
    vals = np.zeros(0, np.float32)
    s, c = (_np(x) for x in hash_group_cuda(_t(codes), _t(vals), g))
    js, jc = jx_hash_group(codes, vals, g, engine="ref")
    assert np.array_equal(s, np.asarray(js)) and np.array_equal(c, np.asarray(jc))
    m, x = (_np(t) for t in hash_group_minmax_cuda(_t(codes), _t(vals), g))
    jm, jx = jx_minmax(codes, vals, g, engine="ref")
    assert np.array_equal(m, np.asarray(jm)) and np.array_equal(x, np.asarray(jx))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
def test_registry_engines_and_aliases():
    assert registry.VALID_ENGINES == ("auto", "cuda", "pallas", "ref")
    for name in ("filter_eval", "key_lookup", "hash_group",
                 "hash_group_minmax"):
        assert registry.backends(name) == ("cuda", "ref")
        cuda = registry.resolve(name, "cuda")
        assert registry.resolve(name, "pallas") is cuda
        assert registry.resolve(name, "auto") is cuda
        assert registry.resolve(name, "ref") is not cuda
    with pytest.raises(ValueError):
        registry.resolve("filter_eval", "tpu")
    with pytest.raises(ValueError):
        registry.register("x", "pallas", lambda: None)


@pytest.mark.parametrize("name,item", [("hash_partition", "B5"),
                                       ("bloom_probe", "B6"),
                                       ("ssd_scan", "B7"),
                                       ("flash_attention", "B8")])
@pytest.mark.parametrize("engine", ["cuda", "ref"])
def test_registry_unported_kernels_raise(name, item, engine):
    with pytest.raises(KeyError, match=f"{name}.*{item}"):
        registry.resolve(name, engine)


def test_host_call_round_trips_numpy():
    fn = registry.host_call(registry.resolve("key_lookup", "ref"),
                            torch.device("cpu"))
    out = fn(np.array([1.0, 3.0], np.float32), np.array([3.0, 2.0], np.float32))
    assert isinstance(out, np.ndarray) and out.tolist() == [1, -1]
    sums, counts = registry.host_call(registry.resolve("hash_group", "ref"),
                                      torch.device("cpu"))(
        np.array([0, 1, 1], np.int32), np.array([1.0, 2.0, 4.0], np.float32), 2)
    assert sums.tolist() == [1.0, 6.0] and counts.tolist() == [1.0, 2.0]


def test_cuda_engine_without_gpu_raises():
    fn = registry.host_call(registry.resolve("filter_eval", "cuda"),
                            torch.device("cuda"))
    if registry.on_gpu():
        assert fn((np.ones(4, np.float32),), (0,), (2.0,)).all()
        return
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        fn((np.ones(4, np.float32),), (0,), (2.0,))


def test_cpu_tensors_never_launch():
    before = registry.launch_counts()
    filter_eval_cuda([_t(np.ones(8, np.float32))], (0,), (2.0,))
    key_lookup_cuda(_t(np.ones(3, np.float32)), _t(np.ones(8, np.float32)))
    hash_group_cuda(_t(np.zeros(8, np.int32)), _t(np.ones(8, np.float32)), 1)
    hash_group_minmax_cuda(_t(np.zeros(8, np.int32)),
                           _t(np.ones(8, np.float32)), 1)
    assert registry.launch_counts() == before
