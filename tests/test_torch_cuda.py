"""The port's CUDA kernels on the card against their plain torch versions.

Imports no JAX, so it runs on a GPU machine without it:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Every test skips without a GPU of compute capability >= 9.0.  Tolerances:
filter_eval, key_lookup, counts, integer-valued sums and MIN/MAX are exact;
sums of random floats agree at atol 1e-3, because float atomics add in an
order that changes from run to run.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import registry
from repro_torch.kernels.filter_eval.ops import filter_eval_cuda
from repro_torch.kernels.filter_eval.ref import filter_eval_ref
from repro_torch.kernels.hash_group.ops import (hash_group_cuda,
                                                hash_group_minmax_cuda)
from repro_torch.kernels.hash_group.ref import (hash_group_minmax_ref,
                                                hash_group_ref)
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


@pytest.mark.parametrize("g,n", [(200, 1024), (2556, 1024), (1, 5),
                                 (20_000, 100_000), (2556, 3_000_000)])
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
