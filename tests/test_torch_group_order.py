"""The addition order of hash_group's morsel path and filter_eval's row split
(csrc/hash_group.cu, csrc/filter_eval.cu), emulated in plain torch on the
CPU, and the wrappers' choice of path.

``morsel_order`` (kernels/hash_group/order.py) adds in the morsel path's
order: lane sums, the xor butterfly, the fold over warps in order (or, above
32 groups, a copy per warp of lane-ordered chunk sums), float32 throughout.
It is held to the JAX package's ``hash_group_pallas`` (interpret
mode, a one-hot product per row block) and plain version at the existing
tolerance (sums of random floats at atol 1e-3, counts and integer sums
exact), for n in {1, 31, 1,024, MORSEL_ROWS} and G in {1, 7, 31, 32, 33},
with masked codes and codes >= G.  The card tests (test_torch_cuda.py) hold
the kernel to it bit for bit.  JAX is imported inside the tests that compare
with it.

``emulate_filter_split`` takes filter_eval's rows in the kernel's parts
(the head one by one, the body four rows at a time from 16-byte-aligned
column addresses into a 4-byte-aligned mask word, the tail one by one),
on views at offsets 0-3, against the JAX ``filter_eval_pallas``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.filter_eval.ops import (_launch_args, column_head,
                                                 mask_buffer, vector_head)
from repro_torch.kernels.filter_eval.ref import filter_eval_ref
from repro_torch.kernels import registry
from repro_torch.kernels.hash_group.ops import (GRID_BLOCKS_PER_SM,
                                                GROUP_PATHS, MORSEL_COPY_ROWS,
                                                MORSEL_ROWS, MORSEL_THREADS,
                                                REGISTER_GROUPS, SMEM_GROUPS,
                                                SMEM_OPT_IN, WARP_COPY_GROUPS,
                                                WARPS, _count_group,
                                                group_path, hash_group_cuda,
                                                limits, morsel_rows)
from repro_torch.kernels.hash_group.order import morsel_order
from repro_torch.kernels.hash_group.ref import hash_group_ref

ORDER_N = [1, 31, 1024, MORSEL_ROWS]
ORDER_G = [1, 7, 31, 32, 33]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def group_inputs(n, num_groups, seed, integers=False):
    """Codes from -1 (masked) to num_groups + 2 (dropped above G - 1);
    values normal or small integers, float32."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(-1, num_groups + 3, n).astype(np.int32)
    if integers:
        vals = rng.integers(-3, 50, n).astype(np.float32)
    else:
        vals = rng.normal(size=n).astype(np.float32)
    return codes, vals


# ---------------------------------------------------------------------------
# hash_group: the morsel path's order against the JAX kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", ORDER_N)
@pytest.mark.parametrize("g", ORDER_G)
def test_morsel_order_matches_jax(n, g):
    from repro.kernels.hash_group.hash_group import hash_group_pallas
    from repro.kernels.hash_group.ref import hash_group_ref as jx_ref

    codes, vals = group_inputs(n, g, seed=1000 * g + n)
    sums, counts = morsel_order(_t(codes), _t(vals), g)
    es, ec = hash_group_ref(_t(codes), _t(vals), g)
    np.testing.assert_allclose(sums.numpy(), es.numpy(), atol=1e-3)
    assert torch.equal(counts, ec)
    for js, jc in (hash_group_pallas(codes, vals, g, interpret=True),
                   jx_ref(codes, vals, g)):
        np.testing.assert_allclose(sums.numpy(), np.asarray(js), atol=1e-3)
        assert np.array_equal(counts.numpy(), np.asarray(jc))


@pytest.mark.parametrize("g", [7, 33])
def test_morsel_order_integer_sums_exact(g):
    """Integer values whose partial sums stay below 2^24 add exactly in
    any order: the emulation equals the plain version bit for bit."""
    codes, vals = group_inputs(MORSEL_ROWS, g, seed=g, integers=True)
    sums, counts = morsel_order(_t(codes), _t(vals), g)
    es, ec = hash_group_ref(_t(codes), _t(vals), g)
    assert torch.equal(sums, es) and torch.equal(counts, ec)


def test_morsel_order_is_not_the_plain_order():
    """At the path's shape the butterfly's order differs from a sequential
    sum somewhere, which is why the card holds the kernel to the emulation
    and not to the plain version bit for bit."""
    differ = 0
    for seed in range(20):
        codes, vals = group_inputs(1024, 7, seed)
        sums, _ = morsel_order(_t(codes), _t(vals), 7)
        es, _ = hash_group_ref(_t(codes), _t(vals), 7)
        differ += int((sums != es).sum())
    assert differ > 0


def test_morsel_order_keeps_specials_in_their_group():
    """inf, -inf and -0.0 reach only their own group; a row of another
    group adds +0.0, which leaves every sum as it was."""
    codes = np.array([0, 1, 1, 2, 2, 3, -1, 5], np.int32)
    vals = np.array([np.inf, -0.0, -0.0, -np.inf, 1.0, 2.5, np.nan, np.nan],
                    np.float32)
    sums, counts = morsel_order(_t(codes), _t(vals), 4)
    assert sums.tolist() == [np.inf, 0.0, -np.inf, 2.5]
    assert counts.tolist() == [1.0, 2.0, 2.0, 1.0]


# ---------------------------------------------------------------------------
# hash_group: the path chooser and its limits
# ---------------------------------------------------------------------------
def test_group_path_takes_the_morsel_at_the_path_shape():
    assert group_path(1024, 7) == "morsel"
    assert 7 <= REGISTER_GROUPS  # its sums stay in registers


def test_group_path_limits():
    assert (MORSEL_ROWS, MORSEL_COPY_ROWS) == (8192, 2048)
    assert [morsel_rows(g) for g in (1, 32, 33, SMEM_GROUPS)] == \
        [MORSEL_ROWS, MORSEL_ROWS, MORSEL_COPY_ROWS, MORSEL_COPY_ROWS]
    assert group_path(1, 1) == "morsel"
    assert group_path(MORSEL_ROWS, 32) == "morsel"
    assert group_path(MORSEL_ROWS + 1, 32) == "grid"
    assert group_path(MORSEL_COPY_ROWS, 33) == "morsel"
    assert group_path(MORSEL_COPY_ROWS + 1, 33) == "grid"
    assert group_path(MORSEL_COPY_ROWS, WARP_COPY_GROUPS) == "morsel"
    assert group_path(1, WARP_COPY_GROUPS + 1) == "grid"
    assert group_path(MORSEL_COPY_ROWS, SMEM_GROUPS) == "grid"
    assert group_path(MORSEL_ROWS + 1, 7) == "grid"
    assert group_path(4_000_000, SMEM_GROUPS) == "grid"
    assert group_path(4_000_000, 8000) == "grid"  # was per-row global atomics
    assert group_path(1024, SMEM_GROUPS + 1) == "global"
    assert group_path(4_000_000, SMEM_GROUPS + 1) == "global"


def test_group_limits_fill_the_opt_in():
    """The H100's 227 KB opt-in, less 32 staged floats a warp, holds a sum
    and a count of SMEM_GROUPS groups once, or of WARP_COPY_GROUPS once
    per warp; the old 48 KB limit held 6,144."""
    assert SMEM_OPT_IN == 227 * 1024
    assert (MORSEL_THREADS, WARPS, REGISTER_GROUPS) == (512, 16, 32)
    free = SMEM_OPT_IN - WARPS * 32 * 4
    assert (SMEM_GROUPS, WARP_COPY_GROUPS) == (28_800, 1_800)
    assert 8 * SMEM_GROUPS <= free < 8 * (SMEM_GROUPS + 1)
    assert 8 * WARPS * WARP_COPY_GROUPS <= free < \
        8 * WARPS * (WARP_COPY_GROUPS + 1)
    assert SMEM_GROUPS > 4 * 6144 and GRID_BLOCKS_PER_SM == 2


def test_group_limits_in_the_kernels_order():
    """limits() lists the copies in the order csrc/hash_group.cu's
    hash_group_limits writes them (the card tests compare the two): the
    path codes, then the sizes."""
    assert GROUP_PATHS == ("morsel", "grid", "global")
    assert list(limits().items()) == [
        ("morsel", 0), ("grid", 1), ("global", 2), ("MORSEL_THREADS", 512),
        ("REGISTER_GROUPS", 32), ("WARP_COPY_GROUPS", 1_800),
        ("SMEM_GROUPS", 28_800), ("SMEM_OPT_IN", 232_448),
        ("GRID_BLOCKS_PER_SM", 2)]


def test_morsel_order_is_only_the_morsel_paths():
    """Above WARP_COPY_GROUPS the grid path takes every call, and the
    emulation refuses."""
    codes, vals = group_inputs(64, WARP_COPY_GROUPS + 1, seed=3)
    with pytest.raises(ValueError, match="grid path"):
        morsel_order(_t(codes), _t(vals), WARP_COPY_GROUPS + 1)


@pytest.mark.parametrize("g,bucket", [(1, 1), (2, 2), (7, 8), (32, 32),
                                      (33, 64), (3000, 4096)])
def test_group_launch_counted_by_its_g(g, bucket, monkeypatch):
    """A launch counts once as hash_group, once on its path and once on its
    G rounded up to a power of two (in counts of the test's own: no launch
    counts on the CPU, which other tests assert)."""
    monkeypatch.setattr(registry, "_LAUNCHES", {})
    _count_group("grid", g)
    assert registry.launch_counts() == {
        "hash_group": 1, "hash_group.grid": 1,
        f"hash_group.grid.G<={bucket}": 1}


@pytest.mark.parametrize("g", [7, 40])
def test_wrapper_on_the_cpu_takes_the_plain_version(g):
    codes, vals = group_inputs(300, g, seed=4)
    got = hash_group_cuda(_t(codes), _t(vals), g)
    exp = hash_group_ref(_t(codes), _t(vals), g)
    assert all(torch.equal(a, b) for a, b in zip(got, exp))


# ---------------------------------------------------------------------------
# filter_eval: the head / body / tail split
# ---------------------------------------------------------------------------
def emulate_filter_split(columns, ops, lits, head, out_ptr):
    """The mask as the kernel takes the rows: with ``head`` >= 0 the first
    min(head, n) rows one by one, then four rows a thread (each column read
    from a 16-byte boundary, the mask written to a 4-byte one), then the
    rest one by one; with head -1 every row one by one.  Checks that every
    row is taken exactly once."""
    n = columns[0].shape[0]
    mask = torch.zeros(n, dtype=torch.bool)
    taken = torch.zeros(n, dtype=torch.int64)
    parts = [(0, n, 1)]
    if head >= 0:
        h = min(head, n)
        body = h + (n - h) // 4 * 4
        parts = [(0, h, 1), (h, body, 4), (body, n, 1)]
    for lo, hi, width in parts:
        if hi <= lo:
            continue
        if width == 4:
            for c in columns:
                assert (c.data_ptr() + 4 * lo) % 16 == 0
            assert (out_ptr + lo) % 4 == 0
        quads = [c[lo:hi].view(-1, width) for c in columns]
        mask[lo:hi] = filter_eval_ref(quads, ops, lits).view(-1)
        taken[lo:hi] += 1
    assert torch.equal(taken, torch.ones(n, dtype=torch.int64))
    return mask


FILTER_OFFSETS = [(0,), (1,), (2,), (3,), (1, 1, 1), (3, 3), (0, 1),
                  (2, 0, 3), (1, 2, 3, 0, 1, 2, 3, 0)]


@pytest.mark.parametrize("offsets", FILTER_OFFSETS)
@pytest.mark.parametrize("n", [1, 6, 1029])
def test_filter_split_on_views_matches_jax(offsets, n):
    from repro.kernels.filter_eval.filter_eval import filter_eval_pallas

    rng = np.random.default_rng(len(offsets) * 10 + n)
    k = len(offsets)
    bases = []
    for _ in range(k):
        a = rng.integers(-3, 4, n + 4).astype(np.float32)
        for v in (-0.0, 0.0, np.nan):
            a[rng.integers(0, n + 4, max(1, n // 8))] = v
        bases.append(_t(a))
    cols = [b[o:o + n] for b, o in zip(bases, offsets)]
    for c, o in zip(cols, offsets):
        assert c.data_ptr() % 16 == 4 * o  # torch's CPU allocations: 64 B
    ops = tuple(i % 6 for i in range(k))
    lits = tuple([0.0, -0.0, 1.0, 2.0, -1.0, 0.0, 3.0, -2.0][:k])
    ptrs = [c.data_ptr() for c in cols]
    head = column_head(ptrs)
    assert head == ((4 - offsets[0]) % 4 if len(set(offsets)) == 1 else -1)
    out = mask_buffer(n, head, torch.device("cpu"))
    assert out.shape == (n,) and vector_head(ptrs, out.data_ptr()) == head
    got = emulate_filter_split(cols, ops, lits, head, out.data_ptr())
    exp = np.asarray(filter_eval_pallas([c.numpy() for c in cols], ops, lits,
                                        interpret=True))
    assert np.array_equal(got.numpy(), exp)


def test_filter_head_needs_the_mask_in_phase():
    """Columns in phase but a mask byte off its 4-byte boundary: every row
    one by one."""
    ptrs = [4096 + 4, 8192 + 4]
    assert column_head(ptrs) == 3
    assert vector_head(ptrs, 1024 + 1) == 3
    assert vector_head(ptrs, 1024) == -1
    assert column_head([4096 + 2]) == -1  # not even float-aligned


def test_filter_launch_args():
    """The kernel's by-value arguments: K column pointers, op codes and
    literals, then K; more than eight columns or an unknown op raise."""
    cols, ops, lits, k = _launch_args([16, 32], (0, 5), (1.5, -0.0))
    assert k == 2 and list(cols) == [16, 32] and list(ops) == [0, 5]
    assert list(lits) == [1.5, -0.0]
    with pytest.raises(ValueError, match="at most 8"):
        _launch_args([16] * 9, (0,) * 9, (0.0,) * 9)
    with pytest.raises(ValueError, match="unknown filter op"):
        _launch_args([16], (6,), (0.0,))
