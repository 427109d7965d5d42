"""hash_group's morsel path (csrc/hash_group.cu) in plain torch, adding in
the kernel's order, in float32 throughout:

- up to REGISTER_GROUPS groups (``registers``): thread t of the block's
  MORSEL_THREADS sums rows t, t + T, ... of each group, from 0 (a row of
  another group adds 0); each warp folds its 32 lanes by the xor butterfly
  (16, 8, 4, 2, 1: lane l adds lane l ^ off, so every lane ends with the
  same bits, those of halving the 32 lanes five times); the warps' sums are
  added in warp order, from 0;
- up to WARP_COPY_GROUPS (``warp_copies``): warp w takes the 32-row chunks
  w, w + W, ... in order; in each chunk the values of a group are added in
  lane order, from 0, and that sum to the warp's copy; the copies are added
  in warp order, from 0.

Counts are integers and exact in any order.  The card holds the kernel's
sums to :func:`morsel_order` bit for bit (chip_smoke.py and
tests/test_torch_cuda.py); tests/test_torch_group_order.py holds it to the
JAX package's kernel.
"""
from __future__ import annotations

import torch

from .ops import MORSEL_THREADS, REGISTER_GROUPS, WARP_COPY_GROUPS, WARPS


def _valid(codes, num_groups):
    codes = codes.to(torch.int64)
    return torch.where((codes >= 0) & (codes < num_groups), codes, -1)


def _pad(codes, vals, num_groups, multiple):
    """Codes (invalid ones as -1) and float32 values padded with masked
    rows to a multiple of ``multiple``."""
    n = codes.shape[0]
    size = -(-n // multiple) * multiple
    c = torch.full((size,), -1, dtype=torch.int64)
    v = torch.zeros(size, dtype=torch.float32)
    c[:n] = _valid(codes, num_groups)
    v[:n] = vals.to(torch.float32)
    return c, v


def _counts(codes, num_groups):
    c = _valid(codes, num_groups)
    return torch.bincount(c[c >= 0], minlength=num_groups).to(torch.float32)


def _emulate_registers(codes, vals, num_groups):
    T, W = MORSEL_THREADS, WARPS
    c, v = _pad(codes, vals, num_groups, T)
    groups = torch.arange(num_groups)
    lanes = torch.zeros(T, num_groups, dtype=torch.float32)
    for r in range(c.shape[0] // T):  # thread t's rows t + r T, in order
        hit = c[r * T:(r + 1) * T, None] == groups
        lanes = lanes + torch.where(hit, v[r * T:(r + 1) * T, None],
                                    torch.zeros(()))
    x = lanes.view(W, 32, num_groups)
    for half in (16, 8, 4, 2, 1):  # the butterfly, as lane 0 sees it
        x = x[:, :half] + x[:, half:2 * half]
    sums = torch.zeros(num_groups, dtype=torch.float32)
    for w in range(W):
        sums = sums + x[w, 0]
    return sums


def _emulate_warp_copies(codes, vals, num_groups):
    W = WARPS
    c, v = _pad(codes, vals, num_groups, 32 * W)
    c, v = c.view(-1, W, 32), v.view(-1, W, 32)  # round, warp, lane
    groups = torch.arange(num_groups)
    copies = torch.zeros(W, num_groups, dtype=torch.float32)
    for r in range(c.shape[0]):  # chunk r W + w goes to warp w
        chunk = torch.zeros(W, num_groups, dtype=torch.float32)
        for lane in range(32):
            hit = c[r, :, lane, None] == groups
            chunk = chunk + torch.where(hit, v[r, :, lane, None],
                                        torch.zeros(()))
        copies = copies + chunk
    sums = torch.zeros(num_groups, dtype=torch.float32)
    for w in range(W):
        sums = sums + copies[w]
    return sums


def morsel_order(codes, vals, num_groups):
    """(sums, counts) as the morsel path adds them (up to WARP_COPY_GROUPS
    groups); CPU tensors in and out."""
    if num_groups > WARP_COPY_GROUPS:
        raise ValueError(f"{num_groups} groups take the grid path, not the "
                         "morsel path")
    if num_groups <= REGISTER_GROUPS:
        sums = _emulate_registers(codes, vals, num_groups)
    else:
        sums = _emulate_warp_copies(codes, vals, num_groups)
    return sums, _counts(codes, num_groups)
