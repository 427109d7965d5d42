"""Plain torch version of grouped aggregation (the oracle).

Rows whose code is negative (masked) or not below ``num_groups`` are
dropped, as the JAX package's scatter drops out-of-range updates."""
from __future__ import annotations

import torch


def _valid(codes, values, num_groups: int):
    keep = (codes >= 0) & (codes < num_groups)
    return codes[keep].long(), values[keep].to(torch.float32)


def hash_group_ref(codes, values, num_groups: int):
    idx, v = _valid(codes, values, num_groups)
    sums = torch.zeros(num_groups, dtype=torch.float32, device=codes.device)
    counts = torch.zeros_like(sums)
    sums.index_add_(0, idx, v)
    counts.index_add_(0, idx, torch.ones_like(v))
    return sums, counts


def hash_group_minmax_ref(codes, values, num_groups: int):
    idx, v = _valid(codes, values, num_groups)
    mins = torch.full((num_groups,), float("inf"), dtype=torch.float32,
                      device=codes.device)
    maxs = torch.full_like(mins, float("-inf"))
    mins.scatter_reduce_(0, idx, v, "amin")
    maxs.scatter_reduce_(0, idx, v, "amax")
    return mins, maxs
