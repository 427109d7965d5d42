"""Plain torch version of the join-key dictionary lookup (the oracle)."""
from __future__ import annotations

import torch


def key_lookup_ref(sorted_vals, probe):
    g = sorted_vals.shape[0]
    if g == 0:
        return torch.full(probe.shape, -1, dtype=torch.int32,
                          device=probe.device)
    svals = sorted_vals.to(torch.float32)
    p = probe.to(torch.float32)
    idx = torch.searchsorted(svals, p)
    found = (idx < g) & (svals[idx.clamp(max=g - 1)] == p)
    return torch.where(found, idx, -1).to(torch.int32)
