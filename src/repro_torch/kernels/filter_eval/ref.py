"""Plain torch version of vectorized predicate evaluation (the oracle)."""
from __future__ import annotations

import torch

_OPS = {
    0: lambda x, l: x < l,
    1: lambda x, l: x <= l,
    2: lambda x, l: x > l,
    3: lambda x, l: x >= l,
    4: lambda x, l: x == l,
    5: lambda x, l: x != l,
}


def filter_eval_ref(columns, ops, lits):
    mask = torch.ones(columns[0].shape, dtype=torch.bool,
                      device=columns[0].device)
    for c, op, lit in zip(columns, ops, lits):
        lit32 = torch.tensor(lit, dtype=torch.float32, device=c.device)
        mask &= _OPS[op](c.to(torch.float32), lit32)
    return mask
