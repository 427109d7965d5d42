"""Plain torch version: exact causal (or full) softmax attention."""
from __future__ import annotations

import numpy as np
import torch


def attention_ref(q, k, v, causal: bool = True):
    """q/k/v: (B, H, S, d); float32 softmax, output in q's dtype."""
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / np.sqrt(d)
    if causal:
        S = q.shape[2]
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, -1e30)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)
