"""Plain torch version of shuffle bucket assignment (the oracle).

The same hash as the CUDA kernel and the numpy host path in
``core/runtime/shuffle.py``: float32 bitcast (-0.0 taken as +0.0), FNV-style
column fold, lowbias32 avalanche, modulo the lane count.  torch has no
wrapping uint32 arithmetic, so the words live in int64 and every product is
reduced modulo 2**32 (split in 16-bit halves, so nothing overflows int64).
"""
from __future__ import annotations

import torch

# FNV-1a style column fold + lowbias32 avalanche finisher (uint32 wrap)
FNV_PRIME = 16777619
MIX1 = 0x7FEB352D
MIX2 = 0x846CA68B
_U32 = 0xFFFFFFFF


def _mul32(h, m: int):
    """(h * m) mod 2**32 for int64 h in [0, 2**32) and a constant m."""
    return (h * (m & 0xFFFF) + (((h * (m >> 16)) & 0xFFFF) << 16)) & _U32


def _avalanche(h):
    h = h ^ (h >> 16)
    h = _mul32(h, MIX1)
    h = h ^ (h >> 15)
    h = _mul32(h, MIX2)
    return h ^ (h >> 16)


def key_words(col):
    """Canonical uint32 word per value (in int64): the float32 bit pattern,
    -0.0 taken as +0.0 by a select, so NaN payloads stay as they are."""
    v = col.to(torch.float32)
    v = torch.where(v == 0, torch.zeros_like(v), v)
    return v.view(torch.int32).to(torch.int64) & _U32


def hash_partition_ref(cols, num_partitions: int):
    cols = tuple(cols)
    h = torch.zeros(cols[0].shape[0], dtype=torch.int64,
                    device=cols[0].device)
    for c in cols:
        h = _mul32(h, FNV_PRIME) ^ key_words(c)
    return (_avalanche(h) % num_partitions).to(torch.int32)
