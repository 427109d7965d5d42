"""Plain torch version of the bloom probe (the oracle; mirrors
``core.bloomfilter.BloomFilter.might_contain``).

torch has no wrapping uint32 arithmetic, so hashes and words live in int64:
``h1 + k*h2`` then cannot wrap, and masking with ``num_bits - 1`` keeps the
same low bits that a uint32 sum keeps.
"""
from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF


def as_u32(t):
    """Integer tensor -> its uint32 values, in int64."""
    if t.dtype == torch.uint32:
        t = t.view(torch.int32)
    return t.to(torch.int64) & _U32


def bloom_probe_ref(h1, h2, bits, num_hashes: int, num_bits: int):
    a, b, words = as_u32(h1), as_u32(h2), as_u32(bits)
    ok = torch.ones(a.shape, dtype=torch.bool, device=a.device)
    for k in range(num_hashes):
        pos = (a + k * b) & (num_bits - 1)
        ok &= ((words[pos >> 5] >> (pos & 31)) & 1).bool()
    return ok
