"""Operations and bytes of one launch of each SQL kernel, from its shapes,
and the H100's peaks: the yardstick of ``kernel_roofline``.

Each input byte is counted as read once and each output byte as written
once, whatever a kernel reads again; operations are those the function
needs (a comparison, an add, a hash step), not those a kernel spends.  A
launch's bound time is the larger of bytes over the memory bandwidth and
operations over the CUDA cores' float32 rate (none of the six uses the
tensor cores).  Shapes are the arguments of the kernel's launch: ``n``
rows, ``k`` columns, ``g`` groups or dictionary entries, ``words`` of a
bloom filter's bits, ``hashes`` probes a row.
"""
from __future__ import annotations

import math

# NVIDIA H100 SXM5 data sheet, dense rates, at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

F32 = I32 = U32 = 4
BOOL = 1


def filter_eval(n: int, k: int) -> tuple:
    """k float32 columns compared with their literals, the k results
    and-ed into one bool a row."""
    return n * (2 * k - 1), n * k * F32 + n * BOOL


def key_lookup(n: int, g: int) -> tuple:
    """n float32 probes searched in a sorted float32 dictionary of g keys:
    a binary search of ceil(log2(g + 1)) comparisons each; an int32
    position out."""
    return n * max(1, math.ceil(math.log2(g + 1))), \
        g * F32 + n * F32 + n * I32


def hash_group(n: int, g: int) -> tuple:
    """n (int32 code, float32 value) rows into g float32 sums and counts:
    one add and one count a row."""
    return 2 * n, n * (I32 + F32) + 2 * g * F32


def hash_group_minmax(n: int, g: int) -> tuple:
    """n (int32 code, float32 value) rows into g float32 minima and
    maxima: two comparisons a row."""
    return 2 * n, n * (I32 + F32) + 2 * g * F32


def hash_partition(n: int, k: int) -> tuple:
    """k float32 key columns hashed into an int32 lane a row: one hash step
    a key and one reduction a row."""
    return n * (k + 1), n * k * F32 + n * I32


def bloom_probe(n: int, words: int, hashes: int) -> tuple:
    """n rows of two uint32 hash halves tested against ``hashes`` bits each
    of a filter of ``words`` uint32 words: an index and a test a probe; a
    bool a row out."""
    return 2 * n * hashes, n * 2 * U32 + words * U32 + n * BOOL


COST = {
    "filter_eval": filter_eval,
    "key_lookup": key_lookup,
    "hash_group": hash_group,
    "hash_group_minmax": hash_group_minmax,
    "hash_partition": hash_partition,
    "bloom_probe": bloom_probe,
}


def bound_s(kernel: str, shape: dict) -> float:
    """The least time one launch could take on the card."""
    ops, nbytes = COST[kernel](**shape)
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)
