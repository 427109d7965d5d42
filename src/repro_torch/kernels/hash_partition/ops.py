"""Public wrapper for the shuffle bucket-assignment kernel
(registry-dispatched).

The CUDA kernel is ``csrc/hash_partition.cu``; it replaces the TPU kernel
``hash_partition_pallas`` of the JAX package.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..registry import count_launch, register, resolve
from .ref import hash_partition_ref

MAX_COLS = 8  # the kernel's by-value argument holds this many columns


@register("hash_partition", "cuda")
def hash_partition_cuda(cols, num_partitions: int):
    """cols: K (N,) key columns on one device; returns the (N,) int32 lane
    of each row in ``[0, num_partitions)``.

    CPU tensors and empty inputs take the plain version; CUDA tensors
    launch the kernel and must already be float32, converted where the
    host path converts them: a float64 NaN converted on the card would get
    another payload than numpy gives it, and so another lane."""
    cols = tuple(cols)
    if not cols:
        raise ValueError("hash_partition needs K >= 1 key columns")
    if num_partitions < 1:
        raise ValueError(f"num_partitions must be >= 1, got {num_partitions}")
    n = cols[0].shape[0]
    if any(c.shape != (n,) for c in cols):
        raise ValueError("hash_partition columns must be 1-D of one length")
    if not _build.takes_kernel(*cols) or n == 0:
        return hash_partition_ref(cols, num_partitions)
    k = len(cols)
    if k > MAX_COLS:
        raise ValueError(f"hash_partition kernel takes at most {MAX_COLS} "
                         f"key columns, got {k}")
    if any(c.dtype != torch.float32 for c in cols):
        raise ValueError("hash_partition kernel takes float32 key columns; "
                         "convert on the host as partition_codes does")
    cols = [c.contiguous() for c in cols]
    out = torch.empty(n, dtype=torch.int32, device=cols[0].device)
    err = _build.library().hash_partition_launch(
        (ctypes.c_void_p * k)(*[c.data_ptr() for c in cols]),
        k, n, int(num_partitions), out.data_ptr(), _build.stream(out))
    _build.check(err, "hash_partition")
    count_launch("hash_partition")
    return out


register("hash_partition", "ref", hash_partition_ref)


def hash_partition(cols, num_partitions: int, engine: str = "cuda"):
    """Map rows to shuffle lanes: cols is a tuple of (N,) key columns;
    returns (N,) int32 lane ids in ``[0, num_partitions)``."""
    return resolve("hash_partition", engine)(tuple(cols), num_partitions)
