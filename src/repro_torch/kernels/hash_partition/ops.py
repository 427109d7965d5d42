"""Public wrapper for the shuffle bucket-assignment kernel
(registry-dispatched).

The CUDA kernel is ``csrc/hash_partition.cu``; it replaces the TPU kernel
``hash_partition_pallas`` of the JAX package.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..registry import count_launch, register, register_trip, resolve, trip
from .ref import hash_partition_ref

MAX_COLS = 8  # the kernel's by-value argument holds this many columns


def _check(cols, num_partitions: int) -> int:
    """The rows of the key columns, checked as the wrapper and the trip
    take them."""
    if not cols:
        raise ValueError("hash_partition needs K >= 1 key columns")
    if num_partitions < 1:
        raise ValueError(f"num_partitions must be >= 1, got {num_partitions}")
    n = cols[0].shape[0]
    if any(c.shape != (n,) for c in cols):
        raise ValueError("hash_partition columns must be 1-D of one length")
    return n


def _check_kernel(cols, float32) -> int:
    """K, checked as the kernel takes it, with columns of ``float32``."""
    k = len(cols)
    if k > MAX_COLS:
        raise ValueError(f"hash_partition kernel takes at most {MAX_COLS} "
                         f"key columns, got {k}")
    if any(c.dtype != float32 for c in cols):
        raise ValueError("hash_partition kernel takes float32 key columns; "
                         "convert on the host as partition_codes does")
    return k


@register("hash_partition", "cuda")
def hash_partition_cuda(cols, num_partitions: int):
    """cols: K (N,) key columns on one device; returns the (N,) int32 lane
    of each row in ``[0, num_partitions)``.

    CPU tensors and empty inputs take the plain version; CUDA tensors
    launch the kernel and must already be float32, converted where the
    host path converts them: a float64 NaN converted on the card would get
    another payload than numpy gives it, and so another lane."""
    cols = tuple(cols)
    n = _check(cols, num_partitions)
    if not _build.takes_kernel(*cols) or n == 0:
        return hash_partition_ref(cols, num_partitions)
    k = _check_kernel(cols, torch.float32)
    cols = [c.contiguous() for c in cols]
    out = torch.empty(n, dtype=torch.int32, device=cols[0].device)
    err = _build.library().hash_partition_launch(
        (ctypes.c_void_p * k)(*[c.data_ptr() for c in cols]),
        k, n, int(num_partitions), out.data_ptr(), _build.stream(out))
    _build.check(err, "hash_partition")
    count_launch("hash_partition")
    return out


def hash_partition_trip(device, cols, num_partitions: int):
    """The executor's call on the card in one trip (registry.trip): float32
    numpy key columns in (converted on the host, as for the wrapper),
    hash_partition_cuda's lanes as a numpy int32 array out."""
    cols = tuple(cols)
    n = _check(cols, num_partitions)
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    k = _check_kernel(cols, np.float32)
    (out,) = trip("hash_partition", device, list(cols), [(np.int32, (n,))],
                  lambda i, o: ((ctypes.c_void_p * k)(*i), k, n,
                                int(num_partitions), o[0]),
                  shape={"n": n, "k": k})
    count_launch("hash_partition")
    return out


register_trip(hash_partition_cuda, hash_partition_trip)
register("hash_partition", "ref", hash_partition_ref)


def hash_partition(cols, num_partitions: int, engine: str = "cuda"):
    """Map rows to shuffle lanes: cols is a tuple of (N,) key columns;
    returns (N,) int32 lane ids in ``[0, num_partitions)``."""
    return resolve("hash_partition", engine)(tuple(cols), num_partitions)
