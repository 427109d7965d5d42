"""Public wrappers for the grouped-aggregation kernels (registry-dispatched).

The CUDA kernels are in ``csrc/hash_group.cu``; they replace the TPU kernels
``hash_group_pallas`` and ``hash_group_minmax_pallas`` of the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..registry import count_launch, register, register_trip, resolve, trip
from .ref import hash_group_minmax_ref, hash_group_ref

# hash_group_minmax: up to this many rows one block takes the whole call in
# one launch; above it, the three-launch multi-block path
# (csrc/hash_group.cu).  Set from chip_smoke.py's timing of both paths
# around it (PERF.md).
ONE_BLOCK_ROWS = 16384
# groups whose order keys fit the 48 KB of shared memory (2 x 4 bytes each)
SMEM_MAX_GROUPS = 6144


def minmax_path(n: int, num_groups: int) -> str:
    """``one_block`` or ``multi_block``: the kernel path for n rows in
    ``num_groups`` groups."""
    if n <= ONE_BLOCK_ROWS and num_groups <= SMEM_MAX_GROUPS:
        return "one_block"
    return "multi_block"


def _prepare(codes, values, num_groups: int):
    if codes.dim() != 1 or codes.shape != values.shape:
        raise ValueError("codes and values must be 1-D of one length")
    if num_groups < 0:
        raise ValueError(f"num_groups must be >= 0, got {num_groups}")
    return (codes.to(torch.int32).contiguous(),
            values.to(torch.float32).contiguous())


@register("hash_group", "cuda")
def hash_group_cuda(codes, values, num_groups: int):
    """codes: (N,) group codes (-1 = masked); values: (N,) numeric.

    Returns (sums (G,), counts (G,)) float32.  CPU tensors and empty
    inputs take the plain version; CUDA tensors launch the kernel."""
    codes, values = _prepare(codes, values, num_groups)
    n = codes.shape[0]
    if not _build.takes_kernel(codes, values) or n == 0 or num_groups == 0:
        return hash_group_ref(codes, values, num_groups)
    out = torch.empty(2, num_groups, dtype=torch.float32, device=codes.device)
    err = _build.library().hash_group_launch(
        codes.data_ptr(), values.data_ptr(), n, num_groups,
        out[0].data_ptr(), out[1].data_ptr(), _build.stream(out))
    _build.check(err, "hash_group")
    count_launch("hash_group")
    return out[0], out[1]


@register("hash_group_minmax", "cuda")
def hash_group_minmax_cuda(codes, values, num_groups: int):
    """Grouped MIN/MAX: (mins (G,), maxs (G,)) float32; an empty group
    holds +inf / -inf.  CPU tensors and empty inputs take the plain
    version; CUDA tensors launch the kernel."""
    codes, values = _prepare(codes, values, num_groups)
    n = codes.shape[0]
    if not _build.takes_kernel(codes, values) or n == 0 or num_groups == 0:
        return hash_group_minmax_ref(codes, values, num_groups)
    path = minmax_path(n, num_groups)
    out = launch_minmax(codes, values, num_groups, path)
    count_launch("hash_group_minmax")
    count_launch(f"hash_group_minmax.{path}")
    return out[0], out[1]


def launch_minmax(codes, values, num_groups: int, path: str):
    """Launch one path of the MIN/MAX kernel on prepared CUDA tensors;
    returns (2, G) float32.  Counts nothing: the wrapper counts."""
    out = torch.empty(2, num_groups, dtype=torch.float32, device=codes.device)
    err = _build.library().hash_group_minmax_launch(
        codes.data_ptr(), values.data_ptr(), codes.shape[0], num_groups,
        out[0].data_ptr(), out[1].data_ptr(), int(path == "one_block"),
        _build.stream(out))
    _build.check(err, f"hash_group_minmax ({path})")
    return out


def _host_inputs(codes, values, num_groups: int):
    if codes.ndim != 1 or codes.shape != values.shape:
        raise ValueError("codes and values must be 1-D of one length")
    if num_groups < 0:
        raise ValueError(f"num_groups must be >= 0, got {num_groups}")
    return (codes.astype(np.int32, copy=False),
            values.astype(np.float32, copy=False))


def _plain(ref, codes, values, num_groups: int):
    return tuple(t.numpy() for t in ref(torch.from_numpy(codes),
                                        torch.from_numpy(values), num_groups))


def hash_group_trip(device, codes, values, num_groups: int):
    """The executor's call on the card in one trip (registry.trip): numpy
    codes and values in, hash_group_cuda's (sums, counts) as numpy out."""
    codes, values = _host_inputs(codes, values, num_groups)
    n = codes.shape[0]
    if n == 0 or num_groups == 0:
        return _plain(hash_group_ref, codes, values, num_groups)
    sums, counts = trip("hash_group", device, [codes, values],
                        [(np.float32, (num_groups,))] * 2,
                        lambda i, o: (i[0], i[1], n, num_groups, o[0], o[1]))
    count_launch("hash_group")
    return sums, counts


def hash_group_minmax_trip(device, codes, values, num_groups: int):
    """The executor's call on the card in one trip (registry.trip): numpy
    codes and values in, hash_group_minmax_cuda's (mins, maxs) out."""
    codes, values = _host_inputs(codes, values, num_groups)
    n = codes.shape[0]
    if n == 0 or num_groups == 0:
        return _plain(hash_group_minmax_ref, codes, values, num_groups)
    path = minmax_path(n, num_groups)
    mins, maxs = trip("hash_group_minmax", device, [codes, values],
                      [(np.float32, (num_groups,))] * 2,
                      lambda i, o: (i[0], i[1], n, num_groups, o[0], o[1],
                                    int(path == "one_block")))
    count_launch("hash_group_minmax")
    count_launch(f"hash_group_minmax.{path}")
    return mins, maxs


register_trip(hash_group_cuda, hash_group_trip)
register_trip(hash_group_minmax_cuda, hash_group_minmax_trip)
register("hash_group", "ref", hash_group_ref)
register("hash_group_minmax", "ref", hash_group_minmax_ref)


def hash_group(codes, values, num_groups: int, engine: str = "cuda"):
    return resolve("hash_group", engine)(codes, values, num_groups)


def hash_group_minmax(codes, values, num_groups: int, engine: str = "cuda"):
    return resolve("hash_group_minmax", engine)(codes, values, num_groups)
