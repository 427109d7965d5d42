"""Public wrappers for the grouped-aggregation kernels (registry-dispatched).

The CUDA kernels are in ``csrc/hash_group.cu``; they replace the TPU kernels
``hash_group_pallas`` and ``hash_group_minmax_pallas`` of the JAX package.
"""
from __future__ import annotations

import torch

from .. import _build
from ..registry import count_launch, register, resolve
from .ref import hash_group_minmax_ref, hash_group_ref


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
    out = torch.empty(2, num_groups, dtype=torch.float32, device=codes.device)
    err = _build.library().hash_group_minmax_launch(
        codes.data_ptr(), values.data_ptr(), n, num_groups,
        out[0].data_ptr(), out[1].data_ptr(), _build.stream(out))
    _build.check(err, "hash_group_minmax")
    count_launch("hash_group_minmax")
    return out[0], out[1]


register("hash_group", "ref", hash_group_ref)
register("hash_group_minmax", "ref", hash_group_minmax_ref)


def hash_group(codes, values, num_groups: int, engine: str = "cuda"):
    return resolve("hash_group", engine)(codes, values, num_groups)


def hash_group_minmax(codes, values, num_groups: int, engine: str = "cuda"):
    return resolve("hash_group_minmax", engine)(codes, values, num_groups)
