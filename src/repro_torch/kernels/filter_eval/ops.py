"""Public wrapper for the vectorized filter kernel (registry-dispatched).

The CUDA kernel is ``csrc/filter_eval.cu``; it replaces the TPU kernel
``filter_eval_pallas`` of the JAX package.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..registry import count_launch, register, resolve
from .ref import filter_eval_ref

MAX_COLS = 8  # the kernel's by-value argument holds this many columns


@register("filter_eval", "cuda")
def filter_eval_cuda(columns, ops: tuple, lits: tuple):
    """columns: K (N,) numeric tensors on one device; ops/lits: K op codes
    (0 '<', 1 '<=', 2 '>', 3 '>=', 4 '==', 5 '!=') and K literals.

    Returns the (N,) bool mask of the conjunction, compared in float32.
    CPU tensors and empty inputs take the plain version; CUDA tensors
    launch the kernel."""
    columns = list(columns)
    if not columns or not len(columns) == len(ops) == len(lits):
        raise ValueError("filter_eval needs K >= 1 columns, ops and lits")
    n = columns[0].shape[0]
    if any(c.shape != (n,) for c in columns):
        raise ValueError("filter_eval columns must be 1-D of one length")
    if not _build.takes_kernel(*columns) or n == 0:
        return filter_eval_ref(columns, ops, lits)
    k = len(columns)
    if k > MAX_COLS:
        raise ValueError(f"filter_eval kernel takes at most {MAX_COLS} "
                         f"columns, got {k}")
    if any(op not in range(6) for op in ops):
        raise ValueError(f"unknown filter op code in {ops}")
    cols = [c.to(torch.float32).contiguous() for c in columns]
    out = torch.empty(n, dtype=torch.bool, device=cols[0].device)
    err = _build.library().filter_eval_launch(
        (ctypes.c_void_p * k)(*[c.data_ptr() for c in cols]),
        (ctypes.c_int * k)(*[int(op) for op in ops]),
        (ctypes.c_float * k)(*[float(lit) for lit in lits]),
        k, n, out.data_ptr(), _build.stream(out))
    _build.check(err, "filter_eval")
    count_launch("filter_eval")
    return out


register("filter_eval", "ref", filter_eval_ref)


def filter_eval(columns, ops: tuple, lits: tuple, engine: str = "cuda"):
    return resolve("filter_eval", engine)(columns, ops, lits)
