"""Public wrapper for the vectorized filter kernel (registry-dispatched).

The CUDA kernel is ``csrc/filter_eval.cu``; it replaces the TPU kernel
``filter_eval_pallas`` of the JAX package.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..registry import count_launch, register, register_trip, resolve, trip
from .ref import filter_eval_ref

MAX_COLS = 8  # the kernel's by-value argument holds this many columns


def _check(columns, ops, lits) -> int:
    """The rows of the columns, checked as the wrapper and the trip take
    them."""
    if not columns or not len(columns) == len(ops) == len(lits):
        raise ValueError("filter_eval needs K >= 1 columns, ops and lits")
    n = columns[0].shape[0]
    if any(c.shape != (n,) for c in columns):
        raise ValueError("filter_eval columns must be 1-D of one length")
    return n


@register("filter_eval", "cuda")
def filter_eval_cuda(columns, ops: tuple, lits: tuple):
    """columns: K (N,) numeric tensors on one device; ops/lits: K op codes
    (0 '<', 1 '<=', 2 '>', 3 '>=', 4 '==', 5 '!=') and K literals.

    Returns the (N,) bool mask of the conjunction, compared in float32.
    CPU tensors and empty inputs take the plain version; CUDA tensors
    launch the kernel."""
    columns = list(columns)
    n = _check(columns, ops, lits)
    if not _build.takes_kernel(*columns) or n == 0:
        return filter_eval_ref(columns, ops, lits)
    cols = [c.to(torch.float32).contiguous() for c in columns]
    ptrs = [c.data_ptr() for c in cols]
    out = mask_buffer(n, column_head(ptrs), cols[0].device)
    err = _build.library().filter_eval_launch(
        *_launch_args(ptrs, ops, lits), n, out.data_ptr(),
        vector_head(ptrs, out.data_ptr()), _build.stream(out))
    _build.check(err, "filter_eval")
    count_launch("filter_eval")
    return out


def _launch_args(col_ptrs, ops, lits) -> tuple:
    """filter_eval_launch's host arrays of column pointers, op codes and
    literals, and K."""
    k = len(col_ptrs)
    if k > MAX_COLS:
        raise ValueError(f"filter_eval kernel takes at most {MAX_COLS} "
                         f"columns, got {k}")
    if any(op not in range(6) for op in ops):
        raise ValueError(f"unknown filter op code in {ops}")
    return ((ctypes.c_void_p * k)(*col_ptrs),
            (ctypes.c_int * k)(*[int(op) for op in ops]),
            (ctypes.c_float * k)(*[float(lit) for lit in lits]), k)


def mask_buffer(n: int, head: int, device) -> torch.Tensor:
    """An (n,) bool tensor whose byte at row ``head`` lies on a 4-byte
    boundary (torch's allocations start on one), for the kernel's 4-byte
    stores from there on."""
    pad = -head % 4 if head > 0 else 0
    return torch.empty(n + pad, dtype=torch.bool, device=device)[pad:]


def column_head(col_ptrs) -> int:
    """Rows before the columns' first 16-byte boundary (0-3) when every
    column is at the same phase; -1 when not."""
    phases = {p % 16 for p in col_ptrs}
    if len(phases) != 1 or next(iter(phases)) % 4:
        return -1
    return (16 - phases.pop()) % 16 // 4


def vector_head(col_ptrs, out_ptr: int) -> int:
    """The kernel's ``head``: the rows it takes one by one before its body
    of four rows a thread (one 16-byte load per column, one 4-byte store),
    which starts where every column lies on a 16-byte boundary and the
    mask on a 4-byte one; -1 when there is no such row, and the kernel
    takes every row one by one.  The rows after the body's last whole four
    (and all of them, when fewer than four follow the head) are taken one
    by one too."""
    head = column_head(col_ptrs)
    return head if head >= 0 and (out_ptr + head) % 4 == 0 else -1


def filter_eval_trip(device, columns, ops: tuple, lits: tuple):
    """The executor's call on the card in one trip (registry.trip): numpy
    columns in (cast to float32 here, as the wrapper casts them on the
    card), filter_eval_cuda's mask as a numpy bool array out."""
    cols = [c.astype(np.float32, copy=False) for c in columns]
    n = _check(cols, ops, lits)
    if n == 0:
        return np.zeros(0, dtype=bool)
    (out,) = trip("filter_eval", device, cols, [(np.bool_, (n,))],
                  lambda i, o: (*_launch_args(i, ops, lits), n, o[0],
                                vector_head(i, o[0])),
                  shape={"n": n, "k": len(cols)})
    count_launch("filter_eval")
    return out


register_trip(filter_eval_cuda, filter_eval_trip)


register("filter_eval", "ref", filter_eval_ref)


def filter_eval(columns, ops: tuple, lits: tuple, engine: str = "cuda"):
    return resolve("filter_eval", engine)(columns, ops, lits)
