"""Public wrapper for the join-key lookup kernel (registry-dispatched).

The CUDA kernel is ``csrc/key_lookup.cu``; it replaces the TPU kernel
``key_lookup_pallas`` of the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..registry import count_launch, register, register_trip, resolve, trip
from .ref import key_lookup_ref


def _aligned(t):
    """``t``, or a copy of it where its data does not start on 16 bytes
    (the kernel stages the dictionary by 16-byte bulk copies)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


@register("key_lookup", "cuda")
def key_lookup_cuda(sorted_vals, probe):
    """sorted_vals: (G,) ascending, no NaN; probe: (N,); both cast to
    float32.  Returns (N,) int32: the exact match's position, or -1.

    CPU tensors and empty inputs take the plain version; CUDA tensors
    launch the kernel."""
    if sorted_vals.dim() != 1 or probe.dim() != 1:
        raise ValueError("key_lookup takes 1-D dictionary and probe")
    g, n = sorted_vals.shape[0], probe.shape[0]
    if not _build.takes_kernel(sorted_vals, probe) or g == 0 or n == 0:
        return key_lookup_ref(sorted_vals, probe)
    svals = _aligned(sorted_vals.to(torch.float32).contiguous())
    p = probe.to(torch.float32).contiguous()
    out = torch.empty(n, dtype=torch.int32, device=p.device)
    err = _build.library().key_lookup_launch(
        svals.data_ptr(), g, p.data_ptr(), n, out.data_ptr(),
        _build.stream(out))
    _build.check(err, "key_lookup")
    count_launch("key_lookup")
    return out


def key_lookup_trip(device, sorted_vals, probe):
    """The executor's call on the card in one trip (registry.trip): the
    dictionary as a float32 tensor on the card (a join's, made once by
    registry.upload) or a numpy array, the probe morsel as numpy; returns
    key_lookup_cuda's positions as a numpy int32 array."""
    probe = np.asarray(probe, dtype=np.float32)
    if isinstance(sorted_vals, np.ndarray):
        sorted_vals = sorted_vals.astype(np.float32, copy=False)
    elif sorted_vals.dtype != torch.float32:
        raise ValueError("key_lookup takes a float32 dictionary tensor")
    if sorted_vals.ndim != 1 or probe.ndim != 1:
        raise ValueError("key_lookup takes 1-D dictionary and probe")
    g, n = sorted_vals.shape[0], probe.shape[0]
    if g == 0 or n == 0:
        return np.full(n, -1, dtype=np.int32)
    (out,) = trip("key_lookup", device, [sorted_vals, probe],
                  [(np.int32, (n,))], lambda i, o: (i[0], g, i[1], n, o[0]),
                  shape={"n": n, "g": g})
    count_launch("key_lookup")
    return out


register_trip(key_lookup_cuda, key_lookup_trip)
register("key_lookup", "ref", key_lookup_ref)


def key_lookup(sorted_vals, probe, engine: str = "cuda"):
    """Map probe values to positions in a sorted dictionary (-1 = miss)."""
    return resolve("key_lookup", engine)(sorted_vals, probe)
