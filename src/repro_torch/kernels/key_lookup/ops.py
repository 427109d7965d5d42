"""Public wrapper for the join-key lookup kernel (registry-dispatched).

The CUDA kernel is ``csrc/key_lookup.cu``; it replaces the TPU kernel
``key_lookup_pallas`` of the JAX package.
"""
from __future__ import annotations

import torch

from .. import _build
from ..registry import count_launch, register, resolve
from .ref import key_lookup_ref


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
    svals = sorted_vals.to(torch.float32).contiguous()
    p = probe.to(torch.float32).contiguous()
    out = torch.empty(n, dtype=torch.int32, device=p.device)
    err = _build.library().key_lookup_launch(
        svals.data_ptr(), g, p.data_ptr(), n, out.data_ptr(),
        _build.stream(out))
    _build.check(err, "key_lookup")
    count_launch("key_lookup")
    return out


register("key_lookup", "ref", key_lookup_ref)


def key_lookup(sorted_vals, probe, engine: str = "cuda"):
    """Map probe values to positions in a sorted dictionary (-1 = miss)."""
    return resolve("key_lookup", engine)(sorted_vals, probe)
