"""Public wrapper for the SSD chunk-scan kernel (registry-dispatched).

The CUDA kernel is ``csrc/ssd_scan.cu``; it replaces the TPU kernel
``ssd_scan_pallas`` of the JAX package.
"""
from __future__ import annotations

import torch

from .. import _build
from ..registry import count_launch, register, resolve
from .ref import ssd_scan_ref

MAX_HEAD_DIM = 64   # P: the kernel's output tile is 64 columns wide
MAX_STATE = 128     # N: the state and two (N, 64) tiles fit shared memory
MAX_CHUNK = 1024    # Q: the chunk's cumulative decays sit in shared memory
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@register("ssd_scan", "cuda")
def ssd_scan_cuda(x, dA, Bm, Cm, chunk: int = 256):
    """x: (B, S, H, P) dt-scaled input; dA: (B, S, H) log decays; Bm/Cm:
    (B, S, N), shared by the heads.  Returns (y, None): y (B, S, H, P)
    float32 with zero initial state, as ``ssd_reference`` gives it.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which reads the inputs in their one dtype (float32 or bfloat16) and
    computes in float32."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    if dA.shape != (b, s, h) or Bm.shape != (b, s, n) or Cm.shape != (b, s, n):
        raise ValueError("ssd_scan shapes: x (B,S,H,P), dA (B,S,H), "
                         f"Bm/Cm (B,S,N); got {tuple(x.shape)}, "
                         f"{tuple(dA.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    if x.numel() == 0 or n == 0:
        return torch.zeros(x.shape, dtype=torch.float32, device=x.device), None
    q = min(chunk, s)
    if q < 1 or s % q:
        raise ValueError(f"seq {s} % chunk {q} != 0")
    if not _build.takes_kernel(x, dA, Bm, Cm):
        return ssd_scan_ref(x, dA, Bm, Cm, chunk), None
    if p > MAX_HEAD_DIM or n > MAX_STATE or q > MAX_CHUNK:
        raise ValueError(f"ssd_scan kernel takes P <= {MAX_HEAD_DIM}, "
                         f"N <= {MAX_STATE} and chunk <= {MAX_CHUNK}; got "
                         f"P={p}, N={n}, chunk={q}")
    dtype = x.dtype
    if dtype not in DTYPES or any(t.dtype != dtype for t in (dA, Bm, Cm)):
        raise ValueError("ssd_scan kernel takes inputs of one dtype, float32 "
                         f"or bfloat16; got {x.dtype}, {dA.dtype}, "
                         f"{Bm.dtype}, {Cm.dtype}")
    x, dA, Bm, Cm = (t.contiguous() for t in (x, dA, Bm, Cm))
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    err = _build.library().ssd_scan_launch(
        x.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        y.data_ptr(), b, s, h, p, n, q, DTYPES[dtype], _build.stream(y))
    _build.check(err, "ssd_scan")
    count_launch("ssd_scan")
    return y, None


@register("ssd_scan", "ref")
def _ssd_scan_ref(x, dA, Bm, Cm, chunk: int = 256):
    return ssd_scan_ref(x, dA, Bm, Cm, chunk), None


def ssd_scan(x, dA, Bm, Cm, chunk: int = 256, engine: str = "cuda"):
    """Mamba2 SSD scan; returns (y, None) mirroring ssd_reference's API."""
    return resolve("ssd_scan", engine)(x, dA, Bm, Cm, chunk)
