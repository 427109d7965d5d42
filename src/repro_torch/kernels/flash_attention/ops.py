"""Public wrapper for flash attention (registry-dispatched).

The CUDA kernel is ``csrc/flash_attention.cu``; it replaces the TPU kernel
``flash_attention_pallas`` of the JAX package.  As there, no model path
calls it: this is its own entry point.
"""
from __future__ import annotations

import math

import torch

from .. import _build
from ..registry import count_launch, register, resolve
from .ref import attention_ref

MAX_HEAD_DIM = 256  # the q, k and v tiles of 64 rows fit shared memory
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@register("flash_attention", "cuda")
def flash_attention_cuda(q, k, v, causal: bool = True, block_q: int = 128,
                         block_k: int = 128):
    """q/k/v: (B, H, S, d), one dtype -> (B, H, S, d) in that dtype.
    ``block_q``/``block_k`` are the JAX kernel's tiles: kept for the API
    and its check that they divide S (the CUDA kernel tiles by 64 itself).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v must be (B, H, S, d) of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one dtype")
    B, H, S, d = q.shape
    bq, bk = min(block_q, S), min(block_k, S)
    if S and (bq < 1 or bk < 1 or S % bq or S % bk):
        raise ValueError(f"S={S} must be a multiple of block_q={bq} and "
                         f"block_k={bk}")
    if not _build.takes_kernel(q, k, v):
        return attention_ref(q, k, v, causal=causal)
    if q.numel() == 0:
        return torch.empty_like(q)
    if d > MAX_HEAD_DIM or q.dtype not in DTYPES:
        raise ValueError(f"flash_attention kernel takes d <= {MAX_HEAD_DIM} "
                         f"in float32 or bfloat16; got d={d}, "
                         f"{q.dtype}")
    q, k, v = (t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q)
    err = _build.library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H, S, d,
        1.0 / math.sqrt(d), int(causal), DTYPES[q.dtype], _build.stream(out))
    _build.check(err, "flash_attention")
    count_launch("flash_attention")
    return out


@register("flash_attention", "ref")
def _flash_attention_ref(q, k, v, causal: bool = True, block_q: int = 128,
                         block_k: int = 128):
    del block_q, block_k  # the exact oracle has no tiling
    return attention_ref(q, k, v, causal=causal)


def flash_attention(q, k, v, causal: bool = True, block_q: int = 128,
                    block_k: int = 128, engine: str = "cuda"):
    return resolve("flash_attention", engine)(
        q, k, v, causal=causal, block_q=block_q, block_k=block_k)
