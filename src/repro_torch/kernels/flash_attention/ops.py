"""Public wrapper for flash attention (registry-dispatched).

Three hand-written CUDA kernels replace the TPU kernel
``flash_attention_pallas`` of the JAX package; :func:`route` picks one by
dtype and head dim:

* ``wgmma``: ``csrc/flash_attention_wgmma.cu``, bfloat16 on the tensor
  cores, for d a multiple of 16 up to 128;
* ``tf32x3``: ``csrc/flash_attention_tf32.cu``, float32 on the tensor
  cores, each product as three TF32 products (lo*hi + hi*lo + hi*hi of
  each operand split into hi + lo, which keeps the float32 tolerance; one
  TF32 product would not), for d a multiple of 8 up to 128;
* ``simt``: ``csrc/flash_attention.cu``, float32 arithmetic on the CUDA
  cores, for the other head dims, in either dtype.

Each launch adds one to ``flash_attention`` and to
``flash_attention.<route>``.  As in the JAX package, no model path calls
it: this is its own entry point.
"""
from __future__ import annotations

import math

import torch

from .. import _build
from ..registry import count_launch, refuse_autograd, register, resolve
from .ref import attention_ref

MAX_HEAD_DIM = 256  # the q, k and v tiles of 64 rows fit shared memory
WGMMA_MAX_HEAD_DIM = 128  # the tensor-core kernels' widest tiles
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel that takes (dtype, head dim d) on the card: ``wgmma``
    for bfloat16 with d a multiple of 16 up to 128, ``tf32x3`` for
    float32 with d a multiple of 8 up to 128, else ``simt``."""
    if 0 < d <= WGMMA_MAX_HEAD_DIM:
        if dtype == torch.bfloat16 and d % 16 == 0:
            return "wgmma"
        if dtype == torch.float32 and d % 8 == 0:
            return "tf32x3"
    return "simt"


@register("flash_attention", "cuda")
def flash_attention_cuda(q, k, v, causal: bool = True, block_q: int = 128,
                         block_k: int = 128):
    """q/k/v: (B, H, S, d), one dtype -> (B, H, S, d) in that dtype.
    ``block_q``/``block_k`` are the JAX kernel's tiles: kept for the API
    and its check that they divide S (the CUDA kernels pick their own).

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    and raise where autograd records (the kernel has no backward)."""
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
    refuse_autograd("flash_attention", "kernels.flash_attention.ref."
                    "attention_ref", q, k, v)
    if d > MAX_HEAD_DIM or q.dtype not in DTYPES:
        raise ValueError(f"flash_attention kernel takes d <= {MAX_HEAD_DIM} "
                         f"in float32 or bfloat16; got d={d}, "
                         f"{q.dtype}")
    kind = route(q.dtype, d)
    out = launch_route(q, k, v, causal, kind)
    count_launch("flash_attention")
    count_launch(f"flash_attention.{kind}")
    return out


def launch_route(q, k, v, causal: bool, kind: str):
    """Launch one route's kernel (``wgmma``, ``tf32x3`` or ``simt``) on
    checked CUDA tensors (B, H, S, d); returns the output.  Counts nothing:
    the wrapper counts."""
    B, H, S, d = q.shape
    # contiguous, and 16-byte aligned for the kernels' vector loads
    q, k, v = (t.contiguous() for t in (q, k, v))
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H,
            S, d, 1.0 / math.sqrt(d), int(causal))
    lib = _build.library()
    if kind == "wgmma":
        err = lib.flash_attention_wgmma_launch(*args, _build.stream(out))
    elif kind == "tf32x3":
        err = lib.flash_attention_tf32_launch(*args, _build.stream(out))
    else:
        err = lib.flash_attention_launch(*args, DTYPES[q.dtype],
                                         _build.stream(out))
    _build.check(err, f"flash_attention ({kind})")
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
