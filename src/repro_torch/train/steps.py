"""Prefill and serve steps, and real input batches for every (arch x shape)
cell, in PyTorch.

Serving only: ``make_train_step`` and the optimizer wait for ROADMAP A6.
``input_specs`` gives each input's shape and dtype (the cache's from
``init_cache`` on the meta device, which allocates nothing), and
``materialize_batch`` builds real tensors from a ``torch.Generator``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models import model as M
from ..models.layers import NOSHARD, ShardCtx


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy; logits (B,S,V) any float dtype, labels
    (B,S)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()


# ---------------------------------------------------------------------------
# serve (decode) and prefill
# ---------------------------------------------------------------------------
def make_serve_step(cfg: ModelConfig, ctx: ShardCtx = NOSHARD):
    """serve_step(model, cache, inputs, pos) -> (next_token, cache): one new
    token per sequence against the cache, greedy."""

    @torch.inference_mode()
    def serve_step(model, cache, inputs, pos):
        logits, cache = M.decode_step(model, cache, inputs, pos, ctx)
        return logits.argmax(dim=-1).to(torch.int32), cache

    return serve_step


def make_prefill_step(cfg: ModelConfig, ctx: ShardCtx = NOSHARD,
                      use_kernel: bool = True):
    """prefill_step(model, inputs) -> next token of every sequence: the
    full logits, then the argmax at the last position."""

    @torch.inference_mode()
    def prefill_step(model, inputs):
        logits = M.forward(model, inputs, use_kernel=use_kernel, ctx=ctx)
        return logits[:, -1].argmax(dim=-1).to(torch.int32)

    return prefill_step


# ---------------------------------------------------------------------------
# input specs and real batches
# ---------------------------------------------------------------------------
class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _spec(t: torch.Tensor) -> TensorSpec:
    return TensorSpec(tuple(t.shape), t.dtype)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        inputs = (TensorSpec((B, S, cfg.d_model), torch.bfloat16)
                  if cfg.embedding_stub else TensorSpec((B, S), torch.int32))
        if shape.kind == "prefill":
            return {"inputs": inputs}
        return {"batch": {"inputs": inputs,
                          "labels": TensorSpec((B, S), torch.int32)}}
    # decode: one new token with a cache of seq_len
    inputs = (TensorSpec((B, 1, cfg.d_model), torch.bfloat16)
              if cfg.embedding_stub else TensorSpec((B,), torch.int32))
    cache = M.init_cache(cfg, B, S, device="meta")
    return {
        "inputs": inputs,
        "pos": TensorSpec((), torch.int32),
        "cache": [{k: _spec(t) for k, t in c.items()} for c in cache],
    }


def materialize_batch(cfg: ModelConfig, shape: ShapeConfig,
                      generator: torch.Generator, device=None) -> Dict:
    """Random inputs matching ``input_specs``: tokens uniform over the
    vocabulary, other integers 0, floats normal * 0.02; on the card unless
    the caller passes ``device="cpu"`` (``generator`` lies there too)."""
    device = torch.device("cuda" if device is None else device)

    def mk(s):
        if isinstance(s, dict):
            return {k: mk(v) for k, v in s.items()}
        if isinstance(s, list):
            return [mk(v) for v in s]
        if s.dtype == torch.int32 and s.shape and s.shape[-1] != cfg.d_model:
            return torch.randint(0, cfg.vocab_size, s.shape, dtype=torch.int32,
                                 generator=generator, device=device)
        if s.dtype == torch.int32:
            return torch.zeros(s.shape, dtype=torch.int32, device=device)
        x = torch.randn(s.shape, generator=generator, device=device) * 0.02
        return x.to(s.dtype)

    return mk(input_specs(cfg, shape))
