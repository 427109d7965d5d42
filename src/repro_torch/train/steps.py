"""Train, prefill and serve steps, and real input batches for every
(arch x shape) cell, in PyTorch.

``make_train_step`` takes AdamW (``train.optimizer``) over the gradients of
the plain forward, with microbatches and remat as in the JAX package.
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
from .optimizer import AdamWState, adamw_update


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 ctx: ShardCtx = NOSHARD) -> torch.Tensor:
    """Mean token cross-entropy; logits (B,S,V) any float dtype, labels
    (B,S)."""
    from torch.distributed.tensor import DTensor

    logits = logits.float()
    if isinstance(logits, DTensor):
        return _xent_vocab_parallel(logits, labels, ctx)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()


def _xent_vocab_parallel(logits: torch.Tensor, labels: torch.Tensor,
                         ctx: ShardCtx) -> torch.Tensor:
    """``softmax_xent`` of DTensor logits whose vocab dim may be split over
    the mesh, as vocab-parallel cross-entropy computes it: each rank reduces
    its own columns and only (B, S) values cross the mesh (DTensor would
    gather the whole logits for ``logsumexp``, and its sharded ``gather``
    masks by the labels' values, which the meta device does not hold).
    The log-sum-exp is logsumexp's own: the max, then the log of the sum of
    exp(x - max); the label's logit is picked by a mask.  The (B, S)
    results are placed by the batch alone, which keeps DTensor from
    splitting the sequence (and so the logits' gradient) over the mesh."""
    spec = (ctx.dp_spec, None)
    m = logits.amax(dim=-1, keepdim=True).detach()
    logz = ctx.constrain(torch.log(torch.exp(logits - m).sum(dim=-1))
                         + m[..., 0], spec)
    vocab = torch.arange(logits.shape[-1], device=labels.device)
    gold = ctx.constrain(torch.where(vocab == labels[..., None], logits,
                                     0.0).sum(dim=-1), spec)
    return (logz - gold).mean()


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------
def make_train_step(cfg: ModelConfig, ctx: ShardCtx = NOSHARD,
                    microbatches: int = 1, remat: bool = True,
                    lr: float = 3e-4):
    """Returns train_step(model, opt_state, batch) -> (model, opt_state,
    {"loss", "grad_norm"}), the parameters and moments updated in place on
    the model's device.

    The loss is ``softmax_xent`` over ``forward(..., use_kernel=False)``:
    the plain scan, as the JAX package trains (the CUDA scan has no
    backward).  With microbatches > 1 the batch is split, and each
    microbatch's gradients (``torch.autograd.grad``, never ``.grad``, which
    would add in the parameters' dtype) are added into float32 buffers and
    divided by ``microbatches``: gradient accumulation, which keeps the
    logits at 1/M of the batch's."""
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")

    def loss_and_grads(model, params, inputs, labels):
        with torch.enable_grad():
            logits = M.forward(model, inputs, use_kernel=False, ctx=ctx,
                               remat=remat)
            loss = softmax_xent(logits, labels, ctx)
            grads = torch.autograd.grad(loss, params, allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), grads

    def train_step(model, opt_state: AdamWState, batch: Dict):
        with ctx.replicating():
            return _train_step(model, opt_state, batch)

    def _train_step(model, opt_state: AdamWState, batch: Dict):
        names, params = zip(*model.named_parameters())
        inputs, labels = batch["inputs"], batch["labels"]
        if microbatches > 1:
            B = inputs.shape[0]
            if B % microbatches:
                raise ValueError(f"batch {B} does not split into "
                                 f"{microbatches} microbatches")
            mb = B // microbatches
            gsum = [torch.zeros_like(p, dtype=torch.float32) for p in params]
            lsum = 0.0
            for i in range(microbatches):
                part = slice(i * mb, (i + 1) * mb)
                loss, grads = loss_and_grads(model, params, inputs[part],
                                             labels[part])
                for acc, g in zip(gsum, grads):
                    acc.add_(g.float())
                lsum = lsum + loss
                del grads
            grads = [g / microbatches for g in gsum]
            loss = lsum / microbatches
        else:
            loss, grads = loss_and_grads(model, params, inputs, labels)
        _, opt_state, gnorm = adamw_update(
            dict(zip(names, grads)), opt_state, dict(zip(names, params)),
            lr=lr)
        return model, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


# ---------------------------------------------------------------------------
# serve (decode) and prefill
# ---------------------------------------------------------------------------
def _greedy(logits: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """The argmax over the vocab of (B, V) logits, int32; on a mesh the
    vocab is gathered first (DTensor's split argmax fails on a batch split
    over two mesh axes)."""
    logits = ctx.constrain(logits, (ctx.dp_spec, None))
    return logits.argmax(dim=-1).to(torch.int32)


def make_serve_step(cfg: ModelConfig, ctx: ShardCtx = NOSHARD):
    """serve_step(model, cache, inputs, pos) -> (next_token, cache): one new
    token per sequence against the cache, greedy."""

    @torch.inference_mode()
    def serve_step(model, cache, inputs, pos):
        with ctx.replicating():
            logits, cache = M.decode_step(model, cache, inputs, pos, ctx)
            return _greedy(logits, ctx), cache

    return serve_step


def make_prefill_step(cfg: ModelConfig, ctx: ShardCtx = NOSHARD,
                      use_kernel: bool = True):
    """prefill_step(model, inputs) -> next token of every sequence: the
    full logits, then the argmax at the last position."""

    @torch.inference_mode()
    def prefill_step(model, inputs):
        with ctx.replicating():
            logits = M.forward(model, inputs, use_kernel=use_kernel, ctx=ctx)
            return _greedy(logits[:, -1], ctx)

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
