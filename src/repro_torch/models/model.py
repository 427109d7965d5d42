"""Composable decoder-only LM built from a ``ModelConfig``, in PyTorch.

``LM`` holds one module per layer in layer order: the JAX package's scanned
pattern periods are unrolled (period p, position i -> layer p*period + i),
then the unscanned tail.  zamba2's shared attention block is one module,
``LM.shared``, applied at every ``shared_attn`` position.  Parameters keep
the JAX package's names (``embed``, ``lm_head``, ``final_norm``; per block
``ln``/``mamba``, ``ln1``/``ln2``/``attn``/``mlp`` or
``ln1``/``ln2``/``attn``/``moe``), so that ``models.convert`` can carry its
parameter trees across.

``forward`` (train and prefill), ``init_cache`` and ``decode_step`` keep
the JAX names.  ``forward`` records for autograd where grad is enabled (the
train step takes it with ``use_kernel=False`` and ``remat``, whose modes
are the JAX package's); ``decode_step`` and the serving steps run under
``torch.inference_mode()``.  A ``moe`` block's FFN is ``models.moe``'s
capacity-routed ``moe_ffn`` in prefill, decode and training alike.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..launch.sharding import tree_map
from .layers import (NOSHARD, MLP, Attention, ShardCtx, attention,
                     attention_axes, decode_attention, mlp, mlp_axes, param,
                     rms_norm, trunc_normal)
from .mamba2 import (Mamba2, mamba2_axes, mamba2_decode, mamba2_forward,
                     mamba2_init_cache)
from .moe import MoE, moe_axes, moe_ffn

ATTN_KINDS = ("attn", "local", "global")


class SSMBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln = param((cfg.d_model,), torch.float32, device)
        self.mamba = Mamba2(cfg, dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.ln.fill_(1.0)
        self.mamba.reset_parameters(generator)


class AttnBlock(nn.Module):
    """Attention + MLP with pre-norms (also the zamba2 shared block)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = param((cfg.d_model,), torch.float32, device)
        self.ln2 = param((cfg.d_model,), torch.float32, device)
        self.attn = Attention(cfg, dtype, device)
        self.mlp = MLP(cfg, dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.ln1.fill_(1.0)
        self.ln2.fill_(1.0)
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)


class MoEBlock(nn.Module):
    """Attention + capacity-routed MoE FFN with pre-norms."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = param((cfg.d_model,), torch.float32, device)
        self.ln2 = param((cfg.d_model,), torch.float32, device)
        self.attn = Attention(cfg, dtype, device)
        self.moe = MoE(cfg, dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.ln1.fill_(1.0)
        self.ln2.fill_(1.0)
        self.attn.reset_parameters(generator)
        self.moe.reset_parameters(generator)


class SharedSlot(nn.Module):
    """A ``shared_attn`` position: no weights of its own (they are
    ``LM.shared``)."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        pass


def _make_block(kind: str, cfg: ModelConfig, dtype, device) -> nn.Module:
    if kind == "ssm":
        return SSMBlock(cfg, dtype, device)
    if kind == "shared_attn":
        return SharedSlot()
    if kind in ATTN_KINDS:
        return AttnBlock(cfg, dtype, device)
    if kind == "moe":
        return MoEBlock(cfg, dtype, device)
    raise ValueError(f"unknown block kind {kind!r}")


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """Block kinds in layer order: the periods unrolled, then the tail."""
    return list(cfg.layer_pattern) * cfg.num_periods + list(cfg.tail_pattern)


class LM(nn.Module):
    """Parameters of a decoder-only LM, uninitialised until
    ``reset_parameters`` (see ``init_params``) or ``models.convert``."""

    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.cfg = cfg
        self.kinds = layer_kinds(cfg)
        d = cfg.d_model
        self.embed = (None if cfg.embedding_stub
                      else param((cfg.vocab_size, d), dtype, device))
        self.lm_head = (param((d, cfg.vocab_size), dtype, device)
                        if not cfg.tie_embeddings or cfg.embedding_stub
                        else None)
        self.layers = nn.ModuleList(
            _make_block(kind, cfg, dtype, device) for kind in self.kinds)
        self.shared = (AttnBlock(cfg, dtype, device)
                       if cfg.shared_attention else None)
        self.final_norm = param((d,), torch.float32, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for name in ("embed", "lm_head"):
            w = getattr(self, name)
            if w is not None:
                w.copy_(trunc_normal(generator, w.shape, 1.0, w.dtype,
                                     w.device))
        for block in self.layers:
            block.reset_parameters(generator)
        if self.shared is not None:
            self.shared.reset_parameters(generator)
        self.final_norm.fill_(1.0)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device=None) -> LM:
    """A model with random weights drawn from ``generator``, which must lie
    on ``device`` (the card unless the caller passes ``device="cpu"``)."""
    device = torch.device("cuda" if device is None else device)
    model = LM(cfg, dtype, device)
    model.reset_parameters(generator)
    return model


# ===========================================================================
# sharding preferences (the JAX package's axes trees)
# ===========================================================================
def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(y, (str, type(None))) for y in x)


def _block_axes(kind: str, cfg: ModelConfig):
    if kind == "ssm":
        return {"ln": (None,), "mamba": mamba2_axes(cfg)}
    if kind == "shared_attn":
        return {}
    a = {"ln1": (None,), "ln2": (None,), "attn": attention_axes(cfg)}
    if kind == "moe":
        a["moe"] = moe_axes(cfg)
    else:
        a["mlp"] = mlp_axes(cfg)
    return a


def param_axes(cfg: ModelConfig) -> Dict:
    """Preferred mesh axes of the JAX package's parameter tree (its scanned
    periods stacked on a leading axis); equal to its ``param_axes``."""
    axes: Dict = {}
    if not cfg.embedding_stub:
        axes["embed"] = ("model", "data")
    if not cfg.tie_embeddings or cfg.embedding_stub:
        axes["lm_head"] = ("data", "model")
    period_axes = tuple(_block_axes(kind, cfg) for kind in cfg.layer_pattern)
    # scanned leaves gain a leading (periods) dim -> prepend None
    axes["scan"] = tree_map(lambda a: (None,) + tuple(a), period_axes,
                            is_leaf=_is_axes)
    axes["tail"] = tuple(_block_axes(kind, cfg) for kind in cfg.tail_pattern)
    if cfg.shared_attention:
        axes["shared"] = {
            "ln1": (None,), "ln2": (None,),
            "attn": attention_axes(cfg), "mlp": mlp_axes(cfg),
        }
    axes["final_norm"] = (None,)
    return axes


def named_param_axes(cfg: ModelConfig) -> Dict[str, Tuple]:
    """:func:`param_axes` by the ``LM``'s parameter names: the layer of
    period p at pattern position i takes its scanned leaf's axes without
    the period axis."""
    out: Dict[str, Tuple] = {}

    def walk(tree, prefix: str) -> None:
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                out[prefix + k] = v

    walk({k: _block_axes(kind, cfg) for k, kind in
          enumerate(layer_kinds(cfg))}, "layers.")
    axes = param_axes(cfg)
    walk({k: axes[k] for k in ("embed", "lm_head", "final_norm", "shared")
          if k in axes}, "")
    return out


def cache_axes(cfg: ModelConfig, batch: int, dp_over_seq: bool) -> Dict:
    """Sharding prefs for the JAX package's cache tree: batch on data when
    it divides, else the sequence dim (long_500k, batch=1); kv-heads on
    model when divisible.  Equal to its ``cache_axes``."""

    def attn_axes():
        if dp_over_seq:
            return {"k": (None, "data", "model", None),
                    "v": (None, "data", "model", None)}
        return {"k": ("data", None, "model", None),
                "v": ("data", None, "model", None)}

    def block_axes(kind):
        if kind == "ssm":
            return {"conv": ("data", "model", None),
                    "ssd": ("data", "model", None, None)}
        return attn_axes()

    per = tuple(block_axes(k) for k in cfg.layer_pattern)
    return {
        "scan": tree_map(lambda a: (None,) + tuple(a), per, is_leaf=_is_axes),
        "tail": tuple(block_axes(k) for k in cfg.tail_pattern),
    }


# ===========================================================================
# forward (train / prefill)
# ===========================================================================
def _embed(model: LM, tokens: torch.Tensor,
           ctx: ShardCtx = NOSHARD) -> torch.Tensor:
    cfg = model.cfg
    if cfg.embedding_stub:
        return tokens.to(torch.bfloat16)
    # on a mesh the table is gathered for the lookup: DTensor's lookup in a
    # split vocab masks by the tokens' values, which the meta device lacks
    h = F.embedding(tokens, ctx.constrain(model.embed, (None, None)))
    if cfg.scale_embeddings:
        h = h.float() * float(np.float32(np.sqrt(cfg.d_model)))
    return h.to(torch.bfloat16)


def _mlp_part(bp: nn.Module, h, cfg: ModelConfig, ctx: ShardCtx):
    ff_in = rms_norm(h, bp.ln2, plus_one=cfg.scale_embeddings)
    if isinstance(bp, MoEBlock):
        return h + moe_ffn(bp.moe, ff_in, cfg, ctx)
    return h + mlp(bp.mlp, ff_in, cfg, ctx)


def _apply_block(kind: str, bp: nn.Module, shared: Optional[AttnBlock], h,
                 cfg: ModelConfig, ctx: ShardCtx, use_kernel: bool):
    if kind == "ssm":
        return h + mamba2_forward(bp.mamba, rms_norm(h, bp.ln), cfg, ctx,
                                  use_kernel=use_kernel)
    if kind == "shared_attn":
        bp = shared
    window = cfg.sliding_window if kind == "local" else None
    a = attention(bp.attn, rms_norm(h, bp.ln1, plus_one=cfg.scale_embeddings),
                  cfg, ctx, sliding_window=window)
    return _mlp_part(bp, h + a, cfg, ctx)


def _logits(model: LM, h: torch.Tensor,
            ctx: ShardCtx = NOSHARD) -> torch.Tensor:
    cfg = model.cfg
    h = rms_norm(h, model.final_norm, plus_one=cfg.scale_embeddings)
    if cfg.tie_embeddings and not cfg.embedding_stub:
        return h @ ctx.gathered(model.embed).T
    return h @ ctx.gathered(model.lm_head)


# Rematerialisation, as in the JAX package (its scan over periods unrolled):
#   'per_period' - each period's layers under torch.utils.checkpoint: the
#                  backward keeps one activation per period and recomputes
#                  the period's insides
#   'sqrt'       - groups of SQRT_GROUP periods checkpointed, each running
#                  its periods checkpointed (sqrt(L) checkpointing); only
#                  where num_periods is a multiple of SQRT_GROUP above it,
#                  else 'per_period'
_REMAT_MODE = "per_period"
SQRT_GROUP = 8


def set_remat_mode(name: str) -> None:
    global _REMAT_MODE
    if name not in ("per_period", "sqrt"):
        raise ValueError(f"remat mode must be 'per_period' or 'sqrt', got "
                         f"{name!r}")
    _REMAT_MODE = name


def _checkpointed(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)


def forward(model: LM, inputs: torch.Tensor, use_kernel: bool = True,
            ctx: ShardCtx = NOSHARD, remat: bool = False) -> torch.Tensor:
    """inputs: (B, S) int tokens, or (B, S, D) embeddings (stub) -> logits
    (B, S, V).  ``use_kernel`` sends every Mamba2 scan through the
    registry's ``ssd_scan`` (the CUDA kernel on the card, which refuses to
    run where autograd records: training passes ``use_kernel=False``).
    ``remat`` checkpoints the periods by the mode ``set_remat_mode`` set;
    the tail runs without.  zamba2's shared block gets the gradient of
    every position it is applied at, summed.  With DTensor parameters,
    call it inside ``ctx.replicating()`` (the steps do)."""
    cfg = model.cfg
    period, periods = cfg.pattern_period, cfg.num_periods

    def layers(h, start: int, stop: int):
        for i in range(start, stop):
            h = _apply_block(model.kinds[i], model.layers[i], model.shared, h,
                             cfg, ctx, use_kernel)
        return h

    def one_period(h, p: int):
        h = layers(h, p * period, (p + 1) * period)
        return ctx.constrain(h, (ctx.dp_spec, None, None))

    def periods_of(h, first: int, count: int):
        for p in range(first, first + count):
            h = _checkpointed(one_period, h, p)
        return h

    h = ctx.constrain(_embed(model, inputs, ctx), (ctx.dp_spec, None, None))
    group = SQRT_GROUP
    if not remat:
        for p in range(periods):
            h = one_period(h, p)
    elif _REMAT_MODE == "sqrt" and periods % group == 0 and periods > group:
        for g in range(0, periods, group):
            h = _checkpointed(periods_of, h, g, group)
    else:
        h = periods_of(h, 0, periods)
    h = layers(h, periods * period, len(model.layers))
    return ctx.constrain(_logits(model, h, ctx), (ctx.dp_spec, None, ctx.tp))


# ===========================================================================
# decode (serve_step)
# ===========================================================================
def _cache_len(kind: str, cfg: ModelConfig, max_seq: int) -> int:
    if kind == "local" and cfg.sliding_window is not None:
        return min(cfg.sliding_window, max_seq)
    return max_seq


def _init_block_cache(kind: str, cfg: ModelConfig, batch: int, max_seq: int,
                      device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    if kind == "ssm":
        return mamba2_init_cache(cfg, batch, device)
    shape = (batch, _cache_len(kind, cfg, max_seq), cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> List[Dict[str, torch.Tensor]]:
    """One cache per layer, in layer order (every shared_attn position has
    its own KV cache, as in the JAX package)."""
    device = torch.device("cuda" if device is None else device)
    return [_init_block_cache(kind, cfg, batch, max_seq, device)
            for kind in layer_kinds(cfg)]


def _decode_block(kind: str, bp: nn.Module, shared: Optional[AttnBlock], h,
                  cache, pos: int, cfg: ModelConfig, ctx: ShardCtx):
    if kind == "ssm":
        out, _ = mamba2_decode(bp.mamba, rms_norm(h, bp.ln), cache, cfg, ctx)
        return h + out
    if kind == "shared_attn":
        bp = shared
    window = cfg.sliding_window if kind == "local" else None
    a, cache["k"], cache["v"] = decode_attention(
        bp.attn, rms_norm(h, bp.ln1, plus_one=cfg.scale_embeddings),
        cache["k"], cache["v"], pos, cfg, ctx, sliding_window=window)
    return _mlp_part(bp, h + a, cfg, ctx)


@torch.inference_mode()
def decode_step(model: LM, cache: List[Dict[str, torch.Tensor]],
                inputs: torch.Tensor, pos: int,
                ctx: ShardCtx = NOSHARD
                ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """inputs: (B,) int tokens, or (B, 1, D) embeddings (stub); pos: the
    position being written.  Updates ``cache`` in place (the JAX package
    returns a new one) and returns (logits (B, V), cache)."""
    cfg = model.cfg
    pos = int(pos)
    h = _embed(model, inputs if cfg.embedding_stub else inputs[:, None], ctx)
    for kind, bp, cs in zip(model.kinds, model.layers, cache):
        h = _decode_block(kind, bp, model.shared, h, cs, pos, cfg, ctx)
    return _logits(model, h, ctx)[:, 0], cache
