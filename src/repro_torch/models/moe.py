"""Mixture-of-Experts FFN with capacity routing, in PyTorch.

The JAX package's design, kept: each token picks its top-k experts; each
(token, slot) gets a position in its expert's fixed-capacity buffer, by
the count of earlier slots (token-major) that picked the same expert; the
slots past capacity are dropped; the kept ones are written into an
(E, C, D) buffer, the expert FFNs run as three batched products, and a
gated combine restores token order.  The JAX package computes all of it
outside any Pallas kernel, so the products are ``torch.bmm``.

The expert weights are drawn by ``trunc_normal`` with fan_in = shape[0],
the expert count, as the JAX package's ``init_moe`` draws them (ROADMAP
C8): olmoe's experts have std 1/8, not 1/sqrt(d_model).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..configs.base import ModelConfig
from .layers import NOSHARD, ShardCtx, _act, param, trunc_normal


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        m = cfg.moe
        d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
        self.router = param((d, e), torch.float32, device)
        self.w_gate = param((e, d, f), dtype, device)
        self.w_up = param((e, d, f), dtype, device)
        self.w_down = param((e, f, d), dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for name in ("router", "w_gate", "w_up", "w_down"):
            w = getattr(self, name)
            w.copy_(trunc_normal(generator, w.shape, 1.0, w.dtype, w.device))


def init_moe(cfg: ModelConfig, generator: torch.Generator,
             dtype=torch.bfloat16, device=None) -> MoE:
    p = MoE(cfg, dtype, device)
    p.reset_parameters(generator)
    return p


def moe_axes(cfg: ModelConfig):
    # preferred: experts on 'model'; the resolver drops axes that don't
    # divide, falling back to the later dims' ('data','model') spec.
    return {
        "router": (None, None),
        "w_gate": ("model", "data", None) if _experts_shardable(cfg) else (None, "data", "model"),
        "w_up": ("model", "data", None) if _experts_shardable(cfg) else (None, "data", "model"),
        "w_down": ("model", None, "data") if _experts_shardable(cfg) else (None, "model", "data"),
    }


def _experts_shardable(cfg: ModelConfig) -> bool:
    return cfg.moe is not None and cfg.moe.num_experts >= 16


class _Logistic(torch.autograd.Function):
    """``lax.logistic`` as XLA computes it in bfloat16 on the CPU, 1 / (1 +
    exp(-x)) with each op rounded to the input's dtype, and its JAX
    derivative g * (s * (1 - s)), rounded the same way."""

    @staticmethod
    def forward(ctx, x):
        s = torch.reciprocal(1 + torch.exp(-x))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (1 - s))


def _silu_rounded(t: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``, x * logistic(x), op for op (torch's fused silu rounds
    once): the router's top-k turns on roundings upstream of it, so the
    experts follow the JAX package exactly."""
    return t * _Logistic.apply(t)


def _expert_act(cfg: ModelConfig):
    return _silu_rounded if cfg.act == "silu" else _act(cfg)


def capacity(tokens: int, top_k: int, num_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert for a call of ``tokens`` tokens, rounded up to a
    multiple of 8 (the JAX package's lane multiple)."""
    C = int(np.ceil(tokens * top_k / num_experts * capacity_factor))
    return max(int(np.ceil(C / 8)) * 8, 8)


def top_k(logits: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, the lower
    index first on a tie, as ``lax.top_k`` orders them."""
    values, indices = torch.sort(logits, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


class Routing(NamedTuple):
    topi: torch.Tensor   # (T, k) expert of each slot
    gates: torch.Tensor  # (T, k) float32 softmax over the k router logits
    pos: torch.Tensor    # (T, k) position in the expert's buffer
    keep: torch.Tensor   # (T, k) pos < C
    C: int


def slot_positions(topi: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Each (token, slot)'s position among the earlier slots (token-major)
    of its expert, for topi (T, k).  A stable sort by expert keeps
    token-major order within each expert: the same numbers as the JAX
    package's cumulative sum over a one-hot, with no host sync.  A DTensor
    ``topi`` is whole on every rank (``moe_ffn`` gathers the routing's
    input), so each rank counts on its own copy."""
    from torch.distributed.tensor import DTensor

    if isinstance(topi, DTensor):
        return DTensor.from_local(
            slot_positions(topi.to_local(), num_experts), topi.device_mesh,
            topi.placements, run_check=False)
    flat = topi.reshape(-1)
    experts, order = torch.sort(flat, stable=True)
    starts = torch.searchsorted(
        experts, torch.arange(num_experts, device=flat.device))
    pos = torch.empty_like(flat)
    pos[order] = torch.arange(flat.numel(), device=flat.device) \
        - starts[experts]
    return pos.reshape(topi.shape)


def route(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> Routing:
    """Routing of x (B, S, D): the router product in float32, top-k, the
    softmax over the k values, each slot's position in its expert's buffer
    and whether it fits in the call's capacity."""
    m = cfg.moe
    B, S, D = x.shape
    T, k, E = B * S, m.top_k, m.num_experts
    logits = x.reshape(T, D).float() @ p.router
    topv, topi = top_k(logits, k)
    gates = torch.softmax(topv, dim=-1)
    C = capacity(T, k, E, m.capacity_factor)
    pos = slot_positions(topi, E)
    return Routing(topi, gates, pos, pos < C, C)


def moe_ffn(p: MoE, x: torch.Tensor, cfg: ModelConfig,
            ctx: ShardCtx = NOSHARD) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D), what the JAX package's ``moe_ffn``
    computes, cast for cast.  Each slot j of every token is written into
    the (E * C + 1, D) buffer at row expert * C + pos, a dropped slot at the
    spare last row, which is cut off: the kept rows are distinct, so the
    buffer is the same whatever order the spare row's writes land in, and
    no host sync is needed to pick the kept slots.  The combine gathers
    each slot's output (0 where dropped), multiplies by its gate in bf16
    and adds the k slots in bf16 in slot order, as the JAX package's
    ``segment_sum`` adds them."""
    m = cfg.moe
    B, S, D = x.shape
    T, k, E = B * S, m.top_k, m.num_experts
    # on a mesh the routing is global (a slot's place in its expert's
    # buffer counts the earlier slots of every rank's tokens): gather them
    x = ctx.constrain(x, (None, None, None))
    r = route(p, x, cfg)
    C = r.C
    xf = x.reshape(T, D)
    row = torch.where(r.keep, r.topi * C + r.pos, E * C)  # (T, k)

    dispatch = xf.new_zeros(E * C + 1, D)
    for j in range(k):
        dispatch.index_copy_(0, row[:, j], xf)
    # experts over 'model' where there are 16 or more (the JAX package's
    # rule), else the capacity and feature dims, so that the (E, C, D)
    # buffer is never replicated
    if _experts_shardable(cfg):
        disp_spec = h_spec = (ctx.tp, ctx.dp_spec, None)
    else:
        disp_spec = h_spec = (None, ctx.dp_spec, ctx.tp)
    dispatch = ctx.constrain(dispatch[:E * C].view(E, C, D), disp_spec)
    act = _expert_act(cfg)
    h = act(torch.bmm(dispatch, ctx.gathered(p.w_gate)))
    h = ctx.constrain(h * torch.bmm(dispatch, ctx.gathered(p.w_up)), h_spec)
    del dispatch
    out = ctx.constrain(torch.bmm(h, ctx.gathered(p.w_down)), disp_spec)
    # the combine reads any expert's rows: the buffer whole on each rank
    out = ctx.constrain(out, (None, None, None)).view(E * C, D)
    del h

    gates = r.gates.to(x.dtype)
    row = torch.clamp(row, max=E * C - 1)
    y = xf.new_zeros(T, D)
    for j in range(k):
        slot = torch.where(r.keep[:, j, None], out[row[:, j]], 0)
        y = y + slot * gates[:, j, None]
    return ctx.constrain(y.reshape(B, S, D), (ctx.dp_spec, None, None))


def moe_ffn_loop(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """The plain per-expert loop, for checks and tests only: each expert
    takes its routed slots in token order and keeps the first C, runs its
    FFN on them and adds the gated outputs back to their tokens (float32
    sums, one rounding).  Shares only the router and top-k with
    ``moe_ffn``.  Returns (y (B, S, D), keep (T, k))."""
    m = cfg.moe
    B, S, D = x.shape
    T, k, E = B * S, m.top_k, m.num_experts
    xf = x.reshape(T, D)
    topv, topi = top_k(xf.float() @ p.router, k)
    gates = torch.softmax(topv, dim=-1).to(x.dtype)
    C = capacity(T, k, E, m.capacity_factor)
    act = _expert_act(cfg)
    keep = torch.zeros(T, k, dtype=torch.bool, device=x.device)
    y = torch.zeros(T, D, dtype=torch.float32, device=x.device)
    for e in range(E):
        tok, slot = (topi == e).nonzero(as_tuple=True)  # token-major
        tok, slot = tok[:C], slot[:C]
        keep[tok, slot] = True
        xe = xf[tok]
        h = act(xe @ p.w_gate[e]) * (xe @ p.w_up[e])
        out = (h @ p.w_down[e]) * gates[tok, slot, None]
        y.index_add_(0, tok, out.float())
    return y.to(x.dtype).reshape(B, S, D), keep


def aux_load_balance_loss(p: MoE, x: torch.Tensor,
                          cfg: ModelConfig) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (for training; the JAX
    package's steps do not call it)."""
    m = cfg.moe
    T = x.shape[0] * x.shape[1]
    logits = x.reshape(T, -1).float() @ p.router
    probs = torch.softmax(logits, dim=-1)
    _, topi = top_k(logits, m.top_k)
    frac_tokens = torch.nn.functional.one_hot(
        topi, m.num_experts).float().sum(1).mean(0)
    frac_probs = probs.mean(0)
    return m.num_experts * torch.sum(frac_tokens * frac_probs)
