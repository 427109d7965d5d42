"""Core transformer layers: norms, RoPE, attention (GQA/MQA, qk-norm,
sliding window), gated MLPs — plain PyTorch.

The JAX package computes all of these outside any Pallas kernel, so the port
does too.  Parameters live in small ``nn.Module``s whose parameter names are
the JAX package's dictionary keys (``wq``, ``w_up``, ...); the functions take
such a module where the JAX functions take a parameter dictionary.

``ShardCtx`` carries a mesh's axes (``launch.mesh.shard_ctx``), but the
port runs no model sharded yet: ``constrain`` returns its input, and the
calls mark where the JAX package constrains.  The ``*_axes`` functions give
each parameter's preferred mesh axes, as the JAX package declares them
(``launch.sharding`` resolves them against a mesh).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """A mesh's data-parallel axes, tensor-parallel axis and axis sizes;
    ``constrain`` is the identity (no model runs sharded yet)."""

    dp: Tuple[str, ...] = ()  # data-parallel mesh axes ('pod','data') / ('data',)
    tp: Optional[str] = None  # tensor-parallel axis ('model')
    axis_sizes: Optional[Dict[str, int]] = None

    def constrain(self, x: torch.Tensor, spec: Tuple) -> torch.Tensor:
        return x

    @property
    def dp_spec(self):
        return tuple(self.dp) if self.dp else None


NOSHARD = ShardCtx()


# ---------------------------------------------------------------------------
# initialization helpers
# ---------------------------------------------------------------------------
def param(shape, dtype, device) -> nn.Parameter:
    """An uninitialised parameter; ``reset_parameters`` or
    ``models.convert`` fills it."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def trunc_normal(generator: torch.Generator, shape, scale, dtype=torch.bfloat16,
                 device=None) -> torch.Tensor:
    """Normal truncated to [-2, 2], times scale / sqrt(fan_in), as the JAX
    package's initializer draws it (other random numbers from the same
    seed: a torch.Generator is not a JAX key)."""
    fan_in = shape[0] if len(shape) >= 1 else 1
    std = scale / np.sqrt(max(fan_in, 1))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * std).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    w = scale.float()
    if plus_one:  # gemma-style (1 + w)
        w = 1.0 + w
    return (x * w).to(dt)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)  # (hd/2,)
    ang = positions[..., None].float() * inv  # (..., S, hd/2)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        hq, hkv = cfg.num_heads, cfg.num_kv_heads
        self.wq = param((d, hq * hd), dtype, device)
        self.wk = param((d, hkv * hd), dtype, device)
        self.wv = param((d, hkv * hd), dtype, device)
        self.wo = param((hq * hd, d), dtype, device)
        if cfg.qk_norm:
            self.q_norm = param((hd,), torch.float32, device)
            self.k_norm = param((hd,), torch.float32, device)
        else:
            self.q_norm = self.k_norm = None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for name in ("wq", "wk", "wv", "wo"):
            w = getattr(self, name)
            w.copy_(trunc_normal(generator, w.shape, 1.0, w.dtype, w.device))
        if self.q_norm is not None:
            self.q_norm.fill_(1.0)
            self.k_norm.fill_(1.0)


def init_attention(cfg: ModelConfig, generator: torch.Generator,
                   dtype=torch.bfloat16, device=None) -> Attention:
    p = Attention(cfg, dtype, device)
    p.reset_parameters(generator)
    return p


def attention_axes(cfg: ModelConfig):
    a = {
        "wq": ("data", "model"),
        "wk": ("data", "model"),
        "wv": ("data", "model"),
        "wo": ("model", "data"),
    }
    if cfg.qk_norm:
        a["q_norm"] = (None,)
        a["k_norm"] = (None,)
    return a


def _qkv(p: Attention, x, cfg: ModelConfig, ctx: ShardCtx, positions):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p.wq).reshape(B, S, cfg.num_heads, hd)
    k = (x @ p.wk).reshape(B, S, cfg.num_kv_heads, hd)
    v = (x @ p.wv).reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm)
        k = rms_norm(k, p.k_norm)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    return k if n_rep == 1 else k.repeat_interleave(n_rep, dim=2)


# Attention implementation selector, as in the JAX package:
#   'blocked' — q-chunked exact softmax; (q_block, S) score rows materialize
#   'online'  — flash-style online softmax over (q, k) tiles in plain torch
# (the hand-written kernel is kernels.flash_attention, at its own entry point)
_ATTENTION_IMPL = "blocked"


def set_attention_impl(name: str) -> None:
    global _ATTENTION_IMPL
    assert name in ("blocked", "online")
    _ATTENTION_IMPL = name


def attention(p: Attention, x: torch.Tensor, cfg: ModelConfig,
              ctx: ShardCtx = NOSHARD, *, sliding_window: Optional[int] = None,
              q_block: int = 1024) -> torch.Tensor:
    """Causal self-attention for prefill."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(p, x, cfg, ctx, positions)
    n_rep = cfg.num_heads // cfg.num_kv_heads
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    q = q.transpose(1, 2)  # (B, H, S, hd)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    if _ATTENTION_IMPL == "online":
        out = _attention_online(q, k, v, sliding_window, x.dtype)
    else:
        out = _attention_blocked(q, k, v, sliding_window, x.dtype, q_block)
    out = out.transpose(1, 2).reshape(B, S, cfg.num_heads * hd)
    return ctx.constrain(out @ p.wo, (ctx.dp_spec, None, None))


def _mask(qpos, kpos, sliding_window):
    mask = kpos <= qpos
    if sliding_window is not None:
        mask &= kpos > qpos - sliding_window
    return mask


def _attention_blocked(q, k, v, sliding_window, dtype, q_block):
    B, H, S, hd = q.shape
    scale = 1.0 / np.sqrt(hd)
    if S % q_block != 0:
        q_block = S
    kf, vf = k.float(), v.float()
    kpos = torch.arange(S, device=q.device)[None, :]
    chunks = []
    for qs in range(0, S, q_block):
        qi = q[:, :, qs:qs + q_block].float()
        scores = torch.einsum("bhqd,bhkd->bhqk", qi, kf) * scale
        qpos = qs + torch.arange(q_block, device=q.device)[:, None]
        scores = scores.masked_fill(~_mask(qpos, kpos, sliding_window), -1e30)
        w = torch.softmax(scores, dim=-1)
        chunks.append(torch.einsum("bhqk,bhkd->bhqd", w, vf).to(dtype))
    return torch.cat(chunks, dim=2)


def _attention_online(q, k, v, sliding_window, dtype, q_tile: int = 512,
                      k_tile: int = 512):
    """Running (max, denom, acc) per q tile over k tiles."""
    B, H, S, hd = q.shape
    scale = 1.0 / np.sqrt(hd)
    q_tile, k_tile = min(q_tile, S), min(k_tile, S)
    if S % q_tile or S % k_tile:
        q_tile = k_tile = S
    kf, vf = k.float(), v.float()
    chunks = []
    for qs in range(0, S, q_tile):
        qq = q[:, :, qs:qs + q_tile].float()
        qpos = qs + torch.arange(q_tile, device=q.device)[:, None]
        m = torch.full((B, H, q_tile, 1), -1e30, device=q.device)
        l = torch.zeros((B, H, q_tile, 1), device=q.device)
        acc = torch.zeros((B, H, q_tile, hd), device=q.device)
        for ks in range(0, S, k_tile):
            s = torch.einsum("bhqd,bhkd->bhqk", qq,
                             kf[:, :, ks:ks + k_tile]) * scale
            kpos = ks + torch.arange(k_tile, device=q.device)[None, :]
            s = s.masked_fill(~_mask(qpos, kpos, sliding_window), -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p_ = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p_.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p_,
                                             vf[:, :, ks:ks + k_tile])
            m = m_new
        chunks.append((acc / torch.clamp(l, min=1e-30)).to(dtype))
    return torch.cat(chunks, dim=2)


def decode_attention(p: Attention, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: int, cfg: ModelConfig,
                     ctx: ShardCtx = NOSHARD, *,
                     sliding_window: Optional[int] = None):
    """One-token decode with a KV cache, x: (B, 1, D).  Writes the new key
    and value into the cache in place (the JAX package returns updated
    copies); returns (out, cache_k, cache_v)."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    S_max = cache_k.shape[1]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, x, cfg, ctx, positions)
    ring = sliding_window is not None and S_max == sliding_window
    slot = pos % sliding_window if ring else pos
    cache_k[:, slot:slot + 1] = k.to(cache_k.dtype)
    cache_v[:, slot:slot + 1] = v.to(cache_v.dtype)

    n_rep = cfg.num_heads // cfg.num_kv_heads
    kk = _repeat_kv(cache_k, n_rep)  # (B, S_max, Hq, hd)
    vv = _repeat_kv(cache_v, n_rep)
    scale = 1.0 / np.sqrt(hd)
    scores = torch.einsum("bqhd,bshd->bhqs", q.float(), kk.float()) * scale
    kpos = torch.arange(S_max, device=x.device)
    if ring:
        valid = (kpos <= min(pos, S_max - 1)) | (pos >= S_max)
    else:
        valid = kpos <= pos
    scores = scores.masked_fill(~valid, -1e30)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", w, vv.float())
    out = out.reshape(B, 1, cfg.num_heads * hd).to(x.dtype)
    return out @ p.wo, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.w_up = param((d, f), dtype, device)
        self.w_down = param((f, d), dtype, device)
        self.w_gate = param((d, f), dtype, device) if cfg.gated_mlp else None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for name in ("w_gate", "w_up", "w_down"):
            w = getattr(self, name)
            if w is not None:
                w.copy_(trunc_normal(generator, w.shape, 1.0, w.dtype,
                                     w.device))


def init_mlp(cfg: ModelConfig, generator: torch.Generator,
             dtype=torch.bfloat16, device=None) -> MLP:
    p = MLP(cfg, dtype, device)
    p.reset_parameters(generator)
    return p


def mlp_axes(cfg: ModelConfig):
    a = {"w_up": ("data", "model"), "w_down": ("model", "data")}
    if cfg.gated_mlp:
        a["w_gate"] = ("data", "model")
    return a


def _act(cfg: ModelConfig):
    if cfg.act == "silu":
        return F.silu
    # jax.nn.gelu defaults to the tanh approximation
    return lambda t: F.gelu(t, approximate="tanh")


def mlp(p: MLP, x: torch.Tensor, cfg: ModelConfig,
        ctx: ShardCtx = NOSHARD) -> torch.Tensor:
    act = _act(cfg)
    up = x @ p.w_up
    h = act(x @ p.w_gate) * up if cfg.gated_mlp else act(up)
    return ctx.constrain(h @ p.w_down, (ctx.dp_spec, None, None))
