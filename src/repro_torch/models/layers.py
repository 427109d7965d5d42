"""Core transformer layers: norms, RoPE, attention (GQA/MQA, qk-norm,
sliding window), gated MLPs — plain PyTorch.

The JAX package computes all of these outside any Pallas kernel, so the port
does too.  Parameters live in small ``nn.Module``s whose parameter names are
the JAX package's dictionary keys (``wq``, ``w_up``, ...); the functions take
such a module where the JAX functions take a parameter dictionary.

``ShardCtx`` carries a mesh (``launch.mesh.shard_ctx``).  Where the
parameters and inputs are ``DTensor``s on it, ``constrain`` redistributes
an activation to the spec the JAX package constrains it to at the same
place (its ``with_sharding_constraint``); on plain tensors, or with no
mesh, it returns its input.  The ``*_axes`` functions give each
parameter's preferred mesh axes, as the JAX package declares them
(``launch.sharding`` resolves them against a mesh).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..launch.sharding import placements


class _Redistribute(torch.autograd.Function):
    """``x.redistribute(mesh, target)`` whose gradient comes back
    contiguous (DTensor's redistributions can leave a strided local shard,
    which the backward of a product's reshape cannot view) and, with
    ``bind``, placed by ``target`` before it goes back to the input's
    placements, as a sharding constraint binds the cotangent in XLA: else
    DTensor leaves gradients where its backward ops happen to (the loss's
    split over the sequence, say) and searches the whole mesh at each
    product after."""

    @staticmethod
    def forward(ctx, x, mesh, target, bind):
        from torch.distributed.tensor import Replicate

        # a partial sum's gradient is the whole gradient on every rank
        source = tuple(Replicate() if p.is_partial() else p
                       for p in x.placements)
        ctx.mesh, ctx.hops = mesh, ((target,) if bind else ()) + (source,)
        return x.redistribute(mesh, target)

    @staticmethod
    def backward(ctx, g):
        for placed in ctx.hops:
            if tuple(g.placements) != placed:
                g = g.redistribute(ctx.mesh, placed)
        return g.contiguous(), None, None, None


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """A mesh's data-parallel axes, tensor-parallel axis, axis sizes and
    the ``DeviceMesh`` itself; with no mesh, ``constrain`` is the
    identity."""

    dp: Tuple[str, ...] = ()  # data-parallel mesh axes ('pod','data') / ('data',)
    tp: Optional[str] = None  # tensor-parallel axis ('model')
    axis_sizes: Optional[Dict[str, int]] = None
    mesh: Optional[object] = None  # a DeviceMesh

    def _fits(self, dim: int, axes) -> bool:
        if axes is None or self.axis_sizes is None:
            return True
        names = axes if isinstance(axes, tuple) else (axes,)
        total = 1
        for n in names:
            total *= self.axis_sizes.get(n, 1)
        return dim % total == 0

    def _placed(self, x, spec: Tuple, bind: bool = True):
        """x redistributed to ``spec``, an axis that does not divide its
        dimension dropped (as the JAX package resolves it)."""
        resolved = tuple(axes if axes and self._fits(dim, axes) else None
                         for dim, axes in zip(x.shape, spec))
        return self._to(x, placements(resolved, self.mesh), bind)

    def _to(self, x, target: tuple, bind: bool):
        if not torch.is_grad_enabled():
            return x.redistribute(self.mesh, target)
        return _Redistribute.apply(x, self.mesh, target, bind)

    def _sharded(self, x) -> bool:
        if self.mesh is None:
            return False
        from torch.distributed.tensor import DTensor

        return isinstance(x, DTensor)

    def constrain(self, x: torch.Tensor, spec: Tuple) -> torch.Tensor:
        """x redistributed to ``spec`` where x is a DTensor on the mesh (an
        axis that does not divide its dimension dropped, as the JAX
        package resolves it), its gradient bound to ``spec`` too; else
        x."""
        return self._placed(x, spec) if self._sharded(x) else x

    def heads(self, n: int) -> Tuple:
        """The spec of a (B, S, n * head_dim) activation: the batch over the
        data-parallel axes, the flat dim over ``tp`` only where the n heads
        divide it (a reshape cannot cut a shard across heads; XLA gathers
        there)."""
        return (self.dp_spec, None, self.tp if self._fits(n, self.tp)
                else None)

    def gathered(self, w: torch.Tensor) -> torch.Tensor:
        """A weight with its split over the data-parallel axes gathered
        (FSDP's all-gather before use, which XLA inserts): what stays split
        is the tensor-parallel one.  Its gradient is reduce-scattered back.
        Left to choose, DTensor would also split the activations' batch and
        the weight's rows over the same axis and search placements through
        the whole mesh for every product."""
        if not self._sharded(w):
            return w
        from torch.distributed.tensor import Replicate

        names = self.mesh.mesh_dim_names
        target = tuple(Replicate() if names[i] in self.dp else pl
                       for i, pl in enumerate(w.placements))
        if target == tuple(w.placements):
            return w
        return self._to(w, target, bind=False)

    def local(self, fn, specs: Tuple, *tensors):
        """``fn(*tensors)``; where they are DTensors, on each rank's shards
        of them, each first placed by its spec in ``specs`` (resolved on
        its own shape), and fn's output, whose dims must follow the first
        tensor's, placed like that one.  For work that is independent
        across the split dims, such as attention across batch and heads,
        which DTensor would otherwise gather to merge the two into one
        batch dim, or the scan's loop over chunks, which it would run op by
        op at a DTensor dispatch each."""
        if not self._sharded(tensors[0]):
            return fn(*tensors)
        from torch.distributed.tensor import DTensor

        placed = [self._placed(t, spec) for t, spec in zip(tensors, specs)]
        return DTensor.from_local(fn(*(t.to_local() for t in placed)),
                                  self.mesh, placed[0].placements,
                                  run_check=False)

    def replicating(self):
        """A context in which plain tensors that meet DTensors (masks,
        rope tables, positions, zeros the model builds) count as
        replicated on the mesh; nothing without one.  The steps
        (``train.steps``) enter it once around all their work, backward
        passes included: it does not nest."""
        if self.mesh is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import implicit_replication

        return implicit_replication()

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


def _split_heads(t: torch.Tensor, heads: int, hd: int,
                 ctx: ShardCtx) -> torch.Tensor:
    """(B, S, heads * hd) -> (B, S, heads, hd), the flat dim first placed
    by ``ctx.heads``."""
    B, S, _ = t.shape
    return ctx.constrain(t, ctx.heads(heads)).reshape(B, S, heads, hd)


def _qkv(p: Attention, x, cfg: ModelConfig, ctx: ShardCtx, positions):
    hd = cfg.resolved_head_dim
    q = _split_heads(x @ ctx.gathered(p.wq), cfg.num_heads, hd, ctx)
    k = _split_heads(x @ ctx.gathered(p.wk), cfg.num_kv_heads, hd, ctx)
    v = _split_heads(x @ ctx.gathered(p.wv), cfg.num_kv_heads, hd, ctx)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm)
        k = rms_norm(k, p.k_norm)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    spec = (ctx.dp_spec, None, ctx.tp, None)
    return (ctx.constrain(q, spec), ctx.constrain(k, spec),
            ctx.constrain(v, spec))


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Each kv head n_rep times in a row along dim 2 (``repeat_interleave``
    as a broadcast and a reshape, which DTensor keeps local where the heads
    are split over the mesh)."""
    if n_rep == 1:
        return k
    B, S, H, hd = k.shape
    return k[:, :, :, None].expand(B, S, H, n_rep, hd).reshape(
        B, S, H * n_rep, hd)


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
        def core(q, k, v):
            return _attention_online(q, k, v, sliding_window, x.dtype)
    else:
        def core(q, k, v):
            return _attention_blocked(q, k, v, sliding_window, x.dtype,
                                      q_block)
    spec = (ctx.dp_spec, ctx.tp, None, None)
    out = ctx.local(core, (spec,) * 3, q, k, v)
    # the heads' split (or none) carried to the flat dim, so that its
    # gradient comes back split as a reshape into heads can follow
    out = ctx.constrain(out.transpose(1, 2).reshape(
        B, S, cfg.num_heads * hd), ctx.heads(cfg.num_heads))
    return ctx.constrain(out @ ctx.gathered(p.wo),
                         (ctx.dp_spec, None, None))


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
    copies; on a mesh whose sharding the write cannot follow, into a
    gathered copy); returns (out, cache_k, cache_v)."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    S_max = cache_k.shape[1]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, x, cfg, ctx, positions)
    ring = sliding_window is not None and S_max == sliding_window
    slot = pos % sliding_window if ring else pos
    # on a mesh a sequence split over it (long_500k's batch of 1) is
    # gathered first: the write at ``slot`` cannot follow a shard; else
    # this is the cache itself and the writes land in place
    spec = (ctx.dp_spec, None, ctx.tp, None)
    cache_k = ctx.constrain(cache_k, spec)
    cache_v = ctx.constrain(cache_v, spec)
    cache_k[:, slot:slot + 1] = k.to(cache_k.dtype)
    cache_v[:, slot:slot + 1] = v.to(cache_v.dtype)

    n_rep = cfg.num_heads // cfg.num_kv_heads
    kk = _repeat_kv(cache_k, n_rep)  # (B, S_max, Hq, hd)
    vv = _repeat_kv(cache_v, n_rep)
    scale = 1.0 / np.sqrt(hd)
    kpos = torch.arange(S_max, device=x.device)
    if ring:
        valid = (kpos <= min(pos, S_max - 1)) | (pos >= S_max)
    else:
        valid = kpos <= pos

    def core(q, kk, vv):
        scores = torch.einsum("bqhd,bshd->bhqs", q.float(), kk.float()) * scale
        w = torch.softmax(scores.masked_fill(~valid, -1e30), dim=-1)
        return torch.einsum("bhqs,bshd->bqhd", w, vv.float())

    out = ctx.local(core, (spec,) * 3, q, kk, vv)
    out = out.reshape(B, 1, cfg.num_heads * hd).to(x.dtype)
    return out @ ctx.gathered(p.wo), cache_k, cache_v


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
    up = x @ ctx.gathered(p.w_up)
    h = act(x @ ctx.gathered(p.w_gate)) * up if cfg.gated_mlp else act(up)
    h = ctx.constrain(h, (ctx.dp_spec, None, ctx.tp))
    return ctx.constrain(h @ ctx.gathered(p.w_down),
                         (ctx.dp_spec, None, None))
