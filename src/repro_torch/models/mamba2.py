"""Mamba2 SSD (state-space duality) block [arXiv:2405.21060] in PyTorch.

Prefill uses the chunked SSD algorithm: quadratic attention-like intra-chunk
compute plus a linear inter-chunk state recurrence, O(S) in all.  Decode is a
constant-time state update.  With ``use_kernel`` (the default) the scan runs
through the registry's ``ssd_scan``, the hand-written CUDA kernel
``csrc/ssd_scan.cu`` on the card; ``ssd_reference`` here is its plain
version and the ``use_kernel=False`` path.  The plain scan is also the
training route, as in the JAX package: the kernel has no backward, and its
wrapper refuses to run where autograd records.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from .layers import NOSHARD, ShardCtx, param, rms_norm, trunc_normal


# ---------------------------------------------------------------------------
# reference SSD scan (shared with kernels/ssd_scan/ref.py)
# ---------------------------------------------------------------------------
def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., q) -> (..., q, q) with out[i,j] = sum_{k=j+1..i} x[k]; -inf
    above the diagonal."""
    q = x.shape[-1]
    cum = torch.cumsum(x, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]  # cum_i - cum_j
    mask = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def _mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b, in place into a unless autograd records (exp's backward keeps
    its output, which an in-place product would overwrite)."""
    return a * b if torch.is_grad_enabled() else a.mul_(b)


def ssd_reference(
    x: torch.Tensor,  # (B, S, H, P), already multiplied by dt
    dA: torch.Tensor,  # (B, S, H) log-decays (dt * A, A < 0)
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD in float32; returns (y (B,S,H,P), final_state
    (B,H,P,N)).  The einsums of the JAX version are split in pairs so that
    no intermediate is larger than the (b,h,c,q,q) decay tensor."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    q = min(chunk, s)
    assert s % q == 0, f"seq {s} % chunk {q} != 0"
    nc = s // q
    xc = x.reshape(b, nc, q, h, p).float()
    Ac = dA.reshape(b, nc, q, h).permute(0, 3, 1, 2).float()  # (b,h,nc,q)
    Bc = Bm.reshape(b, nc, q, n).float()
    Cc = Cm.reshape(b, nc, q, n).float()

    A_cumsum = torch.cumsum(Ac, dim=-1)  # (b,h,nc,q)

    # 1. intra-chunk (diagonal blocks)
    L = torch.exp(_segsum(Ac))  # (b,h,nc,q,q)
    scores = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    L = _mul(L, scores[:, None])
    Y_diag = torch.einsum("bhcls,bcshp->bclhp", L, xc)
    del L

    # 2. chunk states (decay each position to the chunk's end)
    decay_states = torch.exp(A_cumsum[..., -1:] - A_cumsum)  # (b,h,nc,q)
    xd = xc * decay_states.permute(0, 2, 3, 1)[..., None]
    states = torch.einsum("bcln,bclhp->bchpn", Bc, xd)  # (b,nc,h,p,n)

    # 3. inter-chunk recurrence; prev[c] is the state entering chunk c
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    chunk_decay = torch.exp(A_cumsum[..., -1])  # (b,h,nc)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, :, c, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (b,nc,h,p,n)

    # 4. state -> output contribution
    Y_off = torch.einsum("bcln,bchpn->bclhp", Cc, prev_states)
    Y_off = _mul(Y_off, torch.exp(A_cumsum).permute(0, 2, 3, 1)[..., None])

    y = (Y_diag + Y_off).reshape(b, s, h, p)
    return y, state


def ssd_decode_step(
    state: torch.Tensor,  # (B, H, P, N), updated in place
    x: torch.Tensor,  # (B, H, P), dt-scaled input
    dA: torch.Tensor,  # (B, H) log decay
    Bm: torch.Tensor,  # (B, N)
    Cm: torch.Tensor,  # (B, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    state.mul_(torch.exp(dA)[..., None, None])
    state.add_(torch.einsum("bhp,bn->bhpn", x, Bm))
    y = torch.einsum("bhpn,bn->bhp", state, Cm)
    return y, state


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------
def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = s.num_heads(cfg.d_model)
    conv_dim = d_inner + 2 * s.d_state
    d_in_proj = 2 * d_inner + 2 * s.d_state + nheads
    return d_inner, nheads, conv_dim, d_in_proj


class Mamba2(nn.Module):
    """The block's parameters, under the JAX package's names."""

    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        d, s = cfg.d_model, cfg.ssm
        d_inner, nheads, conv_dim, d_in_proj = _dims(cfg)
        f32 = torch.float32
        self.in_proj = param((d, d_in_proj), dtype, device)
        self.conv_w = param((conv_dim, s.d_conv), f32, device)
        self.conv_b = param((conv_dim,), f32, device)
        self.A_log = param((nheads,), f32, device)
        self.D = param((nheads,), f32, device)
        self.dt_bias = param((nheads,), f32, device)
        self.norm = param((d_inner,), f32, device)
        self.out_proj = param((d_inner, d), dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for name in ("in_proj", "conv_w", "out_proj"):
            w = getattr(self, name)
            w.copy_(trunc_normal(generator, w.shape, 1.0, w.dtype, w.device))
        nheads = self.A_log.shape[0]
        self.conv_b.zero_()
        self.A_log.copy_(torch.log(torch.linspace(
            1.0, 16.0, nheads, dtype=torch.float32, device=self.A_log.device)))
        self.D.fill_(1.0)
        self.dt_bias.zero_()
        self.norm.fill_(1.0)


def init_mamba2(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device=None) -> Mamba2:
    p = Mamba2(cfg, dtype, device)
    p.reset_parameters(generator)
    return p


def mamba2_axes(cfg: ModelConfig):
    return {
        "in_proj": ("data", "model"),
        "conv_w": ("model", None),
        "conv_b": ("model",),
        "A_log": (None,),
        "D": (None,),
        "dt_bias": (None,),
        "norm": ("model",),
        "out_proj": ("model", "data"),
    }


def _split_proj(zxbcdt, cfg):
    d_inner, nheads, conv_dim, _ = _dims(cfg)
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner: d_inner + conv_dim]
    dt = zxbcdt[..., d_inner + conv_dim:]
    return z, xBC, dt


def _causal_conv(xBC, w, b):
    """Depthwise causal conv in float32: xBC (B, S, C), w (C, K)."""
    C, K = w.shape
    x = xBC.float().transpose(1, 2)  # (B, C, S)
    x = F.pad(x, (K - 1, 0))
    out = F.conv1d(x, w[:, None, :], b, groups=C)
    return F.silu(out).transpose(1, 2)  # (B, S, C)


def mamba2_scan_inputs(p: Mamba2, x, cfg: ModelConfig,
                       ctx: ShardCtx = NOSHARD):
    """The prefill's projections up to the scan: (z, xs, x_scaled, dA, Bm,
    Cm), the last four in float32 as the scan takes them.  On a mesh the
    projection's feature dim is gathered first: it is cut into z, xBC and
    dt and reshaped into heads, which a shard cannot follow."""
    s = cfg.ssm
    d_inner, nheads, _, _ = _dims(cfg)
    B, S, _ = x.shape
    zxbcdt = ctx.constrain(x @ ctx.gathered(p.in_proj),
                           (ctx.dp_spec, None, None))
    z, xBC, dt = _split_proj(zxbcdt, cfg)
    # on each rank's batch: DTensor's convolution places its output by
    # the input alone, whatever the weight's split, and takes no batch
    # split over two mesh axes
    xBC = ctx.local(_causal_conv, ((ctx.dp_spec, None, None), (None, None),
                                   (None,)), xBC, p.conv_w, p.conv_b)
    xs = xBC[..., :d_inner].reshape(B, S, nheads, s.head_dim)
    Bm = xBC[..., d_inner: d_inner + s.d_state]
    Cm = xBC[..., d_inner + s.d_state:]
    dt = F.softplus(dt.float() + p.dt_bias)  # (B,S,H)
    A = -torch.exp(p.A_log)  # (H,)
    dA = dt * A[None, None, :]
    x_scaled = xs.float() * dt[..., None]
    return z, xs, x_scaled, dA, Bm, Cm


def mamba2_forward(p: Mamba2, x, cfg: ModelConfig, ctx: ShardCtx = NOSHARD,
                   use_kernel: bool = True):
    """Prefill path: full-sequence chunked SSD."""
    s = cfg.ssm
    d_inner = _dims(cfg)[0]
    B, S, _ = x.shape
    z, xs, x_scaled, dA, Bm, Cm = mamba2_scan_inputs(p, x, cfg, ctx)
    if use_kernel:
        from ..kernels.registry import resolve

        y, _ = resolve("ssd_scan")(x_scaled, dA, Bm, Cm, s.chunk)
    else:
        # independent across batch and heads: on a mesh each rank scans
        # its own shards
        def scan(x_scaled, dA, Bm, Cm):
            return ssd_reference(x_scaled, dA, Bm, Cm,
                                 chunk=min(s.chunk, S))[0]
        dp, tp = ctx.dp_spec, ctx.tp
        y = ctx.local(scan, ((dp, None, tp, None), (dp, None, tp),
                             (dp, None, None), (dp, None, None)),
                      x_scaled, dA, Bm, Cm)
    y = y + xs.float() * p.D[None, None, :, None]
    # the heads' split (or none) carried to the flat dim, so that its
    # gradient comes back split as the reshape from heads can follow
    y = ctx.constrain(y.reshape(B, S, d_inner), ctx.heads(_dims(cfg)[1]))
    y = rms_norm(y.to(x.dtype), p.norm) * F.silu(z.float()).to(x.dtype)
    return ctx.constrain(y @ ctx.gathered(p.out_proj),
                         (ctx.dp_spec, None, None))


def mamba2_init_cache(cfg: ModelConfig, batch: int, device=None,
                      dtype=torch.float32) -> Dict[str, torch.Tensor]:
    s = cfg.ssm
    d_inner, nheads, conv_dim, _ = _dims(cfg)
    return {
        "conv": torch.zeros((batch, conv_dim, s.d_conv - 1), dtype=dtype,
                            device=device),
        "ssd": torch.zeros((batch, nheads, s.head_dim, s.d_state),
                           dtype=dtype, device=device),
    }


def mamba2_decode(p: Mamba2, x, cache: Dict[str, torch.Tensor],
                  cfg: ModelConfig, ctx: ShardCtx = NOSHARD):
    """One-token decode, x: (B, 1, D): O(1) conv-buffer and state update,
    both in place in ``cache`` (the JAX package returns new arrays)."""
    s = cfg.ssm
    d_inner, nheads, conv_dim, _ = _dims(cfg)
    B = x.shape[0]
    zxbcdt = ctx.constrain(x @ ctx.gathered(p.in_proj),
                           (ctx.dp_spec, None, None))[:, 0]
    z, xBC, dt = _split_proj(zxbcdt, cfg)

    conv = cache["conv"]
    window = torch.cat([conv, xBC.to(conv.dtype)[:, :, None]], dim=2)
    conv_out = torch.einsum("bck,ck->bc", window, p.conv_w) + p.conv_b
    xBC_t = ctx.constrain(F.silu(conv_out), (ctx.dp_spec, None))
    conv.copy_(window[:, :, 1:])

    xs = xBC_t[..., :d_inner].reshape(B, nheads, s.head_dim)
    Bm = xBC_t[..., d_inner: d_inner + s.d_state]
    Cm = xBC_t[..., d_inner + s.d_state:]
    dtv = F.softplus(dt.float() + p.dt_bias)  # (B,H)
    A = -torch.exp(p.A_log)
    dA = dtv * A[None, :]
    y, _ = ssd_decode_step(cache["ssd"], xs * dtv[..., None], dA, Bm, Cm)
    y = y + xs * p.D[None, :, None]
    y = y.reshape(B, 1, d_inner)
    y = rms_norm(y.to(x.dtype), p.norm) * \
        F.silu(z.float())[:, None, :].to(x.dtype)
    return y @ ctx.gathered(p.out_proj), cache
