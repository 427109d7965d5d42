"""AdamW, as the JAX package computes it: float32 moments whatever the
parameter's dtype, the clip scale ``min(1, clip_norm / (gnorm + 1e-9))``,
the update in float32 cast once to the parameter's dtype.

``torch.optim.AdamW`` and ``clip_grad_norm_`` are not used: for bfloat16
parameters AdamW keeps bfloat16 moments and updates in bfloat16, and
``clip_grad_norm_`` adds another epsilon; either would drift from the
reference.  Trees here are mappings from a parameter's name (as
``nn.Module.named_parameters`` gives it) to its tensor.
``opt_state_from_jax`` carries the JAX package's ``AdamWState`` (numpy
leaves) into this one, its moments unstacked by period exactly as
``models.convert.from_jax_params`` unstacks the parameters.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..models.convert import by_name, to_tensor


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def adamw_init(params: Union[nn.Module, Mapping]) -> AdamWState:
    """Zero float32 moments beside each parameter (a module's, or a
    mapping's), on its device."""
    named = (dict(params.named_parameters()) if isinstance(params, nn.Module)
             else dict(params))
    device = next(iter(named.values())).device
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in named.items()}
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                      zeros, {k: torch.zeros_like(z) for k, z in zeros.items()})


def adamw_state_axes(axes: Mapping) -> AdamWState:
    """Moments are placed exactly like their parameters."""
    return AdamWState(step=(None,), mu=axes, nu=axes)


def global_norm(tree: Mapping) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


@torch.no_grad()
def adamw_update(
    grads: Mapping,
    state: AdamWState,
    params: Mapping,
    *,
    lr: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
) -> Tuple[Mapping, AdamWState, torch.Tensor]:
    """One AdamW step with global-norm clipping; returns (params, state,
    grad norm).  Parameters and moments are updated in place (the JAX
    package returns new ones); the state's step is a new tensor."""
    if set(grads) != set(params) or set(state.mu) != set(params):
        raise ValueError("grads, moments and parameters must share names")
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    t = step.float()
    corr1 = 1.0 - b1 ** t
    corr2 = 1.0 - b2 ** t
    for name, p in params.items():
        g = grads[name].float() * scale
        m, v = state.mu[name], state.nu[name]
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        mhat = m / corr1
        vhat = v / corr2
        pf = p.float()
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))
    return params, AdamWState(step, state.mu, state.nu), gnorm


def opt_state_from_jax(opt_tree, model: nn.Module) -> AdamWState:
    """The port's ``AdamWState`` holding a JAX ``AdamWState`` (step, mu,
    nu with numpy leaves), on the model's device, keyed by the model's
    parameter names."""
    step, mu, nu = opt_tree
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device

    def moments(tree, which: str) -> Dict[str, torch.Tensor]:
        leaves = by_name(tree, model, which)
        out = {}
        for name, p in params.items():
            t = to_tensor(leaves[name])
            if t.shape != p.shape or t.dtype != torch.float32:
                raise ValueError(f"{which}.{name}: {tuple(t.shape)} "
                                 f"{t.dtype}, want {tuple(p.shape)} float32")
            out[name] = t.to(device)
        return out

    return AdamWState(to_tensor(np.asarray(step, np.int32)).to(device),
                      moments(mu, "mu"), moments(nu, "nu"))
