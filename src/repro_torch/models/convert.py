"""Carry a parameter tree of the JAX package's ``init_params`` into the
port's ``LM``.

The input is that tree with every leaf as a numpy array (for example
``jax.tree.map(np.asarray, params)``), so nothing here imports JAX.  The
scanned periods' stacked leaves (leading axis = period) are unstacked: the
leaf of period p at pattern position i goes to layer p * period + i; the
tail follows in order.  bfloat16 leaves arrive as numpy arrays of ml_dtypes'
``bfloat16`` type, which ``torch.from_numpy`` refuses; their bits are viewed
as uint16 and back as ``torch.bfloat16``.  The dtype is recognised by its
name, because ml_dtypes need not be installed where the port runs.
``train.optimizer.opt_state_from_jax`` carries the JAX package's
``AdamWState`` through the same name mapping (``by_name``).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..configs.base import ModelConfig
from .model import LM


def to_tensor(a) -> torch.Tensor:
    """A numpy array (bfloat16 included) as a CPU tensor of its dtype, on
    a copy (JAX hands out read-only buffers)."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _copy(dst: torch.Tensor, leaf, where: str) -> None:
    src = to_tensor(leaf)
    if src.shape != dst.shape or src.dtype != dst.dtype:
        raise ValueError(f"{where}: {tuple(src.shape)} {src.dtype} from the "
                         f"tree, {tuple(dst.shape)} {dst.dtype} in the model")
    with torch.no_grad():
        dst.copy_(src)


def _period(tree, p: int):
    """Period p of a block's stacked leaves."""
    if isinstance(tree, Mapping):
        return {k: _period(v, p) for k, v in tree.items()}
    return np.asarray(tree)[p]


def by_name(tree: Mapping, model: LM, where: str) -> Dict[str, object]:
    """A tree shaped like the JAX package's parameters, flattened to the
    model's parameter names (the leaf of period p at pattern position i
    under ``layers.<p * period + i>``); raises unless the names are the
    model's."""
    cfg = model.cfg
    out: Dict[str, object] = {}

    def walk(t: Mapping, prefix: str) -> None:
        for k, v in t.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{k}.")
            else:
                out[prefix + k] = v

    walk({k: tree[k] for k in ("embed", "lm_head", "final_norm")
          if k in tree}, "")
    period = cfg.pattern_period
    for i, stacked in enumerate(tree["scan"]):
        for p in range(cfg.num_periods):
            walk(_period(stacked, p), f"layers.{p * period + i}.")
    base = cfg.num_periods * period
    for i, block in enumerate(tree["tail"]):
        walk(block, f"layers.{base + i}.")
    if "shared" in tree:
        walk(tree["shared"], "shared.")
    names = {n for n, _ in model.named_parameters()}
    if set(out) != names:
        raise ValueError(f"{where}: the tree has {sorted(set(out) - names)} "
                         f"beyond the model's parameters and lacks "
                         f"{sorted(names - set(out))}")
    return out


def from_jax_params(params: Mapping, cfg: ModelConfig, device=None) -> LM:
    """The port's LM holding the weights of a JAX parameter tree (numpy
    leaves); on the card unless the caller passes ``device="cpu"``."""
    device = torch.device("cuda" if device is None else device)
    head = params["embed"] if "embed" in params else params["lm_head"]
    model = LM(cfg, to_tensor(head).dtype, device)
    want = {"scan", "tail", "final_norm"}
    want |= {n for n in ("embed", "lm_head") if getattr(model, n) is not None}
    if cfg.shared_attention:
        want.add("shared")
    if set(params) != want:
        raise ValueError(f"the tree has {sorted(params)}, the model wants "
                         f"{sorted(want)}")
    leaves = by_name(params, model, "params")
    for name, p in model.named_parameters():
        _copy(p, leaves[name], name)
    return model
