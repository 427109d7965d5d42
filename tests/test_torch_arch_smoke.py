"""Every architecture the repo configures, built, trained and served by the
port on its reduced config on the CPU: the JAX package's
tests/test_models.py smoke tests (one train step and one decode step per
arch, the parameter count), re-rooted at repro_torch.  The JAX package is
imported only for its parameter tree's shapes."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jx_get_config
from repro.configs.base import reduced_config as jx_reduced_config
from repro.models import model as JM
from repro_torch.configs.base import (ARCH_IDS, ShapeConfig, get_config,
                                      reduced_config)
from repro_torch.models import model as M
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.steps import (make_serve_step, make_train_step,
                                     materialize_batch)

SMOKE_SHAPE = ShapeConfig("smoke", 32, 2, "train")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_smoke_train_and_decode(arch):
    cfg = reduced_config(get_config(arch))
    gen = torch.Generator().manual_seed(0)
    model = M.init_params(cfg, gen, device="cpu")
    batch = materialize_batch(cfg, SMOKE_SHAPE, gen, device="cpu")["batch"]
    before = [p.detach().clone() for p in model.parameters()]
    model, _, metrics = make_train_step(cfg)(model, adamw_init(model), batch)
    loss = float(metrics["loss"])
    assert np.isfinite(loss), f"{arch}: non-finite loss"
    assert 1.0 < loss < 20.0
    delta = sum(float((a.float() - b.detach().float()).abs().sum())
                for a, b in zip(before, model.parameters()))
    assert delta > 0

    cache = M.init_cache(cfg, 2, 64, device="cpu")
    if cfg.embedding_stub:
        tok = torch.zeros((2, 1, cfg.d_model), dtype=torch.bfloat16)
    else:
        tok = torch.zeros((2,), dtype=torch.int32)
    nt, cache = make_serve_step(cfg)(model, cache, tok, 0)
    assert nt.shape == (2,)
    assert not any(bool(torch.isnan(t).any()) for c in cache
                   for t in c.values() if t.is_floating_point())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count_matches_jax_tree(arch):
    """The port's parameters number exactly the JAX package's tree's
    leaves' elements, within 2% of the analytic count (the JAX package's
    test_param_count_matches_analytic)."""
    cfg = reduced_config(get_config(arch))
    jcfg = jx_reduced_config(jx_get_config(arch))
    tree = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.PRNGKey(0)))
    expected = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(tree))
    actual = sum(p.numel() for p in M.LM(cfg, device="meta").parameters())
    assert actual == expected
    assert abs(actual - cfg.param_count()) / cfg.param_count() < 0.02
