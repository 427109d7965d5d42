"""The port's training path (repro_torch.train, models.model's remat,
models.mamba2's plain scan) against the JAX package's, on reduced configs
on the CPU.

Weights are the JAX package's ``init_params`` carried by
``convert.from_jax_params``, optimiser state its ``AdamWState`` carried by
``optimizer.opt_state_from_jax``; inputs come from numpy seeds.  A train step
is compared from the state after one JAX step, so the moments are not zero.

Tolerances of one train step against the JAX package's, at microbatches
1 and 2 (the largest reading over the archs here in brackets).  A faulty
step reads far above them: one trained on half of the batch 0.39-0.67 on
the moments, 0.51-0.60 on the float32 updates and 0.57-0.65 on the
bfloat16 updates; one at twice the learning rate 1.0 and 1.41-1.64 on the
updates.
- Mamba2 computes the forward cast for cast (equal logits), but the two
  backward passes round bfloat16 gradients differently: loss atol 1e-4
  [5e-7], grad norm rtol 1e-3 [1.2e-4], moments' relative L2 error 1e-2
  [4.6e-3], the float32 parameters' updates (p_new - p_old) relative L2
  error 2e-2 [8e-3] in one batch and 5e-2 [2.1e-2] in microbatches, the
  bfloat16 parameters' updates 0.1 [3.2e-2];
- the attention archs' forward already differs by torch's fused silu/gelu
  (test_torch_models.py, logits to 0.15): loss atol 1e-2 [5.1e-3], grad
  norm rtol 2e-2 [1.4e-2], moments' relative L2 error 0.1 [4.9e-2], the
  float32 parameters' updates 0.1 [7e-2], the bfloat16 parameters'
  updates 0.2 [0.14];
- the MoE archs (olmoe-1b-7b, grok-1-314b) take the attention archs'
  limits, but the float32 parameters' updates 0.2 [0.1164]: the port's
  forward equals the JAX package's op-by-op (eager) forward bit for bit,
  but its compiled train step rounds elsewhere (logits up to 0.04 apart),
  and at one microbatch grok-1-314b's step sends one token of 32 in layer
  1, whose 2nd and 3rd router logits lie 0.6% apart, to another expert.
  That flip reads loss 8.7e-3, grad norm 3.1e-3, moments 4.5e-2, float32
  updates 0.1164 (the layer's router 0.18), bfloat16 updates 0.15; the
  other three MoE cases read at most 1.9e-3, 2.4e-3, 1.2e-2, 5.4e-2 and
  8.4e-2.  A faulty step (half the batch) reads 0.17-0.28 on the loss,
  0.46-0.66 on the moments and 0.59-0.67 on both updates.
The updates' errors come from the few elements whose gradients are near
zero, where AdamW's normalised step m / sqrt(v) turns on a rounding: in
mamba2-130m's microbatched step one element of a conv bias does so.  A
bfloat16 update is also the difference of two rounded parameters, so it
reads about 4 times its float32 counterpart.
The remat modes recompute the same operations on the CPU and must agree
exactly.
"""
import dataclasses
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jx_get_config
from repro.configs.base import reduced_config as jx_reduced_config
from repro.models import mamba2 as jx_mamba2
from repro.models import model as JM
from repro.train.optimizer import adamw_init as jx_adamw_init
from repro.train.steps import make_train_step as jx_make_train_step
from repro_torch.configs.base import (ARCH_IDS, ShapeConfig, get_config,
                                      reduced_config)
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import model as M
from repro_torch.models.convert import from_jax_params
from repro_torch.models.mamba2 import ssd_reference
from repro_torch.train import lm_from_warehouse
from repro_torch.train.optimizer import (AdamWState, adamw_init,
                                         opt_state_from_jax)
from repro_torch.train.steps import make_train_step, materialize_batch

SSM_STEP_TOL = {"loss": 1e-4, "grad_norm": 1e-3, "moments": 1e-2,
                "update": 2e-2, "update_microbatched": 5e-2,
                "update_bf16": 0.1}
ATTN_STEP_TOL = {"loss": 1e-2, "grad_norm": 2e-2, "moments": 0.1,
                 "update": 0.1, "update_microbatched": 0.1,
                 "update_bf16": 0.2}
MOE_STEP_TOL = {**ATTN_STEP_TOL, "update": 0.2}
LR = 3e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, B, S, seed=0):
    """(JAX batch, torch batch) of the same numpy inputs and labels."""
    rng = np.random.default_rng(seed)
    if cfg.embedding_stub:
        emb = (rng.normal(size=(B, S, cfg.d_model)) * 0.5).astype(np.float32)
        jin = jnp.asarray(emb, jnp.bfloat16)
        tin = torch.from_numpy(emb).to(torch.bfloat16)
    else:
        toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        jin, tin = jnp.asarray(toks), torch.from_numpy(toks)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return ({"inputs": jin, "labels": jnp.asarray(labels)},
            {"inputs": tin, "labels": torch.from_numpy(labels)})


def _rel_l2(got: dict, exp: dict) -> float:
    num = sum(float(torch.sum((got[k] - exp[k]).double() ** 2)) for k in exp)
    den = sum(float(torch.sum(exp[k].double() ** 2)) for k in exp)
    return (num / den) ** 0.5


@pytest.mark.parametrize("arch,microbatches", [
    pytest.param(a, mb, id=a if mb == 1 else f"{a}-mb{mb}")
    for mb in (1, 2) for a in ARCH_IDS])
def test_train_step_matches_jax(arch, microbatches):
    jcfg = jx_reduced_config(jx_get_config(arch))
    cfg = reduced_config(get_config(arch))
    tol = {"ssm": SSM_STEP_TOL, "moe": MOE_STEP_TOL}.get(cfg.family,
                                                         ATTN_STEP_TOL)
    jbatch, batch = _batch(cfg, 2, 16)
    jstep = jax.jit(jx_make_train_step(jcfg, microbatches=microbatches,
                                       lr=LR))
    params = JM.init_params(jcfg, jax.random.PRNGKey(1))
    params, opt, _ = jstep(params, jx_adamw_init(params), jbatch)
    model = from_jax_params(_np_tree(params), cfg, device="cpu")
    state = opt_state_from_jax(_np_tree(opt), model)
    assert int(state.step) == 1

    before = {n: p.detach().float().clone()
              for n, p in model.named_parameters()}
    params, opt, jm = jstep(params, opt, jbatch)
    model, state, m = make_train_step(cfg, microbatches=microbatches,
                                      lr=LR)(model, state, batch)
    exp = from_jax_params(_np_tree(params), cfg, device="cpu")
    exp_state = opt_state_from_jax(_np_tree(opt), exp)

    assert abs(float(m["loss"]) - float(jm["loss"])) <= tol["loss"]
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=tol["grad_norm"])
    assert int(state.step) == int(exp_state.step) == 2
    assert _rel_l2(state.mu, exp_state.mu) <= tol["moments"]
    assert _rel_l2(state.nu, exp_state.nu) <= tol["moments"]
    want = dict(exp.named_parameters())
    got = dict(model.named_parameters())
    limits = {torch.float32: tol["update" if microbatches == 1
                                 else "update_microbatched"],
              torch.bfloat16: tol["update_bf16"]}
    for dtype, limit in limits.items():
        names = [n for n, p in got.items() if p.dtype == dtype]
        assert names and all(want[n].dtype == dtype for n in names)
        update = {n: got[n].detach().float() - before[n] for n in names}
        exp_update = {n: want[n].detach().float() - before[n] for n in names}
        assert _rel_l2(update, exp_update) <= limit, dtype


def test_microbatched_train_matches_single():
    """The JAX package's test_microbatched_train_matches_single, ported:
    two microbatches against one, on the port's own weights."""
    cfg = reduced_config(get_config("qwen3-14b"))
    gen = torch.Generator().manual_seed(2)
    model = M.init_params(cfg, gen, device="cpu")
    batch = materialize_batch(cfg, ShapeConfig("s", 16, 4, "train"), gen,
                              device="cpu")["batch"]
    results = []
    for microbatches in (1, 2):
        copy = M.LM(cfg, device="cpu")
        copy.load_state_dict(model.state_dict())
        _, _, m = make_train_step(cfg, microbatches=microbatches)(
            copy, adamw_init(copy), batch)
        results.append(m)
    m1, m2 = results
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 5e-3
    assert abs(float(m1["grad_norm"]) - float(m2["grad_norm"])) < 5e-2


def _loss_and_grads(model, batch, remat):
    logits = M.forward(model, batch["inputs"], use_kernel=False, remat=remat)
    labels = batch["labels"].long()
    loss = torch.nn.functional.cross_entropy(
        logits.float().flatten(0, 1), labels.flatten())
    names, params = zip(*model.named_parameters())
    return loss, dict(zip(names, torch.autograd.grad(loss, params)))


@pytest.mark.parametrize("arch,periods,group", [
    ("mamba2-130m", 16, None),   # 16 periods, the JAX package's SQRT_GROUP 8
    ("zamba2-1.2b", 4, 2),       # the shared block; SQRT_GROUP set to 2
])
def test_remat_modes_agree(monkeypatch, arch, periods, group):
    """remat off, per_period and sqrt: equal losses and gradients, and the
    number of checkpointed calls each mode makes in the forward."""
    base = reduced_config(get_config(arch))
    cfg = dataclasses.replace(
        base, num_layers=periods * base.pattern_period
        + len(base.tail_pattern))
    assert cfg.num_periods == periods
    if group is not None:
        monkeypatch.setattr(M, "SQRT_GROUP", group)
    model = M.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    batch = materialize_batch(cfg, ShapeConfig("s", 16, 2, "train"),
                              torch.Generator().manual_seed(4),
                              device="cpu")["batch"]
    calls = []
    checkpointed = M._checkpointed
    monkeypatch.setattr(M, "_checkpointed",
                        lambda fn, *a: calls.append(1) or checkpointed(fn, *a))
    runs = {}
    for mode, remat in (("none", False), ("per_period", True),
                        ("sqrt", True)):
        M.set_remat_mode("sqrt" if mode == "sqrt" else "per_period")
        try:
            calls.clear()
            logits = M.forward(model, batch["inputs"], use_kernel=False,
                               remat=remat)
            forward_calls = len(calls)
            del logits
            runs[mode] = (_loss_and_grads(model, batch, remat), forward_calls)
        finally:
            M.set_remat_mode("per_period")
    sqrt_group = M.SQRT_GROUP
    assert runs["none"][1] == 0
    assert runs["per_period"][1] == periods
    assert runs["sqrt"][1] == periods + periods // sqrt_group
    (loss0, grads0), _ = runs["none"]
    for mode in ("per_period", "sqrt"):
        (loss, grads), _ = runs[mode]
        assert torch.equal(loss, loss0), mode
        for name, g in grads0.items():
            assert torch.equal(grads[name], g), (mode, name)
    if cfg.shared_attention:
        assert float(grads0["shared.attn.wq"].float().abs().sum()) > 0


def _ssd_inputs(b=2, s=64, h=3, p=8, n=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dA = -rng.uniform(0.01, 0.5, size=(b, s, h)).astype(np.float32)
    Bm = rng.normal(size=(b, s, n)).astype(np.float32)
    Cm = rng.normal(size=(b, s, n)).astype(np.float32)
    wy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    ws = rng.normal(size=(b, h, p, n)).astype(np.float32)
    return (x, dA, Bm, Cm), (wy, ws)


def test_ssd_reference_gradients_match_jax():
    """The plain scan under autograd: gradients of sum(y * wy) +
    sum(final_state * ws) with respect to x, dA, B and C equal
    jax.grad of the JAX package's chunked scan to float32 rounding
    (rtol 1e-4, atol 1e-4 of the largest gradient)."""
    (x, dA, Bm, Cm), (wy, ws) = _ssd_inputs()
    chunk = 16

    def jloss(*args):
        y, final = jx_mamba2.ssd_reference(*args, chunk=chunk)
        return jnp.sum(y * wy) + jnp.sum(final * ws)

    exp = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x, dA, Bm, Cm)))
    ins = [torch.tensor(a, requires_grad=True) for a in (x, dA, Bm, Cm)]
    y, final = ssd_reference(*ins, chunk=chunk)
    loss = (y * torch.from_numpy(wy)).sum() + \
        (final * torch.from_numpy(ws)).sum()
    got = torch.autograd.grad(loss, ins)
    for name, g, e in zip(("x", "dA", "B", "C"), got, exp):
        e = np.asarray(e)
        np.testing.assert_allclose(g.numpy(), e, rtol=1e-4,
                                   atol=1e-4 * np.abs(e).max(), err_msg=name)


def test_ssd_reference_same_values_with_and_without_autograd():
    """Out-of-place products under autograd, in place otherwise: the same
    bits either way."""
    (x, dA, Bm, Cm), _ = _ssd_inputs(seed=1)
    ins = [torch.from_numpy(a) for a in (x, dA, Bm, Cm)]
    with torch.inference_mode():
        y0, s0 = ssd_reference(*ins, chunk=16)
    y1, s1 = ssd_reference(*(t.clone().requires_grad_() for t in ins),
                           chunk=16)
    assert torch.equal(y0, y1.detach()) and torch.equal(s0, s1.detach())


@pytest.fixture()
def fake_card(monkeypatch):
    """The wrappers' device rule says 'card' for CPU tensors, and the
    launches record their calls instead of reaching a library."""
    launched = []
    monkeypatch.setattr(_build, "takes_kernel", lambda *t: True)
    monkeypatch.setattr(ssd_ops, "_launch",
                        lambda name, *a: launched.append(name))
    monkeypatch.setattr(flash_ops, "launch_route",
                        lambda q, k, v, causal, kind:
                        launched.append(kind) or torch.empty_like(q))
    return launched


def test_cuda_wrappers_refuse_autograd(fake_card):
    """ssd_scan_cuda and flash_attention_cuda raise, naming the plain
    route, where grad is enabled and an input requires it, before any
    launch; under no_grad (or with no input requiring grad) they launch."""
    (x, dA, Bm, Cm), _ = _ssd_inputs(b=1, s=32, seed=2)
    ins = [torch.from_numpy(a) for a in (x, dA, Bm, Cm)]
    xg = ins[0].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="ssd_reference"):
        ssd_ops.ssd_scan_cuda(xg, *ins[1:], chunk=16)
    q = torch.randn(1, 2, 64, 16, generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="attention_ref"):
        flash_ops.flash_attention_cuda(q.clone().requires_grad_(), q, q)
    assert fake_card == []
    with torch.no_grad():
        ssd_ops.ssd_scan_cuda(xg, *ins[1:], chunk=16)
        flash_ops.flash_attention_cuda(q.clone().requires_grad_(), q, q)
    ssd_ops.ssd_scan_cuda(*ins, chunk=16)
    assert fake_card == list(ssd_ops.PASSES) + ["tf32x3"] + \
        list(ssd_ops.PASSES)


def test_forward_with_the_kernel_refuses_autograd(fake_card):
    """A forward that would launch ssd_scan under autograd raises; the
    train step's forward (use_kernel=False) does not reach the kernel."""
    cfg = reduced_config(get_config("mamba2-130m"))
    model = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.zeros((1, 16), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="ssd_reference"):
        M.forward(model, tokens)
    _, _, m = make_train_step(cfg)(model, adamw_init(model),
                                   {"inputs": tokens, "labels": tokens})
    assert fake_card == [] and np.isfinite(float(m["loss"]))


def test_opt_state_from_jax_unstacks_periods():
    """mu and nu leave the JAX tree period by period, as the parameters
    do; a tree of another shape is refused."""
    jcfg = jx_reduced_config(jx_get_config("zamba2-1.2b"))
    cfg = reduced_config(get_config("zamba2-1.2b"))
    params = _np_tree(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    model = from_jax_params(params, cfg, device="cpu")
    mu = jax.tree.map(lambda p: np.asarray(p, np.float32) + 1, params)
    nu = jax.tree.map(lambda p: np.asarray(p, np.float32) * 2, params)
    state = opt_state_from_jax((np.int32(7), mu, nu), model)
    assert isinstance(state, AdamWState) and int(state.step) == 7
    for name, p in model.named_parameters():
        assert torch.equal(state.mu[name], p.detach().float() + 1), name
        assert torch.equal(state.nu[name], p.detach().float() * 2), name
    with pytest.raises(ValueError, match="final_norm"):
        opt_state_from_jax((np.int32(0), dict(mu, final_norm=np.zeros(
            3, np.float32)), nu), model)


def test_lm_from_warehouse_main_learns(tmp_path, capsys):
    """The warehouse-fed train loop at a tiny size under engine 'ref' on
    the CPU: the loss falls as examples/train_lm.py requires (the last 20
    steps' mean 0.2 below the first 20's, asserted inside main), the async
    checkpoint of step 100 is written and restored, and the SIGTERM
    handler is restored."""
    before = signal.getsignal(signal.SIGTERM)
    losses = lm_from_warehouse.main([
        "--engine", "ref", "--device", "cpu", "--steps", "100",
        "--work-dir", str(tmp_path)])
    assert len(losses) == 100 and all(np.isfinite(losses))
    assert np.mean(losses[-20:]) < np.mean(losses[:20]) - 0.2
    assert signal.getsignal(signal.SIGTERM) == before
    assert (tmp_path / "warehouse").is_dir()
    steps = sorted(p.name for p in (tmp_path / "checkpoints").iterdir())
    assert steps == ["step_0000000100"]
    assert (tmp_path / "checkpoints" / steps[0] / "manifest.json").is_file()
    assert "checkpoint restore OK (step 100)" in capsys.readouterr().out


def test_batches_from_warehouse_match_the_corpus(tmp_path):
    """The SQL pipeline returns the train split's tokens in document
    order, and packs them into int32 inputs with next-token labels."""
    from repro_torch.core.session import Warehouse

    wh = Warehouse(str(tmp_path / "wh"))
    try:
        lm_from_warehouse.build_corpus(wh, 64, n_docs=20, doc_len=16)
        toks = lm_from_warehouse.split_tokens(wh, "train", engine="ref")
        every = wh.session(engine="ref").execute(
            "SELECT doc_id, pos, tok FROM tokens ORDER BY doc_id, pos").rows
        exp = [t for d, _, t in every if d % 10 != 0]
        assert toks.dtype == np.int32 and toks.tolist() == exp
        data = lm_from_warehouse.batches_from_warehouse(
            wh, "train", 2, 8, 64, engine="ref", device="cpu")
        b = next(data)
    finally:
        wh.close()
    assert b["inputs"].shape == b["labels"].shape == (2, 8)
    assert b["inputs"].dtype == torch.int32
    for x, y in zip(b["inputs"].tolist(), b["labels"].tolist()):
        assert x[1:] == y[:-1]
