"""The port's MoE FFN (repro_torch.models.moe) against the JAX package's
(repro.models.moe), on both MoE archs' reduced configs on the CPU.

Weights are the JAX package's ``init_moe`` carried across by
``convert.to_tensor``; inputs come from numpy seeds.  Two inputs per arch:
``random`` (2 x 16 normal rows, which drop no slot) and ``skewed`` (32
copies of one row: every token picks the same k experts, so half of the 64
slots pass the capacity of 24 and drop).

Tolerances:
- routing (experts, positions, kept slots, dropped counts) is exact: the
  port's counts equal a count in numpy over JAX's own router logits;
- ``moe_ffn`` equals the JAX package's bit for bit (observed: equal).  The
  experts' silu is the JAX package's x * 1 / (1 + exp(-x)) with each op
  rounded to bfloat16, as XLA computes it on the CPU (torch's fused silu
  rounds once, and its outputs differ by up to a bfloat16 step).  The
  combine adds the k gated slots in bfloat16 in slot order, as XLA's
  ``segment_sum`` does; a float32 sum rounded once would differ by a
  bfloat16 rounding;
- ``moe_ffn`` against the plain per-expert loop (float32 sums of the gated
  outputs, one rounding): atol 2^-7 of the largest |y| (observed: equal,
  since k = 2 here);
- gradients against ``jax.grad``, relative L2 error: the expert weights
  1e-3 (observed: equal; the logistic's derivative is JAX's s * (1 - s),
  op for op), the input 1e-2 (observed 3.4e-3) and the float32 router 0.1
  (observed 8.9e-3 on random rows, 5.1e-2 on the skewed ones).  The
  router's gradient passes through each gate's cotangent, a sum over
  d_model of bfloat16 products: XLA adds them in bfloat16, torch in
  float32 with one rounding, nearer the exact sum (on 32 x 64 products of
  magnitude 30, relative errors 5.5e-3 and 1.8e-3 against float64); the
  skewed input repeats one token, so its error does not average out.  A
  router gradient with the gates' path cut reads 1;
- the load-balancing loss: rtol 1e-6 (float32; observed equal).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jx_get_config
from repro.configs.base import reduced_config as jx_reduced_config
from repro.models import layers as jx_layers
from repro.models import model as JM
from repro.models import moe as jx_moe
from repro_torch.configs.base import get_config, reduced_config
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.models.convert import from_jax_params, to_tensor

MOE_ARCHS = ["olmoe-1b-7b", "grok-1-314b"]
INPUTS = ["random", "skewed"]
GRAD_TOL = {"router": 0.1, "w_gate": 1e-3, "w_up": 1e-3, "w_down": 1e-3,
            "x": 1e-2}


def _pair(arch):
    jcfg = jx_reduced_config(jx_get_config(arch))
    cfg = reduced_config(get_config(arch))
    jp = jx_moe.init_moe(jax.random.PRNGKey(3), jcfg)
    p = MOE.MoE(cfg, device="cpu")
    with torch.no_grad():
        for name, t in p.named_parameters():
            t.copy_(to_tensor(np.asarray(jp[name])))
    return jcfg, jp, cfg, p


def _x(cfg, kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        x = rng.normal(size=(2, 16, cfg.d_model))
    else:
        x = np.repeat(rng.normal(size=(1, 1, cfg.d_model)), 32, axis=1)
    x = x.astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _np_routing(jp, jx, jcfg):
    """(experts, positions, kept) by a count in numpy over the JAX
    package's router logits and its top-k."""
    m = jcfg.moe
    T = jx.shape[0] * jx.shape[1]
    logits = jx.reshape(T, -1).astype(jnp.float32) @ jp["router"]
    topi = np.asarray(jax.lax.top_k(logits, m.top_k)[1])
    C = MOE.capacity(T, m.top_k, m.num_experts, m.capacity_factor)
    pos = np.zeros_like(topi)
    seen = np.zeros(m.num_experts, np.int64)
    for t in range(T):
        for j in range(m.top_k):
            pos[t, j] = seen[topi[t, j]]
            seen[topi[t, j]] += 1
    return topi, pos, pos < C


def _f32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("kind", INPUTS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_matches_numpy_count(arch, kind):
    jcfg, jp, cfg, p = _pair(arch)
    jx, tx = _x(cfg, kind)
    topi, pos, keep = _np_routing(jp, jx, jcfg)
    r = MOE.route(p, tx, cfg)
    assert np.array_equal(r.topi.numpy(), topi)
    assert np.array_equal(r.pos.numpy(), pos)
    assert np.array_equal(r.keep.numpy(), keep)
    dropped = int((~r.keep).sum())
    if kind == "random":
        assert dropped == 0
    else:  # 32 tokens x 2 slots on 2 experts, 24 slots each
        assert r.C == 24 and dropped == int((~keep).sum()) == 16


@pytest.mark.parametrize("kind", INPUTS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_jax(arch, kind):
    jcfg, jp, cfg, p = _pair(arch)
    jx, tx = _x(cfg, kind)
    exp = _f32(jx_moe.moe_ffn(jp, jx, jcfg, jx_layers.NOSHARD))
    with torch.inference_mode():
        got = MOE.moe_ffn(p, tx, cfg)
    assert got.dtype == torch.bfloat16 and got.shape == tx.shape
    assert np.array_equal(_f32(got), exp)
    if kind == "skewed":  # dropped slots give 0: the later tokens differ
        assert not np.array_equal(exp[0, 0], exp[0, -1])


@pytest.mark.parametrize("kind", INPUTS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_expert_loop(arch, kind):
    _, _, cfg, p = _pair(arch)
    _, tx = _x(cfg, kind, seed=1)
    with torch.inference_mode():
        got = MOE.moe_ffn(p, tx, cfg)
        exp, keep = MOE.moe_ffn_loop(p, tx, cfg)
        assert torch.equal(keep, MOE.route(p, tx, cfg).keep)
    scale = float(exp.float().abs().max())
    np.testing.assert_allclose(_f32(got), _f32(exp), rtol=0,
                               atol=2 ** -7 * scale)


@pytest.mark.parametrize("T,k,E,C", [(65_536, 8, 64, 10_240), (128, 8, 64, 24),
                                     (32, 2, 4, 24), (1, 2, 4, 8)])
def test_capacity(T, k, E, C):
    """olmoe's prefill of 2 x 32,768 tokens and its decode at batch 128;
    the reduced configs' 32 tokens and a single token (the floor of 8)."""
    assert MOE.capacity(T, k, E, 1.25) == C


def test_top_k_ties_take_the_lower_index_first():
    logits = np.array([[1.0, 3.0, 3.0, 0.0, 3.0],
                       [2.0, 2.0, 2.0, 2.0, 2.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(logits), 3)
    tv, ti = MOE.top_k(torch.from_numpy(logits), 3)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_aux_load_balance_loss_matches_jax(arch):
    jcfg, jp, cfg, p = _pair(arch)
    jx, tx = _x(cfg, "random", seed=2)
    exp = float(jx_moe.aux_load_balance_loss(jp, jx, jcfg))
    with torch.no_grad():
        got = float(MOE.aux_load_balance_loss(p, tx, cfg))
    np.testing.assert_allclose(got, exp, rtol=1e-6)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_draws_like_init_moe(arch):
    """Shapes and dtypes of ``init_moe``'s tree; normals truncated at 2
    standard deviations of 1/sqrt(shape[0]), the fan_in the JAX package's
    ``trunc_normal`` takes: the expert count for the expert weights
    (ROADMAP C8).  Both samples' std lie within 4 standard errors of the
    truncated normal's, 0.8796 / sqrt(fan_in)."""
    jcfg = jx_reduced_config(jx_get_config(arch))
    cfg = reduced_config(get_config(arch))
    jtree = jx_moe.init_moe(jax.random.PRNGKey(0), jcfg)
    p = MOE.init_moe(cfg, torch.Generator().manual_seed(0), device="cpu")
    params = dict(p.named_parameters())
    assert set(params) == set(jtree)
    for name, t in params.items():
        j = np.asarray(jtree[name])
        assert t.dtype == to_tensor(j).dtype and t.shape == j.shape, name
        fan_in = cfg.d_model if name == "router" else cfg.moe.num_experts
        assert j.shape[0] == fan_in, name
        std = 0.8796 / np.sqrt(fan_in)
        for sample in (j.astype(np.float32), _f32(t)):
            bound = 2.0 / np.sqrt(fan_in) * (1 + 2 ** -7)  # a bf16 step
            assert np.abs(sample).max() <= bound
            assert abs(sample.std() / std - 1) < 4 / np.sqrt(2 * sample.size)


def _rel(got, exp):
    return float(np.linalg.norm(got - exp) / np.linalg.norm(exp))


@pytest.mark.parametrize("kind", INPUTS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_grads_match_jax(arch, kind):
    """d/d(router, w_gate, w_up, w_down, x) of sum(moe_ffn(x) * g), a fixed
    random g, against ``jax.grad``; with the skewed input the dropped slots
    get no gradient on either side."""
    jcfg, jp, cfg, p = _pair(arch)
    jx, tx = _x(cfg, kind, seed=4)
    g = np.random.default_rng(5).normal(size=tx.shape).astype(np.float32)

    def jloss(params, x):
        y = jx_moe.moe_ffn(params, x, jcfg, jx_layers.NOSHARD)
        return jnp.sum(y.astype(jnp.float32) * g)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    tx = tx.clone().requires_grad_(True)
    loss = (MOE.moe_ffn(p, tx, cfg).float() * torch.from_numpy(g)).sum()
    names, params = zip(*p.named_parameters())
    grads = torch.autograd.grad(loss, params + (tx,))
    for name, got in zip(names + ("x",), grads):
        exp = jgx if name == "x" else jgp[name]
        assert got.dtype == to_tensor(np.asarray(exp)).dtype, name
        assert _rel(_f32(got), _f32(exp)) <= GRAD_TOL[name], name


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_model_drops_match_jax(monkeypatch, arch):
    """One token repeated through the whole reduced model: every position
    gives the same layer input, so every layer drops.  Each layer's dropped
    count in the port's forward equals the count in numpy over the JAX
    package's layer inputs (its blocks applied one by one), and the logits
    agree within the attention archs' bound (test_torch_models.py)."""
    jcfg = jx_reduced_config(jx_get_config(arch))
    cfg = reduced_config(get_config(arch))
    params = JM.init_params(jcfg, jax.random.PRNGKey(1))
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    tokens = np.full((2, 16), 7, np.int32)

    expected = []
    h = jnp.take(params["embed"], jnp.asarray(tokens), axis=0)
    h = h.astype(jnp.bfloat16)
    for i in range(cfg.num_layers):
        bp = jax.tree.map(lambda a: a[i], params["scan"][0])
        h = h + jx_layers.attention(bp["attn"], jx_layers.rms_norm(
            h, bp["ln1"]), jcfg, jx_layers.NOSHARD)
        ff_in = jx_layers.rms_norm(h, bp["ln2"])
        expected.append(int((~_np_routing(bp["moe"], ff_in, jcfg)[2]).sum()))
        h = h + jx_moe.moe_ffn(bp["moe"], ff_in, jcfg, jx_layers.NOSHARD)

    got = []
    route = MOE.route

    def counting(p, x, c):
        r = route(p, x, c)
        got.append(int((~r.keep).sum()))
        return r

    monkeypatch.setattr(MOE, "route", counting)
    with torch.inference_mode():
        logits = M.forward(model, torch.from_numpy(tokens))
    assert got == expected and min(got) > 0
    exp = _f32(JM.forward(params, jcfg, jnp.asarray(tokens), remat=False))
    np.testing.assert_allclose(_f32(logits), exp, atol=0.15, rtol=0.15)
