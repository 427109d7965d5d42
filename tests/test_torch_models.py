"""The port's LM side (repro_torch.models, .train.steps) against the JAX
package's, on reduced configs on the CPU.

Weights are the JAX package's ``init_params`` carried across by
``repro_torch.models.convert``; token inputs come from numpy seeds.  The
port's ``ssd_scan`` wrapper takes its plain version on CPU tensors, so
``use_kernel`` both ways runs the plain scan here (the CUDA kernel is held to
it in test_torch_cuda.py).

Tolerances, on bfloat16 logits:
- Mamba2 paths compute what the JAX package computes, cast for cast, and
  agree to atol 1e-2 (a bfloat16 step near 1; observed: equal);
- attention archs use torch's fused silu/gelu, which round once where JAX
  rounds after each op of x * sigmoid(x), so they agree to atol/rtol 0.15,
  the JAX package's own decode-vs-forward bound for bfloat16 differences
  (observed up to 0.11 on logits near 3.5);
- the MoE archs have no dense MLP, and the port's forward equals the JAX
  package's op-by-op forward bit for bit, but ``JM.forward`` is compiled
  (lax.scan, fused ops) and rounds elsewhere, so they take the attention
  archs' bound too (observed: forward 0.055, decode 0.047).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jx_get_config
from repro.configs.base import reduced_config as jx_reduced_config
from repro.models import layers as jx_layers
from repro.models import mamba2 as jx_mamba2
from repro.models import model as JM
from repro.models.layers import NOSHARD as JX_NOSHARD
from repro.train.steps import make_prefill_step as jx_make_prefill_step
from repro.train.steps import make_serve_step as jx_make_serve_step
from repro.train.steps import softmax_xent as jx_softmax_xent
from repro_torch.configs.base import (ARCH_IDS, ShapeConfig, get_config,
                                      reduced_config)
from repro_torch.models import model as M
from repro_torch.models.convert import from_jax_params, to_tensor
from repro_torch.models.layers import init_attention, init_mlp
from repro_torch.models.mamba2 import init_mamba2, mamba2_forward
from repro_torch.train.steps import (input_specs, make_prefill_step,
                                     make_serve_step, materialize_batch,
                                     softmax_xent)

MOE_ARCHS = ["olmoe-1b-7b", "grok-1-314b"]
SSM_TOL = dict(atol=1e-2, rtol=0)
ATTN_TOL = dict(atol=0.15, rtol=0.15)


def _tol(cfg):
    return SSM_TOL if cfg.family == "ssm" else ATTN_TOL


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(JAX cfg, JAX params, port cfg, port model on the CPU)."""
    jcfg = jx_reduced_config(jx_get_config(arch))
    params = JM.init_params(jcfg, jax.random.PRNGKey(1))
    cfg = reduced_config(get_config(arch))
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    return jcfg, params, cfg, model


def _inputs(cfg, B, S, seed=0):
    """Tokens (or frontend embeddings for the stub archs) as (jax, torch)."""
    rng = np.random.default_rng(seed)
    if cfg.embedding_stub:
        emb = (rng.normal(size=(B, S, cfg.d_model)) * 0.5).astype(np.float32)
        return (jnp.asarray(emb, jnp.bfloat16),
                torch.from_numpy(emb).to(torch.bfloat16))
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return jnp.asarray(toks), torch.from_numpy(toks)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_jax(arch):
    jcfg, params, cfg, model = _pair(arch)
    jin, tin = _inputs(cfg, 2, 16)
    exp = _f32(JM.forward(params, jcfg, jin, remat=False))
    with torch.inference_mode():
        got = M.forward(model, tin)
    assert got.dtype == torch.bfloat16 and got.shape == exp.shape
    np.testing.assert_allclose(_f32(got), exp, **_tol(cfg))
    if cfg.ssm is not None:
        with torch.inference_mode():
            plain = M.forward(model, tin, use_kernel=False)
        np.testing.assert_allclose(_f32(plain), _f32(got), **SSM_TOL)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_mamba2_block_matches_jax(use_kernel):
    """One Mamba2 block, with the JAX package's use_kernel the same way
    (True: its Pallas kernel in interpret mode)."""
    jcfg, params, cfg, model = _pair("mamba2-130m")
    p = jax.tree.map(lambda a: a[0], params["scan"][0]["mamba"])
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(2, 32, cfg.d_model)) * 0.5).astype(np.float32)
    exp = jx_mamba2.mamba2_forward(p, jnp.asarray(x, jnp.bfloat16), jcfg,
                                   JX_NOSHARD, use_kernel=use_kernel)
    with torch.inference_mode():
        got = mamba2_forward(model.layers[0].mamba,
                             torch.from_numpy(x).to(torch.bfloat16), cfg,
                             use_kernel=use_kernel)
    np.testing.assert_allclose(_f32(got), _f32(exp), **SSM_TOL)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"] + MOE_ARCHS)
def test_prefill_step_matches_jax(arch):
    jcfg, params, cfg, model = _pair(arch)
    jin, tin = _inputs(cfg, 2, 16, seed=1)
    exp = np.asarray(jx_make_prefill_step(jcfg)(params, jin))
    got = make_prefill_step(cfg)(model, tin)
    assert got.dtype == torch.int32
    if cfg.family == "ssm":
        assert np.array_equal(got.numpy(), exp)
    else:  # near-ties among random logits may flip: compare the logits
        with torch.inference_mode():
            logits = _f32(M.forward(model, tin)[:, -1])
        picked = logits[np.arange(2), exp]
        np.testing.assert_allclose(logits.max(-1), picked, **ATTN_TOL)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b", "qwen3-14b"]
                         + MOE_ARCHS)
def test_decode_step_matches_jax(arch):
    """Eight tokens through both decode steps, from empty caches."""
    jcfg, params, cfg, model = _pair(arch)
    B, S = 2, 8
    jin, tin = _inputs(cfg, B, S, seed=2)
    jcache = JM.init_cache(jcfg, B, S)
    cache = M.init_cache(cfg, B, S, device="cpu")
    for t in range(S):
        exp, jcache = JM.decode_step(params, jcache, jin[:, t], jnp.int32(t),
                                     jcfg)
        got, cache = M.decode_step(model, cache, tin[:, t], t)
        np.testing.assert_allclose(_f32(got), _f32(exp), **_tol(cfg))


def test_serve_step_matches_jax():
    jcfg, params, cfg, model = _pair("mamba2-130m")
    jin, tin = _inputs(cfg, 4, 6, seed=3)
    jserve = jx_make_serve_step(jcfg)
    serve = make_serve_step(cfg)
    jcache = JM.init_cache(jcfg, 4, 6)
    cache = M.init_cache(cfg, 4, 6, device="cpu")
    for t in range(6):
        exp, jcache = jserve(params, jcache, jin[:, t], jnp.int32(t))
        got, cache = serve(model, cache, tin[:, t], t)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(exp))


@pytest.mark.parametrize("arch", ["qwen3-14b", "mamba2-130m", "zamba2-1.2b",
                                  "gemma3-27b"])
def test_decode_matches_forward(arch):
    """The port alone, with its own weights: prefill by repeated decode
    equals the full forward's last logits (the JAX package's
    test_decode_matches_forward, atol/rtol 0.15 for bfloat16)."""
    cfg = reduced_config(get_config(arch))
    gen = torch.Generator().manual_seed(1)
    model = M.init_params(cfg, gen, device="cpu")
    B, S = 2, 8
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    with torch.inference_mode():
        full = M.forward(model, tokens)
    cache = M.init_cache(cfg, B, S, device="cpu")
    for t in range(S):
        logits, cache = M.decode_step(model, cache, tokens[:, t], t)
    np.testing.assert_allclose(_f32(logits), _f32(full[:, -1]), **ATTN_TOL)
    assert (logits.float().argmax(-1) == full[:, -1].float().argmax(-1)).all()


def test_init_draws_like_jax():
    """The port's initializers draw what the JAX package's draw, from other
    random numbers: constant leaves equal (A_log to float32 rounding), the
    rest normals truncated at 2 standard deviations of 1/sqrt(fan_in), with
    the sample std within 10% of the JAX sample's."""
    jcfg = jx_reduced_config(jx_get_config("qwen3-14b"))
    jcfg_ssm = jx_reduced_config(jx_get_config("zamba2-1.2b"))
    cfg = reduced_config(get_config("qwen3-14b"))
    cfg_ssm = reduced_config(get_config("zamba2-1.2b"))
    key = jax.random.PRNGKey(0)
    gen = torch.Generator().manual_seed(0)
    pairs = [(jx_mamba2.init_mamba2(key, jcfg_ssm),
              init_mamba2(cfg_ssm, gen, device="cpu")),
             (jx_layers.init_attention(key, jcfg),
              init_attention(cfg, gen, device="cpu")),
             (jx_layers.init_mlp(key, jcfg), init_mlp(cfg, gen, device="cpu"))]
    for jtree, module in pairs:
        params = dict(module.named_parameters())
        assert set(params) == set(jtree)
        for name, p in params.items():
            j = np.asarray(jtree[name])
            assert p.dtype == to_tensor(j).dtype and p.shape == j.shape, name
            j, t = j.astype(np.float32), p.detach().float().numpy()
            if j.std() == 0 or name == "A_log":
                np.testing.assert_allclose(t, j, rtol=1e-6, err_msg=name)
                continue
            bound = 2.0 / np.sqrt(j.shape[0]) * (1 + 2 ** -7)  # bf16 step
            assert np.abs(t).max() <= bound, name
            assert abs(t.std() / j.std() - 1) < 0.1, name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count_matches_analytic(arch):
    cfg = reduced_config(get_config(arch))
    model = M.LM(cfg, device="meta")
    actual = sum(p.numel() for p in model.parameters())
    assert abs(actual - cfg.param_count()) / cfg.param_count() < 0.02


def test_full_mamba2_130m_shapes():
    """The published config at full width and depth, on the meta device:
    24 layers and every parameter of the JAX package's tree (128,983,488;
    ``param_count()``'s analytic 128.9 M leaves out the conv bias, dt bias
    and the B/C conv channels), embedding tied."""
    cfg = get_config("mamba2-130m")
    model = M.LM(cfg, device="meta")
    assert len(model.layers) == 24 and model.lm_head is None
    tree = jax.eval_shape(lambda: JM.init_params(
        jx_get_config("mamba2-130m"), jax.random.PRNGKey(0)))
    expected = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(tree))
    assert sum(p.numel() for p in model.parameters()) == expected
    assert model.layers[0].mamba.in_proj.shape == (768, 3352)


def test_convert_refuses_a_mismatched_tree():
    jcfg, params, cfg, _ = _pair("mamba2-130m")
    tree = jax.tree.map(np.asarray, params)
    with pytest.raises(ValueError, match="lm_head"):
        from_jax_params({**tree, "lm_head": tree["embed"]}, cfg, device="cpu")
    bad = dict(tree, final_norm=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        from_jax_params(bad, cfg, device="cpu")


def test_to_tensor_keeps_bfloat16_bits():
    x = np.asarray(jnp.asarray([1.0, -2.5, 3.140625, 1e-3], jnp.bfloat16))
    assert x.dtype.name == "bfloat16"
    t = to_tensor(x)
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy(), x.view(np.int16))


def test_softmax_xent_matches_jax():
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    exp = float(jx_softmax_xent(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(softmax_xent(torch.from_numpy(logits),
                             torch.from_numpy(labels)))
    assert abs(got - exp) < 1e-5


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_materialize_batch_follows_specs(kind):
    cfg = reduced_config(get_config("zamba2-1.2b"))
    shape = ShapeConfig("s", 16, 3, kind)
    gen = torch.Generator().manual_seed(0)
    batch = materialize_batch(cfg, shape, gen, device="cpu")
    specs = input_specs(cfg, shape)
    assert batch["inputs"].shape == specs["inputs"].shape
    assert batch["inputs"].dtype == torch.int32
    assert 0 <= int(batch["inputs"].min()) <= int(batch["inputs"].max()) \
        < cfg.vocab_size
    if kind == "decode":
        assert int(batch["pos"]) == 0
        assert len(batch["cache"]) == cfg.num_layers
        for got, spec in zip(batch["cache"], specs["cache"]):
            assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} \
                == {k: tuple(s) for k, s in spec.items()}
