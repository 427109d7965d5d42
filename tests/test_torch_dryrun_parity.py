"""The dry run's counts held to the JAX package's, on the CPU.

FLOP parity at one device: for every arch at its reduced config, the
port's ``CostMode`` over its prefill (B 2, S 256), one decode step (B 2
against a cache of 256) and its train step (B 4, S 128, 2 microbatches,
remat) on the meta device counts the FLOPs that ``repro``'s
``analyze_hlo`` counts in the same step's optimized HLO, less the
reference's convolution overcount (ROADMAP C14): ``_conv_flops`` reads
the output features from the output's dim 1, which XLA's layout of the
depthwise causal conv makes 1, and never uses ``feature_group_count``.
The test computes that overcount from the HLO's convolution lines: it
reruns ``analyze_hlo`` with the true count, 2 · output elements · kernel
elements ÷ the kernel's output features (its ``o`` in ``dim_labels``).

Sharded numerics: on 8 gloo ranks, the (2, 4) debug mesh, every reduced
arch's forward with DTensor parameters placed by the resolver and a batch
split over ``data`` returns the unsharded forward's logits (this file is
the ranks' program: ``python tests/test_torch_dryrun_parity.py <rank>
<world> <dir>``).  The tolerance is ``test_torch_models.py``'s bfloat16
bound, atol/rtol 0.15, for every arch: a product whose contraction is
split over the mesh adds bfloat16 partial results where the unsharded one
rounds once.

olmoe-1b-7b's drop share: the same full-width layer-0 weights in both
packages, one 4,096-token sequence of random tokens, whose router is
skewed; the same per-expert loads and dropped slots given the same router
input, and from each package's own attention they differ only at router
near-ties (ROADMAP's open check on PERF.md's 15.09%).
"""
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest

from repro_torch.configs.base import ARCH_IDS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TIMEOUT_S = 240  # the 8 ranks; a hung rendezvous fails the test
SHAPES = {"prefill": (2, 256), "decode": (2, 256), "train": (4, 128)}
MICROBATCHES = 2
SHARDED_TOL = dict(atol=0.15, rtol=0.15)


# ---------------------------------------------------------------------------
# FLOP parity
# ---------------------------------------------------------------------------
def _true_conv_flops(instr, comp) -> float:
    """2 · output elements · kernel elements ÷ the kernel's output
    features, read from the instruction's ``dim_labels``."""
    from repro.launch.hlo_analysis import _parse_shapes

    out = _parse_shapes(instr.shape_sig)[0][1]
    kern = _parse_shapes(comp.table[instr.operands[1]])[0][1]
    labels = re.search(r"dim_labels=\w+_(\w+)->", instr.line).group(1)
    return 2.0 * np.prod(out) * np.prod(kern) / kern[labels.index("o")]


def jax_flops(arch: str, kind: str, monkeypatch) -> tuple:
    """(analyze_hlo's FLOPs, the same with the true convolution count, the
    same with none) of ``repro``'s step, lowered and compiled on the
    CPU."""
    import jax
    import jax.numpy as jnp

    import repro.launch.hlo_analysis as H
    from repro.configs.base import get_config, reduced_config
    from repro.models import model as JM
    from repro.train.optimizer import adamw_init
    from repro.train.steps import (make_prefill_step, make_serve_step,
                                   make_train_step)

    cfg = reduced_config(get_config(arch))
    B, S = SHAPES[kind]
    params = jax.eval_shape(lambda: JM.init_params(cfg, jax.random.PRNGKey(0)))
    tok = (jax.ShapeDtypeStruct((B, S, cfg.d_model), jnp.bfloat16)
           if cfg.embedding_stub else jax.ShapeDtypeStruct((B, S), jnp.int32))
    if kind == "prefill":
        lowered = jax.jit(make_prefill_step(cfg)).lower(params, tok)
    elif kind == "decode":
        cache = jax.eval_shape(lambda: JM.init_cache(cfg, B, S))
        one = (jax.ShapeDtypeStruct((B, 1, cfg.d_model), jnp.bfloat16)
               if cfg.embedding_stub else jax.ShapeDtypeStruct((B,), jnp.int32))
        lowered = jax.jit(make_serve_step(cfg)).lower(
            params, cache, one, jax.ShapeDtypeStruct((), jnp.int32))
    else:
        opt = jax.eval_shape(adamw_init, params)
        batch = {"inputs": tok, "labels": jax.ShapeDtypeStruct((B, S),
                                                               jnp.int32)}
        lowered = jax.jit(make_train_step(
            cfg, microbatches=MICROBATCHES)).lower(params, opt, batch)
    text = lowered.compile().as_text()
    out = []
    for conv in (H._conv_flops, _true_conv_flops, lambda ins, comp: 0.0):
        monkeypatch.setattr(H, "_conv_flops", conv)
        H._LOCAL_SMALL_CACHE.clear()
        out.append(H.analyze_hlo(text).flops)
    return tuple(out)


def torch_flops(arch: str, kind: str) -> tuple:
    """CostMode's FLOPs over the port's same step on the meta device: (all,
    the convolutions')."""
    import torch

    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.launch.hlo_analysis import CostMode
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.steps import (make_prefill_step, make_serve_step,
                                         make_train_step)

    cfg = reduced_config(get_config(arch))
    B, S = SHAPES[kind]
    model = M.LM(cfg, device="meta")

    def tokens(shape):
        if cfg.embedding_stub:
            return torch.empty(shape + (cfg.d_model,), dtype=torch.bfloat16,
                               device="meta")
        return torch.empty(shape, dtype=torch.int32, device="meta")

    with CostMode() as cm:
        if kind == "prefill":
            make_prefill_step(cfg, use_kernel=False)(model, tokens((B, S)))
        elif kind == "decode":
            cache = M.init_cache(cfg, B, S, device="meta")
            make_serve_step(cfg)(model, cache, tokens((B, 1) if
                                 cfg.embedding_stub else (B,)), S - 1)
        else:
            batch = {"inputs": tokens((B, S)),
                     "labels": torch.empty((B, S), dtype=torch.int32,
                                           device="meta")}
            make_train_step(cfg, microbatches=MICROBATCHES)(
                model, adamw_init(model), batch)
    hc = cm.cost()
    return hc.flops, sum(v for k, v in hc.flops_by_op.items()
                         if k.startswith("convolution"))


# ROADMAP C15: the SSM archs' train steps, (dot FLOPs, convolution FLOPs)
# that repro's optimized HLO runs beyond the port's eager program
C15_GAPS = {"mamba2-130m": (655360.0, 208435200.0),
            "zamba2-1.2b": (2293760.0, 729523200.0)}


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_flops_match_jax_at_one_device(arch, kind, monkeypatch):
    """The port's count equals repro's less its conv overcount (C14);
    for the SSM archs' train step, less C15's gaps too, which are pinned:
    XLA runs the depthwise conv's weight gradient as a dense C x C
    convolution (mamba2-130m: ``f32[160,160,1,4]``, 52,428,800 FLOPs where
    the gradient needs 327,680, four times a step) and its input gradient
    over the padded length (131 of 128 positions), and the reference's
    three-operand einsums (the chunk states, the off-diagonal output)
    differentiate into dots where the port's pairwise split multiplies
    elementwise."""
    counted, true, no_conv = jax_flops(arch, kind, monkeypatch)
    got, got_conv = torch_flops(arch, kind)
    dots, conv = no_conv, true - no_conv
    if kind == "train" and arch in C15_GAPS:
        dots, conv = (a - b for a, b in zip((dots, conv), C15_GAPS[arch]))
    assert (got - got_conv, got_conv) == (dots, conv), (
        f"{arch} {kind}: port {got:.6e} (convs {got_conv:.6e}), repro "
        f"{counted:.6e}, less its conv overcount {true:.6e} (convs "
        f"{true - no_conv:.6e})")


def test_c14_conv_overcount(monkeypatch):
    """ROADMAP C14: ``repro``'s counter charges zamba2-1.2b's depthwise
    conv, laid out ``f32[2,1,256,160]``, 160 times (5.3320e8 against the
    true 3.2480e8 for the reduced prefill).  mamba2-130m's train step is
    laid out ``bf01`` (dim 1 the features), so the counter is right there
    and its gap to the port is C15's, not C14's; an arch with no conv has
    no C14 gap."""
    got = {}
    for arch, kind in (("zamba2-1.2b", "prefill"), ("mamba2-130m", "train"),
                       ("qwen3-14b", "prefill")):
        with monkeypatch.context() as m:
            got[arch] = jax_flops(arch, kind, m)[:2]
    assert got["zamba2-1.2b"] == (533200896.0, 324796416.0), got
    assert got["mamba2-130m"] == (513177600.0, 513177600.0), got
    counted, true = got["qwen3-14b"]
    assert counted == true, got


# ---------------------------------------------------------------------------
# sharded numerics on 8 gloo ranks
# ---------------------------------------------------------------------------
class HeldRoutes:
    """Patches ``models.moe.route`` while in use: the first forward records
    each call's routing; after ``replay()`` the next takes the recorded
    experts, positions and capacity call by call, with gates from its own
    router product.  A near-tie in the router can otherwise send a token
    to another expert where the sharded attention before it rounds
    otherwise (ROADMAP C9), and later positions see that token through
    attention."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.real = moe, moe.route
        self.recorded, self.next = [], None

    def route(self, p, x, cfg):
        import torch

        if self.next is None:
            r = self.real(p, x, cfg)
            self.recorded.append(r)
            return r
        r = self.recorded[self.next]
        self.next += 1
        logits = x.reshape(-1, cfg.d_model).float() @ p.router
        gates = torch.softmax(logits.gather(1, r.topi), dim=-1)
        return self.moe.Routing(r.topi, gates, r.pos, r.keep, r.C)

    def replay(self) -> None:
        self.next = 0

    def __enter__(self):
        self.moe.route = self.route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.real


def rank_main(rank: int, world: int, d: str) -> None:
    """One rank: every reduced arch's forward with DTensor parameters on
    the (2, 4) mesh against the unsharded forward; rank 0 writes the
    largest difference of each arch's logits to ``sharded.json``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.launch.mesh import (init_process_group, make_debug_mesh,
                                         shard_ctx)
    from repro_torch.launch.sharding import placements, tree_shardings
    from repro_torch.models import model as M

    torch.set_num_threads(1)
    init_process_group(rank, world, device="cpu",
                       init_method=f"file://{os.path.join(d, 'rdv')}")
    try:
        mesh = make_debug_mesh(device="cpu")
        ctx = shard_ctx(mesh)
        out = {}
        for arch in ARCH_IDS:
            cfg = reduced_config(get_config(arch))
            model = M.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
            rng = np.random.default_rng(1)
            if cfg.embedding_stub:
                x = torch.from_numpy(rng.normal(size=(4, 32, cfg.d_model))
                                     .astype(np.float32)).to(torch.bfloat16)
            else:
                x = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32))
                                     .astype(np.int32))
            held = HeldRoutes()
            with torch.inference_mode(), held:
                plain = M.forward(model, x, use_kernel=False).float()
                named = dict(model.named_parameters())
                shardings = tree_shardings(M.named_param_axes(cfg), named,
                                           mesh)
                for name, p in named.items():
                    owner, _, leaf = name.rpartition(".")
                    module = model.get_submodule(owner) if owner else model
                    setattr(module, leaf, torch.nn.Parameter(distribute_tensor(
                        p.detach(), mesh, placements(shardings[name].spec,
                                                     mesh), src_data_rank=None)))
                dx = distribute_tensor(x, mesh, placements(
                    (ctx.dp_spec,), mesh), src_data_rank=None)
                held.replay()
                with ctx.replicating():
                    got = M.forward(model, dx, use_kernel=False, ctx=ctx)
                got = got.full_tensor().float()
            out[arch] = {"max_abs": float((got - plain).abs().max()),
                         "max_plain": float(plain.abs().max()),
                         "rel_l2": float((got - plain).norm() / plain.norm()),
                         "outside": int((~torch.isclose(got, plain,
                                                        **SHARDED_TOL)).sum()),
                         "within": bool(torch.allclose(got, plain,
                                                       **SHARDED_TOL)),
                         "shape": list(got.shape)}
        if rank == 0:
            with open(os.path.join(d, "sharded.json"), "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _run_ranks(d: str, world: int) -> None:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(d, f"rank_{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(world), d],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO))
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        with open(os.path.join(d, f"rank_{bad[0]}.log")) as f:
            pytest.fail(f"rank {bad[0]} of {world} exited "
                        f"{procs[bad[0]].returncode}:\n{f.read()[-4000:]}")


def test_sharded_forward_matches_unsharded(tmp_path):
    d = str(tmp_path)
    _run_ranks(d, 8)
    with open(os.path.join(d, "sharded.json")) as f:
        got = json.load(f)
    assert sorted(got) == sorted(ARCH_IDS)
    bad = {a: r for a, r in got.items() if not r["within"]}
    assert not bad, bad


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])


# ---------------------------------------------------------------------------
# olmoe-1b-7b's layer-0 drop share at full width
# ---------------------------------------------------------------------------
DROP_TOKENS = 4096
# a router near-tie: the k-th and (k+1)-th logits closer than this (the
# logits' mean magnitude is 0.72 and their median gap there 0.047)
ROUTER_TIE = 1e-2


def test_olmoe_layer0_drops_match_jax():
    """Full-width layer-0 weights (embedding, attention, norms, router)
    drawn by the JAX package's initializers and carried into the port; one
    sequence of 4,096 random tokens through the embedding and layer 0's
    attention to the router, in both packages op by op.  The router is
    skewed (loads of 8 to 2,000 slots over the 64 experts) and drops about
    a quarter of the slots past the capacity of 640, in both packages.
    Given JAX's router input the port's per-expert loads and dropped slots
    are equal; from its own attention, whose bfloat16 roundings differ,
    only tokens whose k-th and (k+1)-th router logits tie within
    ROUTER_TIE pick another expert set (observed 45 of 4,096, gaps up to
    3.4e-3), and the dropped slots differ by no more than the slots those
    tokens hold (observed 8,049 against 8,051 of 32,768)."""
    import dataclasses
    from types import SimpleNamespace

    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs.base import get_config as jx_get_config
    from repro.models import layers as JL
    from repro_torch.configs.base import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    from repro_torch.models.convert import to_tensor

    jcfg = dataclasses.replace(jx_get_config("olmoe-1b-7b"), num_layers=1)
    cfg = dataclasses.replace(get_config("olmoe-1b-7b"), num_layers=1)
    m = cfg.moe
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    jw = {"embed": JL.trunc_normal(keys[0], (cfg.vocab_size, cfg.d_model),
                                   1.0),
          "attn": JL.init_attention(keys[1], jcfg),
          "router": JL.trunc_normal(keys[2], (cfg.d_model, m.num_experts),
                                    1.0, jnp.float32),
          "ln1": jnp.ones((cfg.d_model,), jnp.float32),
          "ln2": jnp.ones((cfg.d_model,), jnp.float32)}
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, DROP_TOKENS)).astype(np.int32)

    h = jnp.take(jw["embed"], jnp.asarray(tokens), axis=0).astype(jnp.bfloat16)
    h = h + JL.attention(jw["attn"], JL.rms_norm(h, jw["ln1"]), jcfg,
                         JL.NOSHARD)
    jx = JL.rms_norm(h, jw["ln2"])
    logits = np.asarray(jx.reshape(DROP_TOKENS, -1).astype(jnp.float32)
                        @ jw["router"])
    topi = np.asarray(jax.lax.top_k(logits, m.top_k)[1])
    C = moe.capacity(DROP_TOKENS, m.top_k, m.num_experts, m.capacity_factor)
    flat = topi.reshape(-1)
    # each slot's place among its expert's earlier slots, token-major
    order = np.argsort(flat, kind="stable")
    starts = np.searchsorted(flat[order], np.arange(m.num_experts))
    pos = np.empty_like(flat)
    pos[order] = np.arange(flat.size) - starts[flat[order]]
    exp_loads = np.bincount(flat, minlength=m.num_experts)
    exp_drops = np.bincount(flat[pos >= C], minlength=m.num_experts)

    w = {k: to_tensor(np.asarray(v)) for k, v in jw.items() if k != "attn"}
    router = SimpleNamespace(router=w["router"])
    attn = L.Attention(cfg, device="cpu")
    with torch.no_grad():
        for name, p in attn.named_parameters():
            p.copy_(to_tensor(np.asarray(jw["attn"][name])))
    with torch.inference_mode():
        th = torch.nn.functional.embedding(torch.from_numpy(tokens),
                                           w["embed"]).to(torch.bfloat16)
        th = th + L.attention(attn, L.rms_norm(th, w["ln1"]), cfg)
        given = moe.route(router, to_tensor(np.asarray(jx)), cfg)
        own = moe.route(router, L.rms_norm(th, w["ln2"]), cfg)

    def loads_drops(r):
        f = r.topi.reshape(-1).numpy()
        return (np.bincount(f, minlength=m.num_experts),
                np.bincount(f[~r.keep.reshape(-1).numpy()],
                            minlength=m.num_experts))

    assert given.C == own.C == C == 640
    assert 0.2 < exp_drops.sum() / flat.size < 0.3, exp_drops.sum()
    got_loads, got_drops = loads_drops(given)
    assert np.array_equal(got_loads, exp_loads), (got_loads, exp_loads)
    assert np.array_equal(got_drops, exp_drops), (got_drops, exp_drops)

    own_loads, own_drops = loads_drops(own)
    moved = np.nonzero((np.sort(topi, 1)
                        != np.sort(own.topi.numpy(), 1)).any(1))[0]
    top = -np.sort(-logits, 1)
    gaps = (top[:, m.top_k - 1] - top[:, m.top_k])[moved]
    print(f"olmoe layer 0, {DROP_TOKENS} tokens: dropped slots repro "
          f"{exp_drops.sum()}, port {own_drops.sum()} of {flat.size}; "
          f"{len(moved)} tokens with another expert set, largest gap "
          f"{gaps.max() if len(moved) else 0:.3e}")
    assert (gaps < ROUTER_TIE).all(), gaps
    assert abs(int(own_drops.sum()) - int(exp_drops.sum())) <= \
        m.top_k * len(moved)
