"""The port's distributed layer against the JAX package's, on the CPU.

The JAX side runs in a subprocess with 8 forced host devices (mesh (4, 2)
``("data", "model")`` for the relational operators, (8,) ``("pod",)`` for
the compressed psum, (4,) and (8,) ``("data",)`` for checkpoints), as
``tests/test_distributed.py`` runs it.  The port's side runs as 4 or 8
processes, one a rank, on gloo process groups with the same mesh shapes;
they meet through a ``file://`` store in the test's temporary directory.
Both read the same numpy inputs (seed 0) and write their outputs to
``.npz`` files, which the tests compare shard by shard.

This file is also the processes' program:
``python tests/test_torch_distributed.py jax <dir>`` and
``python tests/test_torch_distributed.py <save4|ranks8|four> <rank>
<world> <dir> [cpu|cuda]``.  With four cards, the 4-rank operators also
run over NCCL, held to the same operators on 4 gloo ranks
(``test_four_cards_match_four_cpu_ranks``; it skips otherwise).

Tolerances: counts, join outputs, overflow and the compressed psum are
held exactly (bit for bit); group sums too, because both packages add each
shard's rows in row order and the four shards' partials in shard order
(float32), and they come out bit-equal; the plain psum adds in gloo's
order, not XLA's, so it is held to float32's bound for a sum of 8 terms:
|diff| <= 8 eps sum |x_i|, element by element.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240  # each group of processes; a hung rendezvous fails the test
N_DATA, N_MODEL = 4, 2
GROUPS = {"basic": ("codes", 64), "c11": ("codes_neg", 64),
          "c11_padded": ("codes_neg", 62), "c11_edges": ("codes_edges", 64)}
JOINS = {"basic": ("lk", "rk", 4096), "dup": ("lk", "rk_dup", 4096),
         "pad": ("lk_pad", "rk_pad", 4096), "c12": ("lk_c12", "rk_c12", 4096),
         "overflow": ("lk", "rk_dup", 64)}
BROADCASTS = ("basic", "dup", "pad", "c12")


def make_inputs(path: str) -> None:
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 64, 4096).astype(np.int32)
    vals = rng.uniform(0, 1, 4096).astype(np.float32)
    codes_neg = codes.copy()
    codes_neg[::17] = -1          # C11: -1 lands in slot g_pad - 1
    codes_edges = codes.copy()    # wrap from the end, drop out of range
    codes_edges[3::50] = -64
    codes_edges[5::50] = 64
    codes_edges[7::50] = -65
    codes_edges[9::50] = -1
    lk = rng.integers(0, 100, 1024).astype(np.int32)
    lv = rng.uniform(0, 1, 1024).astype(np.float32)
    rk = rng.permutation(200)[:128].astype(np.int32)
    rv = rng.uniform(0, 1, 128).astype(np.float32)
    rk_dup = rng.integers(0, 60, 128).astype(np.int32)
    lk_pad = lk.copy()
    lk_pad[::7] = -1
    rk_pad = rk_dup.copy()
    rk_pad[::5] = -1
    # C12: on every shard a padding row, then a real row bound for bucket
    # 0 (key = 0 mod 4) that takes position 0 there; its key is on the
    # right, so the join shows whether it survived
    per = 1024 // N_DATA
    lk_c12 = lk_pad.copy()
    rk_c12 = rk_pad.copy()
    for s in range(N_DATA):
        lk_c12[s * per] = -1
        lk_c12[s * per + 1] = 4 * (s + 1)
        rk_c12[s * (128 // N_DATA)] = 4 * (s + 1)
    x = rng.normal(size=(8, 4096)).astype(np.float32)
    y = rng.normal(size=(8, 3000)).astype(np.float32) * \
        rng.uniform(0.01, 100, size=(8, 1)).astype(np.float32)
    np.savez(path, codes=codes, vals=vals, codes_neg=codes_neg,
             codes_edges=codes_edges, lk=lk, lv=lv, rk=rk, rv=rv,
             rk_dup=rk_dup, lk_pad=lk_pad, rk_pad=rk_pad, lk_c12=lk_c12,
             rk_c12=rk_c12, x=x, y=y)


# ---------------------------------------------------------------------------
# the JAX package's side (a subprocess with 8 host devices)
# ---------------------------------------------------------------------------
def jax_main(d: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.distributed.checkpoint import CheckpointManager
    from repro.distributed.compression import psum_with_optional_compression
    from repro.distributed.relational import (make_broadcast_join,
                                              make_distributed_group_sum,
                                              make_shuffle_join)

    inp = dict(np.load(os.path.join(d, "inputs.npz")))
    out = {}
    mesh = jax.make_mesh((N_DATA, N_MODEL), ("data", "model"))
    for name, (codes, g) in GROUPS.items():
        s, c = make_distributed_group_sum(mesh, g)(
            jnp.asarray(inp[codes]), jnp.asarray(inp["vals"]))
        out[f"group/{name}/sums"], out[f"group/{name}/counts"] = (
            np.asarray(s), np.asarray(c))
    for name, (lk, rk, cap) in JOINS.items():
        res = make_shuffle_join(mesh, cap)(
            *(jnp.asarray(inp[k]) for k in (lk, "lv", rk, "rv")))
        for k, a in zip(("keys", "lv", "rv", "overflow"), res):
            out[f"join/{name}/{k}"] = np.asarray(a)
    for name in BROADCASTS:
        lk, rk, _ = JOINS[name]
        res = make_broadcast_join(mesh)(
            *(jnp.asarray(inp[k]) for k in (lk, "lv", rk, "rv")))
        for k, a in zip(("keys", "lv", "rv"), res):
            out[f"broadcast/{name}/{k}"] = np.asarray(a)

    pod = jax.make_mesh((8,), ("pod",))
    tree = {"g": jnp.asarray(inp["x"]), "h": {"b": jnp.asarray(inp["y"])}}
    for compress in (True, False):
        f = jax.jit(shard_map(
            lambda t, c=compress: psum_with_optional_compression(t, "pod", c),
            mesh=pod, in_specs=P("pod"), out_specs=P("pod")))
        res = f(tree)
        tag = "compressed" if compress else "plain"
        out[f"psum/{tag}/g"] = np.asarray(res["g"])
        out[f"psum/{tag}/h/b"] = np.asarray(res["h"]["b"])

    pod4 = jax.sharding.Mesh(np.array(jax.devices()[:N_DATA]), ("pod",))
    tree4 = {"g": tree["g"][:N_DATA], "h": {"b": tree["h"]["b"][:N_DATA]}}
    for compress in (True, False):
        f = jax.jit(shard_map(
            lambda t, c=compress: psum_with_optional_compression(t, "pod", c),
            mesh=pod4, in_specs=P("pod"), out_specs=P("pod")))
        res = f(tree4)
        tag = "compressed" if compress else "plain"
        out[f"psum4/{tag}/g"] = np.asarray(res["g"])
        out[f"psum4/{tag}/h/b"] = np.asarray(res["h"]["b"])

    # checkpoints: write one from 4 devices; restore the port's onto 8
    mesh4 = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("data",))
    mesh8 = jax.sharding.Mesh(np.array(jax.devices()), ("data",))
    w = jnp.arange(64, dtype=jnp.float32).reshape(8, 8)
    sh4 = {"w": NamedSharding(mesh4, P("data", None))}
    CheckpointManager(os.path.join(d, "ckpt_jax")).save(
        5, {"w": jax.device_put(w, sh4["w"])}, shardings=sh4)
    sh8 = {"w": NamedSharding(mesh8, P("data", None))}
    restored, step = CheckpointManager(os.path.join(d, "ckpt_port")).restore(
        {"w": w}, shardings=sh8)
    assert restored["w"].sharding == sh8["w"]
    out["ckpt/port_into_jax/step"] = np.asarray(step)
    out["ckpt/port_into_jax/w"] = np.asarray(restored["w"])
    out["ckpt/port_into_jax/shards"] = np.stack(
        [np.asarray(s.data) for s in sorted(
            restored["w"].addressable_shards, key=lambda s: s.device.id)])
    np.savez(os.path.join(d, "jax.npz"), **out)


# ---------------------------------------------------------------------------
# the port's side (one process a rank, gloo)
# ---------------------------------------------------------------------------
CKPT_W = np.arange(64, dtype=np.float32).reshape(8, 8)


def save4(rank: int, d: str, mesh_fn) -> dict:
    """4 ranks: save w with ("data", None), as a job on 4 chips does."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.launch.sharding import NamedSharding, placements

    mesh = mesh_fn((4,), ("data",))
    sh = NamedSharding(mesh, ("data", None))
    w = distribute_tensor(torch.from_numpy(CKPT_W), mesh,
                          placements(sh.spec, mesh))
    CheckpointManager(os.path.join(d, "ckpt_port")).save(
        5, {"w": w}, shardings={"w": sh})
    return {"local": w.to_local().numpy()}


def operators(rank: int, d: str, mesh, pod, device: str) -> dict:
    """The relational operators on ``mesh``'s "data" shards and the psum
    over ``pod``, on this rank's part of the inputs, on ``device``."""
    import torch

    from repro_torch.distributed.compression import \
        psum_with_optional_compression
    from repro_torch.distributed.relational import (make_broadcast_join,
                                                    make_distributed_group_sum,
                                                    make_shuffle_join)

    inp = {k: torch.from_numpy(v) for k, v in
           np.load(os.path.join(d, "inputs.npz")).items()}
    out = {}
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()[names.index("data")]

    def shard(key):
        t = inp[key]
        n = t.shape[0] // N_DATA
        return t[coord * n:(coord + 1) * n].to(device)

    for name, (codes, g) in GROUPS.items():
        res = make_distributed_group_sum(mesh, g)(shard(codes), shard("vals"))
        for k, a in zip(("sums", "counts"), res):
            out[f"group/{name}/{k}"] = a.cpu().numpy()
    for name, (lk, rk, cap) in JOINS.items():
        res = make_shuffle_join(mesh, cap)(
            *(shard(k) for k in (lk, "lv", rk, "rv")))
        for k, a in zip(("keys", "lv", "rv", "overflow"), res):
            out[f"join/{name}/{k}"] = a.cpu().numpy()
    for name in BROADCASTS:
        lk, rk, _ = JOINS[name]
        res = make_broadcast_join(mesh)(
            *(shard(k) for k in (lk, "lv", rk, "rv")))
        for k, a in zip(("keys", "lv", "rv"), res):
            out[f"broadcast/{name}/{k}"] = a.cpu().numpy()

    r = pod.get_coordinate()[0]
    tree = {"g": inp["x"][r:r + 1].to(device),
            "h": {"b": inp["y"][r:r + 1].to(device)}}
    for compress in (True, False):
        res = psum_with_optional_compression(tree, pod.get_group("pod"),
                                             compress)
        tag = "compressed" if compress else "plain"
        out[f"psum/{tag}/g"] = res["g"].cpu().numpy()
        out[f"psum/{tag}/h/b"] = res["h"]["b"].cpu().numpy()
    return out


def ranks8(rank: int, d: str, mesh_fn) -> dict:
    """8 ranks: the relational operators on (4, 2), the psum on (8,), and
    both packages' checkpoints restored onto (8,)."""
    import torch
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.launch.sharding import NamedSharding

    out = operators(rank, d, mesh_fn((N_DATA, N_MODEL), ("data", "model")),
                    mesh_fn((8,), ("pod",)), "cpu")
    mesh8 = mesh_fn((8,), ("data",))
    sh8 = {"w": NamedSharding(mesh8, ("data", None))}
    for src in ("port", "jax"):
        restored, step = CheckpointManager(
            os.path.join(d, f"ckpt_{src}")).restore(
                {"w": torch.zeros(8, 8)}, shardings=sh8)
        w = restored["w"]
        assert isinstance(w, DTensor) and w.placements == (Shard(0),), w
        out[f"ckpt/{src}/step"] = np.asarray(step)
        out[f"ckpt/{src}/local"] = w.to_local().numpy()
        out[f"ckpt/{src}/full"] = w.full_tensor().numpy()
    return out


def four(rank: int, d: str, mesh_fn, device: str) -> dict:
    """4 ranks, one a card over NCCL or one a process over gloo: the
    operators on ("data",) and ("pod",) meshes of 4."""
    return operators(rank, d, mesh_fn((N_DATA,), ("data",)),
                     mesh_fn((N_DATA,), ("pod",)), device)


def rank_main(role: str, rank: int, world: int, d: str,
              device: str = "cpu") -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group, make_mesh

    torch.set_num_threads(1)
    tag = f"{role}_{device}"
    init_process_group(rank, world, device=device,
                       init_method=f"file://{os.path.join(d, 'rdv_' + tag)}")
    try:
        def mesh_fn(shape, axes):
            return make_mesh(shape, axes, device)

        if role == "four":
            out = four(rank, d, mesh_fn, device)
        else:
            out = {"save4": save4, "ranks8": ranks8}[role](rank, d, mesh_fn)
        np.savez(os.path.join(d, f"{tag}_{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# fixtures: the three jobs, once for the file
# ---------------------------------------------------------------------------
def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["OMP_NUM_THREADS"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _run(argvs, d: str, tag: str) -> None:
    """Start one process per argv, wait for all within TIMEOUT_S; fail
    with their error output if one fails or the time runs out."""
    procs, logs = [], []
    for i, argv in enumerate(argvs):
        log = open(os.path.join(d, f"{tag}_{i}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *argv],
            stdout=log, stderr=subprocess.STDOUT, env=_env(), cwd=REPO))
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
    bad = [i for i, p in enumerate(procs) if p.returncode != 0]
    if bad:
        with open(os.path.join(d, f"{tag}_{bad[0]}.log")) as f:
            pytest.fail(f"{tag} process {bad[0]} of {len(procs)} exited "
                        f"{procs[bad[0]].returncode}:\n{f.read()[-4000:]}")


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dist"))
    make_inputs(os.path.join(d, "inputs.npz"))
    _run([["save4", str(r), "4", d] for r in range(4)], d, "save4")
    _run([["jax", d]], d, "jax")
    _run([["ranks8", str(r), "8", d] for r in range(8)], d, "ranks8")
    _run([["four", str(r), "4", d, "cpu"] for r in range(4)], d, "four")
    return {"dir": d,
            "inputs": dict(np.load(os.path.join(d, "inputs.npz"))),
            "jax": dict(np.load(os.path.join(d, "jax.npz"))),
            "save4": _outputs(d, "save4_cpu", 4),
            "ranks8": _outputs(d, "ranks8_cpu", 8),
            "four": _outputs(d, "four_cpu", 4)}


def _outputs(d: str, tag: str, world: int) -> list:
    return [dict(np.load(os.path.join(d, f"{tag}_{r}.npz")))
            for r in range(world)]


def _bits_equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(GROUPS))
def test_group_sum_matches_jax(jobs, name):
    """Counts exact and sums bit for bit, on every rank (the output is
    replicated); c11*: a -1 code adds its value (not its count) to slot
    g_pad - 1, a real group at 64 groups on 4 shards and padding at 62;
    codes in [-g_pad, 0) wrap and the rest outside [0, g_pad) drop."""
    exp_s = jobs["jax"][f"group/{name}/sums"]
    exp_c = jobs["jax"][f"group/{name}/counts"]
    for r, got in enumerate(jobs["ranks8"]):
        assert _bits_equal(got[f"group/{name}/counts"], exp_c), (name, r)
        assert _bits_equal(got[f"group/{name}/sums"], exp_s), (name, r)
    if name == "c11":
        codes, vals = (jobs["inputs"][k] for k in ("codes_neg", "vals"))
        plain = np.zeros(64)
        np.add.at(plain, codes[codes >= 0], vals[codes >= 0])
        assert exp_s[63] - plain[63] == pytest.approx(
            vals[codes == -1].sum(), rel=1e-4)
        assert exp_c.sum() == (codes >= 0).sum()


@pytest.mark.parametrize("name", list(JOINS))
def test_shuffle_join_matches_jax(jobs, name):
    """Each shard's keys, left and right values and the total overflow
    equal the JAX package's exactly; ranks that differ only in "model"
    return the same shard."""
    for k in ("keys", "lv", "rv"):
        exp = np.split(jobs["jax"][f"join/{name}/{k}"], N_DATA)
        for r, got in enumerate(jobs["ranks8"]):
            assert _bits_equal(got[f"join/{name}/{k}"],
                               exp[r // N_MODEL]), (name, k, r)
    ovf = jobs["jax"][f"join/{name}/overflow"]
    for got in jobs["ranks8"]:
        assert _bits_equal(got[f"join/{name}/overflow"], ovf)
    lk, rk, cap = JOINS[name]
    inp = jobs["inputs"]
    matches = sum(int((inp[rk] == k).sum()) for k in inp[lk] if k >= 0)
    kept = int((jobs["jax"][f"join/{name}/keys"] >= 0).sum())
    assert kept + int(ovf) == matches, (kept, int(ovf), matches)
    assert (int(ovf) > 0) == (name == "overflow")
    if name == "c12":  # every shard's bucket-0, position-0 row matched
        for s in range(N_DATA):
            assert 4 * (s + 1) in set(jobs["jax"]["join/c12/keys"].tolist())


@pytest.mark.parametrize("name", BROADCASTS)
def test_broadcast_join_matches_jax(jobs, name):
    for k in ("keys", "lv", "rv"):
        exp = np.split(jobs["jax"][f"broadcast/{name}/{k}"], N_DATA)
        for r, got in enumerate(jobs["ranks8"]):
            assert _bits_equal(got[f"broadcast/{name}/{k}"],
                               exp[r // N_MODEL]), (name, k, r)


@pytest.mark.parametrize("leaf", ["g", "h/b"])
def test_compressed_psum_matches_jax(jobs, leaf):
    """The compressed psum equals the JAX package's bit for bit on every
    rank (a (1, 4096) leaf and a (1, 3000) one, whose last block is
    padded); the plain psum within float32's bound for its 8 terms (gloo
    adds in another order); the compressed one within 2% of the plain
    (tests/test_distributed.py's bound)."""
    exp_c = jobs["jax"][f"psum/compressed/{leaf}"]
    exp_p = jobs["jax"][f"psum/plain/{leaf}"]
    bound = _psum_bound(jobs["inputs"]["x" if leaf == "g" else "y"], 8)
    for r, got in enumerate(jobs["ranks8"]):
        assert _bits_equal(got[f"psum/compressed/{leaf}"], exp_c[r:r + 1]), r
        diff = np.abs(got[f"psum/plain/{leaf}"] - exp_p[r:r + 1])
        assert (diff <= bound).all(), (r, float((diff / bound).max()))
        got_c, got_p = (got[f"psum/{t}/{leaf}"] for t in
                        ("compressed", "plain"))
        rel = np.abs(got_c - got_p).max() / (np.abs(got_p).max() + 1e-9)
        assert rel < 0.02, (r, rel)


@pytest.mark.parametrize("src", ["port", "jax"])
def test_checkpoint_saved_on_4_restores_on_8(jobs, src):
    """A checkpoint of w (8 x 8) saved from 4 ranks with ("data", None),
    by the port or by the JAX package, restores on 8 ranks: step 5, rank r
    holds row r, and the rows reassemble w."""
    for r, got in enumerate(jobs["ranks8"]):
        assert int(got[f"ckpt/{src}/step"]) == 5
        assert np.array_equal(got[f"ckpt/{src}/local"], CKPT_W[r:r + 1]), r
        assert np.array_equal(got[f"ckpt/{src}/full"], CKPT_W)
    for r, got in enumerate(jobs["save4"]):
        assert np.array_equal(got["local"], CKPT_W[2 * r:2 * r + 2])


def test_port_checkpoint_restores_into_jax_on_8(jobs):
    jx = jobs["jax"]
    assert int(jx["ckpt/port_into_jax/step"]) == 5
    assert np.array_equal(jx["ckpt/port_into_jax/w"], CKPT_W)
    assert np.array_equal(jx["ckpt/port_into_jax/shards"],
                          CKPT_W.reshape(8, 1, 8))


def test_sharded_manifest_equals_jax(jobs):
    """Both packages write the same manifest for the same sharded save
    (mesh_shape {"data": 4}, spec ["data", null]), and one npz."""
    def manifest(name):
        path = os.path.join(jobs["dir"], name, "step_0000000005")
        assert sorted(os.listdir(path)) == ["manifest.json",
                                            "shard_0_of_1.npz"]
        with open(os.path.join(path, "manifest.json")) as f:
            m = json.load(f)
        m.pop("written_at")
        return m

    assert manifest("ckpt_port") == manifest("ckpt_jax")
    assert manifest("ckpt_port")["mesh_shape"] == {"data": 4}
    assert manifest("ckpt_port")["leaves"][0]["spec"] == ["data", None]


def _psum_bound(x: np.ndarray, n: int) -> np.ndarray:
    """float32's bound on a sum of the first n rows of x, column by
    column, in any order: n eps sum |x_i|."""
    return n * np.finfo(np.float32).eps * np.abs(x[:n]).sum(0, keepdims=True)


def test_four_ranks_match_jax(jobs):
    """The operators on 4 gloo ranks, meshes ("data",) and ("pod",) of 4:
    the relational outputs equal the JAX package's on (4, 2) bit for bit
    (they depend on the "data" axis alone), the compressed psum its psum
    over 4 devices bit for bit, the plain psum within float32's bound."""
    jx, inp = jobs["jax"], jobs["inputs"]
    for r, got in enumerate(jobs["four"]):
        for key, a in got.items():
            if key.startswith("psum/"):
                exp = jx["psum4/" + key[5:]][r:r + 1]
                if key.startswith("psum/plain/"):
                    x = inp["x" if key.endswith("/g") else "y"]
                    assert (np.abs(a - exp) <= _psum_bound(x, N_DATA)).all()
                    continue
            elif key.startswith("group/") or key.endswith("/overflow"):
                exp = jx[key]
            else:
                exp = np.split(jx[key], N_DATA)[r]
            assert _bits_equal(a, exp), (r, key)


def test_four_cards_match_four_cpu_ranks(tmp_path):
    """The same operators on four cards over NCCL and on four gloo ranks
    (which test_four_ranks_match_jax holds to the JAX package): equal bit
    for bit, but the group sums (atomic adds on the card, in no fixed
    order: within 4,096 x 2^-23 of the CPU's, relative) and the plain psum
    (within float32's bound for 4 terms)."""
    import torch

    if torch.cuda.device_count() < N_DATA:
        pytest.skip(f"needs {N_DATA} NVIDIA GPUs")
    d = str(tmp_path)
    make_inputs(os.path.join(d, "inputs.npz"))
    for device in ("cuda", "cpu"):
        _run([["four", str(r), str(N_DATA), d, device]
              for r in range(N_DATA)], d, f"four_{device}")
    inp = dict(np.load(os.path.join(d, "inputs.npz")))
    cards, cpus = (_outputs(d, f"four_{dev}", N_DATA)
                   for dev in ("cuda", "cpu"))
    for r, (card, cpu) in enumerate(zip(cards, cpus)):
        assert card.keys() == cpu.keys()
        for key, exp in cpu.items():
            got = card[key]
            if key.startswith("group/") and key.endswith("/sums"):
                assert (np.abs(got - exp) <= 4096 * 2.0 ** -23 * np.abs(exp)
                        ).all(), (r, key)
            elif key.startswith("psum/plain/"):
                x = inp["x" if key.endswith("/g") else "y"]
                assert (np.abs(got - exp) <= _psum_bound(x, N_DATA)).all()
            else:
                assert _bits_equal(got, exp), (r, key)


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        jax_main(sys.argv[2])
    else:
        rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                  *sys.argv[4:])
