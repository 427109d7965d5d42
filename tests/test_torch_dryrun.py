"""The port's dry run (``repro_torch.launch.dryrun``, ``.hlo_analysis``)
held to ``tests/test_dryrun.py``'s contract, re-rooted, and its parameter
bytes held to the JAX package's.

``CostMode`` counts a loop of five 8 x 8 float32 products and all-reduces
exactly as ``analyze_hlo`` counts the reference's five-trip while loop;
the debug-mesh CLI traces mamba2-130m x train_4k and qwen3-14b x
decode_32k (``--device cpu``, 8 ranks of the fake process group) and
writes artifacts; the full production matrix, when it has been run, left
33 single-pod and 33 multi-pod artifacts.  Parameter bytes a device holds
are the sum of the DTensor local shards the dry run builds, the port's
``sharded_bytes_per_device``, and the JAX package's, on the debug and
production meshes.  The FLOP parity with the JAX package and the sharded
numerics are in ``test_torch_dryrun_parity.py``.
"""
import json
import os
import subprocess
import sys

import jax
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs.base import get_config as jx_get_config
from repro.launch.sharding import \
    sharded_bytes_per_device as jx_sharded_bytes
from repro.launch.sharding import tree_shardings as jx_tree_shardings
from repro.models import model as JM
from repro_torch.configs.base import ARCH_IDS, get_config, supported_shapes
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_analysis import (HBM_BW, IB_BW, NVLINK_BW,
                                             PEAK_FLOPS, CostMode,
                                             group_link, roofline_terms)
from repro_torch.launch.mesh import make_debug_mesh, make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def fake_world():
    """Start the fake process group of a given world size; destroyed after
    the test."""
    def start(world_size):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world_size)

    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


def test_cost_mode_counts_loops(fake_world):
    """test_dryrun.py's loop case: five trips of an 8 x 8 float32 product
    and an all-reduce give 2*8*8*8*5 FLOPs and 8*8*4*5 all-reduce bytes."""
    import torch.distributed._functional_collectives as funcol

    fake_world(8)
    mesh = make_debug_mesh(device="cpu")
    x = torch.randn(8, 8)
    with CostMode() as cm:
        for _ in range(5):
            x = funcol.all_reduce(x @ x, "sum", (mesh, 0))
        funcol.wait_tensor(x)
    hc = cm.cost({"loop": 5})
    assert hc.flops == 2 * 8 * 8 * 8 * 5
    assert hc.collective_bytes == 8 * 8 * 4 * 5
    assert hc.collective_by_type == {"all-reduce": 8 * 8 * 4 * 5}
    assert hc.collective_count == 5 and hc.trip_counts == {"loop": 5}


def test_live_bytes_count_views_once():
    """The tracker adds a new storage once (a view of it adds nothing) and
    takes it off when it is freed; the peak stays."""
    with CostMode() as cm:
        a = torch.empty(1024, device="meta") + 1  # 4 KiB
        v = a.view(32, 32).t()
        b = a * 2  # 4 KiB more
        del a, v, b
    assert cm.peak_bytes == 8192 and cm.live_bytes == 0


def test_roofline_terms_use_the_h100():
    rf = roofline_terms(per_device_flops=PEAK_FLOPS, per_device_bytes=HBM_BW,
                        per_device_collective_bytes={"nvlink": NVLINK_BW,
                                                     "infiniband": 2 * IB_BW},
                        chips=4, model_flops=2 * PEAK_FLOPS)
    assert (rf.compute_s, rf.memory_s, rf.collective_s) == (1.0, 1.0, 3.0)
    assert rf.bottleneck == "collective" and rf.hlo_flops == 4 * PEAK_FLOPS
    assert rf.flops_ratio == 0.5
    # a plain byte count is charged at NVLink's rate
    assert roofline_terms(1, 1, NVLINK_BW, 1, 1).collective_s == 1.0


def test_groups_inside_a_node_use_nvlink(fake_world):
    """Ranks row-major, eight to a node: the debug mesh's groups stay in
    one node; on 16 x 16 the 16-wide 'model' axis spans two nodes, and
    'data' (ranks 16 apart) spans sixteen."""
    fake_world(256)
    mesh = make_mesh((16, 16), ("data", "model"), "cpu")
    assert [group_link(mesh.get_group(a).group_name)
            for a in ("data", "model")] == ["infiniband", "infiniband"]
    dist.destroy_process_group()
    fake_world(8)
    mesh = make_debug_mesh(device="cpu")
    assert [group_link(mesh.get_group(a).group_name)
            for a in ("data", "model")] == ["nvlink", "nvlink"]


def test_registered_strategies_compute_locally(fake_world):
    """launch/strategies.py's placements for the ops torch 2.11 has no
    strategy for: each rank's shard of the result is the plain result's
    shard (no communication is needed, so the fake group computes it)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import shard_ctx
    from repro_torch.launch.strategies import register

    fake_world(8)
    mesh = make_debug_mesh(device="cpu")
    register()
    shard_ctx(mesh)
    x = torch.arange(32.0).reshape(8, 4)
    src = -torch.arange(8.0).reshape(2, 4)
    index = torch.tensor([5, 2])

    def placed(t, pl):
        return distribute_tensor(t, mesh, pl, src_data_rank=None)

    split, whole = [Replicate(), Shard(1)], [Replicate(), Replicate()]
    got = placed(x.clone(), split).index_copy_(0, placed(index, whole),
                                               placed(src, split))
    assert tuple(got.placements) == tuple(split)
    assert torch.equal(got.to_local(),
                       x.clone().index_copy_(0, index, src)[:, :1])
    got = placed(x, split).index_fill(0, placed(index, whole), 7.0)
    assert torch.equal(got.to_local(), x.index_fill(0, index, 7.0)[:, :1])
    got = placed(x.clone(), split)
    got.detach_()
    assert tuple(got.placements) == tuple(split)


def test_shape_support_matrix():
    """tests/test_models.py's matrix, re-rooted at repro_torch.configs."""
    counts = {a: len(supported_shapes(get_config(a))) for a in ARCH_IDS}
    # ssm/hybrid + gemma3 run long_500k; pure full-attention archs skip it
    assert counts["mamba2-130m"] == 4
    assert counts["zamba2-1.2b"] == 4
    assert counts["gemma3-27b"] == 4
    assert counts["granite-34b"] == 3
    assert sum(counts.values()) == 33


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_bytes_match_jax(fake_world, arch):
    """On the debug and production meshes: the DTensor local shards the
    dry run builds hold sharded_bytes_per_device bytes, the JAX package's
    count on the same mesh (its AbstractMesh)."""
    cfg, jcfg = get_config(arch), jx_get_config(arch)
    params = jax.eval_shape(lambda: JM.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    for (debug, multi_pod), (shape, axes) in dryrun.MESHES.items():
        exp = jx_sharded_bytes(params, jx_tree_shardings(
            JM.param_axes(jcfg), params,
            jax.sharding.AbstractMesh(shape, axes)))
        fake_world(int(torch.tensor(shape).prod()))
        mesh = make_mesh(shape, axes, "cpu")
        model, analytic = dryrun._sharded_model(cfg, mesh)
        local = sum(p.to_local().numel() * p.element_size()
                    for p in model.parameters())
        dist.destroy_process_group()
        assert local == analytic == exp, (shape, local, analytic, exp)


def test_cuda_mesh_refuses_without_a_card():
    """The default device is the card: without one the cell raises, names
    device='cpu', and leaves no process group behind."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.run_cell("mamba2-130m", "decode_32k", False, True)
    assert not dist.is_initialized()


def test_a_failed_cell_fails_the_run(capsys):
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "no-such-arch", "--shape", "train_4k",
                     "--debug-mesh", "--device", "cpu"])
    assert exc.value.code == "1 dry-run cells failed"
    assert "FAIL no-such-arch x train_4k x debug_2x4: KeyError" in \
        capsys.readouterr().out


@pytest.mark.slow
def test_debug_mesh_dryrun_cells(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    out_dir = str(tmp_path)
    for arch, shape in [("mamba2-130m", "train_4k"), ("qwen3-14b", "decode_32k")]:
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
             "--shape", shape, "--debug-mesh", "--device", "cpu",
             "--out-dir", out_dir],
            capture_output=True, text=True, env=env, timeout=560,
        )
        assert r.returncode == 0, r.stdout + r.stderr[-2000:]
        assert "OK" in r.stdout
    files = sorted(os.listdir(out_dir))
    assert files == ["mamba2-130m__train_4k__debug_2x4.json",
                     "qwen3-14b__decode_32k__debug_2x4.json"]
    for name in files:
        with open(os.path.join(out_dir, name)) as f:
            art = json.load(f)
        rf = art["roofline"]
        assert rf["hlo_flops"] > 0 and rf["bottleneck"] in (
            "compute", "memory", "collective")
        assert art["device"] == "cpu" and art["chips"] == 8
        mem = art["memory_analysis"]
        assert art["peak_bytes_per_device"] == \
            mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]


def test_artifacts_exist_for_all_cells():
    """The full production-mesh matrix must have been generated."""
    d = os.path.join(REPO, "experiments", "dryrun_torch")
    if not os.path.isdir(d):
        pytest.skip("run `python -m repro_torch.launch.dryrun --all "
                    "--both-meshes`")
    names = os.listdir(d)
    single = [n for n in names if "__16x16" in n and "debug" not in n]
    multi = [n for n in names if "__2x16x16" in n]
    assert len(single) >= 33, f"expected 33 single-pod cells, got {len(single)}"
    assert len(multi) >= 33, f"expected 33 multi-pod cells, got {len(multi)}"
