"""The port's meshes, sharding resolver and axes trees against the JAX
package's (``repro.launch.sharding``, ``repro.models.*_axes``).

The JAX side resolves against an ``AbstractMesh`` (it reads only the
mesh's axis sizes), the port's against the same ``{axis: size}``; the
meshes are the production (16, 16) and (2, 16, 16), the debug (2, 4) and
the relational tests' (4, 2).  Shapes come from ``jax.eval_shape`` of the
JAX package's ``init_params`` / ``init_cache`` and, for the port's own
parameter names, from an ``LM`` on the meta device.  The production mesh
itself is built under the fake process group (256 and 512 ranks).
"""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs.base import ARCH_IDS as JX_ARCH_IDS
from repro.configs.base import get_config as jx_get_config
from repro.configs.base import reduced_config as jx_reduced_config
from repro.launch.sharding import _is_axes_leaf as jx_is_axes_leaf
from repro.launch.sharding import resolve_pspec as jx_resolve_pspec
from repro.launch.sharding import \
    sharded_bytes_per_device as jx_sharded_bytes
from repro.launch.sharding import tree_shardings as jx_tree_shardings
from repro.models import model as JM
from repro_torch.configs.base import ARCH_IDS, get_config, reduced_config
from repro_torch.launch.mesh import (dp_axes, make_debug_mesh,
                                     make_production_mesh, shard_ctx)
from repro_torch.launch.sharding import (_is_axes_leaf, placements,
                                         resolve_pspec,
                                         sharded_bytes_per_device,
                                         tree_shardings)
from repro_torch.models import model as M

MESHES = {"prod": ((16, 16), ("data", "model")),
          "prod_multi_pod": ((2, 16, 16), ("pod", "data", "model")),
          "debug": ((2, 4), ("data", "model")),
          "relational": ((4, 2), ("data", "model"))}
TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "int32": torch.int32}
CACHE = (8, 1024)  # batch, max_seq


def _configs(arch, size):
    if size == "full":
        return get_config(arch), jx_get_config(arch)
    return (reduced_config(get_config(arch)),
            jx_reduced_config(jx_get_config(arch)))


def _jx_shapes(cfg):
    params = jax.eval_shape(lambda: JM.init_params(cfg, jax.random.PRNGKey(0)))
    cache = jax.eval_shape(lambda: JM.init_cache(cfg, *CACHE))
    return params, cache


def _pairs(axes, shapes, path=()):
    """(path, axes, shape) for each axes leaf, in the JAX package's leaf
    order."""
    if jx_is_axes_leaf(axes):
        return [(path, axes, tuple(shapes.shape))]
    keys = sorted(axes) if isinstance(axes, dict) else range(len(axes))
    return [x for k in keys for x in _pairs(axes[k], shapes[k], path + (k,))]


def _meta(shapes):
    """The JAX shape tree as meta tensors of the same shapes and dtypes."""
    return jax.tree.map(lambda s: torch.empty(
        s.shape, dtype=TORCH_DTYPES[str(s.dtype)], device="meta"), shapes)


def test_arch_ids_match():
    assert ARCH_IDS == JX_ARCH_IDS


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_axes_trees_match_jax(arch, size):
    """param_axes and cache_axes (batch on data or the sequence on data)
    equal the JAX package's trees, leaf for leaf."""
    cfg, jcfg = _configs(arch, size)
    assert M.param_axes(cfg) == JM.param_axes(jcfg)
    for dp_over_seq in (False, True):
        assert M.cache_axes(cfg, CACHE[0], dp_over_seq) == \
            JM.cache_axes(jcfg, CACHE[0], dp_over_seq)


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_resolve_pspec_matches_jax(arch, size):
    """On every mesh, with expand_data off and on: resolve_pspec over every
    leaf of param_axes and cache_axes equals the JAX package's
    PartitionSpec element for element, and sharded_bytes_per_device of the
    parameters and of the cache equals its count."""
    cfg, jcfg = _configs(arch, size)
    params, cache = _jx_shapes(jcfg)
    trees = {"params": (M.param_axes(cfg), JM.param_axes(jcfg), params)}
    for dp_over_seq in (False, True):
        trees[f"cache{dp_over_seq}"] = (
            M.cache_axes(cfg, CACHE[0], dp_over_seq),
            JM.cache_axes(jcfg, CACHE[0], dp_over_seq), cache)
    for mesh_name, (shape, names) in MESHES.items():
        jmesh = jax.sharding.AbstractMesh(shape, names)
        sizes = dict(zip(names, shape))
        for expand in (False, True):
            for tree, (axes, jaxes, shapes) in trees.items():
                mine = _pairs(axes, shapes)
                theirs = _pairs(jaxes, shapes)
                assert [p for p, _, _ in mine] == [p for p, _, _ in theirs]
                for (path, ax, s), (_, jax_ax, _) in zip(mine, theirs):
                    exp = tuple(jx_resolve_pspec(jax_ax, s, jmesh,
                                                 expand_data=expand))
                    got = resolve_pspec(ax, s, sizes, expand_data=expand)
                    assert got == exp, (mesh_name, expand, tree, path)
                got = sharded_bytes_per_device(
                    _meta(shapes),
                    tree_shardings(axes, _meta(shapes), sizes, expand))
                exp = jx_sharded_bytes(
                    shapes, jx_tree_shardings(jaxes, shapes, jmesh, expand))
                assert got == exp, (mesh_name, expand, tree)


def _jx_specs_by_name(jcfg, jaxes, shapes, jmesh):
    """The JAX package's spec of every parameter, under the port's
    parameter names: the scanned leaf of pattern position i, without its
    period axis, for each layer p * period + i; the tail after."""
    out = {}
    period = jcfg.pattern_period
    base = jcfg.num_periods * period
    for path, ax, s in _pairs(jaxes, shapes):
        spec = tuple(jx_resolve_pspec(ax, s, jmesh))
        rest = ".".join(str(k) for k in path[2:])
        if path[0] == "scan":
            assert spec[0] is None
            for p in range(jcfg.num_periods):
                out[f"layers.{p * period + path[1]}.{rest}"] = spec[1:]
        elif path[0] == "tail":
            out[f"layers.{base + path[1]}.{rest}"] = spec
        else:
            out[".".join(str(k) for k in path)] = spec
    return out


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_named_param_specs_match_jax(arch, size):
    """tree_shardings over the port's LM (named_param_axes against its
    parameters on the meta device) gives each parameter the JAX package's
    spec of the same leaf."""
    cfg, jcfg = _configs(arch, size)
    params, _ = _jx_shapes(jcfg)
    model = M.LM(cfg, device="meta")
    named = dict(model.named_parameters())
    for mesh_name, (shape, names) in MESHES.items():
        sizes = dict(zip(names, shape))
        got = tree_shardings(M.named_param_axes(cfg), named, sizes)
        exp = _jx_specs_by_name(jcfg, JM.param_axes(jcfg), params,
                                jax.sharding.AbstractMesh(shape, names))
        assert {k: v.spec for k, v in got.items()} == exp, mesh_name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_mirror_params(arch):
    """tests/test_models.py's check, re-rooted at the port: one axes leaf
    per parameter (the LM's names), none longer than its parameter's rank;
    and param_axes has as many leaves as the JAX package's parameter
    tree."""
    cfg = reduced_config(get_config(arch))
    model = M.LM(cfg, device="meta")
    axes = M.named_param_axes(cfg)
    params = dict(model.named_parameters())
    assert set(axes) == set(params)
    for name, p in params.items():
        a = axes[name]
        assert len(a) <= p.dim() or all(x is None for x in a[p.dim():]), name
    jparams, _ = _jx_shapes(jx_reduced_config(jx_get_config(arch)))
    from repro_torch.launch.sharding import tree_leaves
    assert len(tree_leaves(M.param_axes(cfg), is_leaf=_is_axes_leaf)) == \
        len(jax.tree.leaves(jparams))


@pytest.fixture()
def fake_world():
    """Start the fake process group of a given world size (no processes,
    no communication); destroyed after the test."""
    def start(world_size, rank=0):
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world_size)

    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_under_fake_pg(fake_world, multi_pod):
    fake_world(512 if multi_pod else 256, rank=3)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    assert tuple(mesh.shape) == shape and mesh.mesh_dim_names == names
    assert mesh.device_type == "cpu"
    assert list(mesh.get_coordinate()) == [0] * (len(shape) - 1) + [3]
    assert dp_axes(mesh) == (("pod", "data") if multi_pod else ("data",))
    ctx = shard_ctx(mesh)
    assert ctx.dp == dp_axes(mesh) and ctx.tp == "model"
    assert ctx.axis_sizes == dict(zip(names, shape))
    assert ctx.dp_spec == dp_axes(mesh)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_debug_mesh_and_placements(fake_world, multi_pod):
    fake_world(8)
    mesh = make_debug_mesh(multi_pod=multi_pod, device="cpu")
    if not multi_pod:
        assert tuple(mesh.shape) == (2, 4)
        assert placements(("data", None), mesh) == (Shard(0), Replicate())
        assert placements((None, "model"), mesh) == (Replicate(), Shard(1))
        assert placements(("model", "data"), mesh) == (Shard(1), Shard(0))
        return
    assert tuple(mesh.shape) == (2, 2, 2)
    spec = resolve_pspec(("data", "model"), (64, 64), mesh, expand_data=True)
    assert spec == (("pod", "data"), "model")
    assert placements(spec, mesh) == (Shard(0), Shard(0), Shard(1))
    with pytest.raises(ValueError, match="mesh's order"):
        placements((("data", "pod"), None), mesh)


def test_mesh_entry_points_refuse_without_a_card():
    """With no CUDA, asking for the card raises and names the CPU; nothing
    falls back to gloo."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_debug_mesh()
    from repro_torch.launch.mesh import init_process_group
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_process_group(0, 1, init_method="file:///nonexistent")
