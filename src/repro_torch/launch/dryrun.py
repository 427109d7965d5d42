"""Multi-pod dry run: trace every (arch x shape x mesh) cell, allocating
nothing.

For every cell the dry run:

  1. starts the fake process group (no processes, no communication) at the
     mesh's world size and builds the mesh on it: the production 16 x 16
     (256 ranks) or 2 x 16 x 16 (512), or the 8-rank debug mesh;
  2. builds the ``LM`` on the meta device and turns each parameter into a
     ``DTensor`` placed as the divisibility-aware resolver places it, and
     the AdamW state, batch or cache likewise;
  3. runs the train, prefill (the plain scan and attention: a CUDA kernel
     has no meta version) or decode step once under ``CostMode``, which
     counts what rank 0 runs (``launch.hlo_analysis``);
  4. writes the memory account, FLOPs, bytes, collectives and the H100
     roofline to ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--both-meshes] [--debug-mesh]

The mesh is a ``cuda`` mesh unless ``--device cpu`` (``device="cpu"``)
asks for a ``cpu`` one; the tensors stay on the meta device either way,
but DTensor picks its collectives by the mesh's device (on ``cpu`` an
all-to-all becomes an all-gather).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Dict, Optional, Tuple, Union

import torch

from ..configs.base import (ARCH_IDS, LM_SHAPES, ModelConfig, ShapeConfig,
                            get_config, load_all, supported_shapes)
from ..models import model as M
from ..train.optimizer import adamw_init
from ..train.steps import (input_specs, make_prefill_step, make_serve_step,
                           make_train_step)
from .hlo_analysis import HBM_BYTES, CostMode, roofline_terms
from .mesh import make_mesh, shard_ctx
from .sharding import (NamedSharding, _is_axes_leaf, placements,
                       resolve_pspec, sharded_bytes_per_device, tree_leaves,
                       tree_map, tree_shardings)

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

# microbatch (gradient accumulation) counts per train cell: keeps the
# per-microbatch logits sharded-small
TRAIN_MICROBATCHES = {"default": 8}

MESHES = {  # (debug, multi_pod) -> (shape, axes)
    (False, False): ((16, 16), ("data", "model")),
    (False, True): ((2, 16, 16), ("pod", "data", "model")),
    (True, False): ((2, 4), ("data", "model")),
    (True, True): ((2, 2, 2), ("pod", "data", "model")),
}


def _dp_size(mesh) -> int:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return math.prod(sizes[a] for a in ("pod", "data") if a in sizes)


def _layer_cache_axes(cfg: ModelConfig, tree) -> list:
    """The JAX package's cache-axes tree, one entry per layer in layer
    order, a scanned leaf without its period axis."""
    scanned = cfg.pattern_period * cfg.num_periods
    per = [tree_map(lambda a: tuple(a[1:]),
                    tree["scan"][i % cfg.pattern_period], is_leaf=_is_axes_leaf)
           for i in range(scanned)]
    return per + list(tree["tail"])


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh, specs):
    """Input shardings: batch dims over (pod, data); the cache's sequence
    dim over data when the batch does not divide the data-parallel axes
    (long_500k, batch 1).  ``specs`` is ``input_specs``'s (train: its
    ``batch``); the cache comes back as a list, one dict a layer."""
    dp = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)

    def batch_leaf(leaf):
        pref = (dp,) + (None,) * (len(leaf.shape) - 1)
        return NamedSharding(mesh, resolve_pspec(pref, leaf.shape, mesh))

    if shape.kind in ("train", "prefill"):
        return {k: batch_leaf(v) for k, v in specs.items()}
    dp_over_seq = shape.global_batch % _dp_size(mesh) != 0
    cache_ax = M.cache_axes(cfg, shape.global_batch, dp_over_seq)
    if dp_over_seq:
        def retarget(ax):
            # as the JAX package moves 'data' from the batch dim to the
            # sequence dim of its (periods, B, S, H, hd) leaves: every leaf
            # of four or more dims whose second dim is on 'data'
            ax = list(ax)
            if len(ax) >= 4 and ax[1] == "data":
                ax[1], ax[2] = None, "data"
            return tuple(ax)
        cache_ax = tree_map(retarget, cache_ax, is_leaf=_is_axes_leaf)
    return {
        "inputs": batch_leaf(specs["inputs"]),
        "pos": NamedSharding(mesh, ()),
        "cache": tree_shardings(_layer_cache_axes(cfg, cache_ax),
                                specs["cache"], mesh, expand_data=True),
    }


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE); decode: D = new tokens only."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # one token per sequence


def _distribute(t: torch.Tensor, sharding: NamedSharding):
    """``t`` as a DTensor placed by ``sharding``; on a mesh of one device
    ``t`` itself, so that the step traced is the plain program one card
    runs (the models take a plain tensor's path through every
    constraint)."""
    from torch.distributed.tensor import distribute_tensor

    if sharding.mesh.size() == 1:
        return t
    return distribute_tensor(t, sharding.mesh,
                             placements(sharding.spec, sharding.mesh),
                             src_data_rank=None)


def _meta(spec) -> torch.Tensor:
    return torch.empty(spec.shape, dtype=spec.dtype, device="meta")


def _local_bytes(tree) -> int:
    """Bytes of the local shards of a tree of DTensors (and tensors)."""
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            local = t.to_local() if hasattr(t, "to_local") else t
            total += local.numel() * local.element_size()
    return total


def _sharded_model(cfg: ModelConfig, mesh) -> Tuple[torch.nn.Module, int]:
    """The LM on the meta device, each parameter a DTensor placed by the
    resolver; and the analytic bytes a device holds of them."""
    model = M.LM(cfg, device="meta")
    named = dict(model.named_parameters())
    param_sh = tree_shardings(M.named_param_axes(cfg), named, mesh)
    for name, p in named.items():
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner) if owner else model
        setattr(module, leaf,
                torch.nn.Parameter(_distribute(p.detach(), param_sh[name])))
    return model, sharded_bytes_per_device(named, param_sh)


def _mesh_name(debug_mesh: bool, shape) -> str:
    return ("debug_" if debug_mesh else "") + "x".join(map(str, shape))


def _trace(cfg: ModelConfig, shape: ShapeConfig, mesh, mb: int):
    """Runs the cell's step once under CostMode; returns (CostMode, param
    bytes analytic, param bytes traced, argument, output and alias
    bytes, trip counts)."""
    ctx = shard_ctx(mesh)
    specs = input_specs(cfg, shape)
    trips = {"periods": cfg.num_periods}
    serving = shape.kind != "train"
    with torch.inference_mode(serving):
        model, param_bytes = _sharded_model(cfg, mesh)
        params = dict(model.named_parameters())
        if shape.kind == "train":
            trips["microbatches"] = mb
            # the moments are placed like their parameters
            # (adamw_state_axes): zeros_like keeps each one's placements
            opt = adamw_init(model)
            bsh = batch_shardings(cfg, shape, mesh, specs["batch"])
            batch = {k: _distribute(_meta(v), bsh[k])
                     for k, v in specs["batch"].items()}
            args = (params, opt, batch)
            step = make_train_step(cfg, ctx, microbatches=mb)
            with CostMode() as cm:
                _, opt, metrics = step(model, opt, batch)
            outputs, alias = (params, opt, metrics), (params, opt)
        elif shape.kind == "prefill":
            bsh = batch_shardings(cfg, shape, mesh, specs)
            inputs = _distribute(_meta(specs["inputs"]), bsh["inputs"])
            args = (params, inputs)
            step = make_prefill_step(cfg, ctx, use_kernel=False)
            with CostMode() as cm:
                out = step(model, inputs)
            outputs, alias = out, ()
        else:
            bsh = batch_shardings(cfg, shape, mesh, specs)
            inputs = _distribute(_meta(specs["inputs"]), bsh["inputs"])
            cache = [{k: _distribute(_meta(v), s[k]) for k, v in c.items()}
                     for c, s in zip(specs["cache"], bsh["cache"])]
            args = (params, cache, inputs)
            step = make_serve_step(cfg, ctx)
            with CostMode() as cm:
                out, cache = step(model, cache, inputs, shape.seq_len - 1)
            outputs, alias = (out, cache), cache
        traced = _local_bytes(params)
        mem = (_local_bytes(args), _local_bytes(outputs), _local_bytes(alias))
    return cm, param_bytes, traced, mem, trips


def run_cell(arch: str, shape_name: Union[str, ShapeConfig], multi_pod: bool,
             debug_mesh: bool, out_dir: str = OUT_DIR,
             mb_override: Optional[int] = None, attn_impl: str = "blocked",
             remat_mode: str = "per_period", tag: str = "",
             device: Optional[str] = None,
             mesh_shape: Optional[Tuple[int, ...]] = None) -> Dict:
    """Traces one cell and writes its artifact; returns the artifact.
    ``shape_name`` is an ``LM_SHAPES`` key or a ``ShapeConfig``;
    ``mesh_shape`` replaces the production or debug mesh by a ("data",
    "model") mesh of that shape (chip_smoke's world size 1)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from ..models.layers import set_attention_impl
    from ..models.model import set_remat_mode

    set_attention_impl(attn_impl)
    set_remat_mode(remat_mode)
    cfg = get_config(arch)
    shape = (shape_name if isinstance(shape_name, ShapeConfig)
             else LM_SHAPES[shape_name])
    if mesh_shape is not None:
        dims, axes = tuple(mesh_shape), ("data", "model")
        mesh_name = "x".join(map(str, dims))
    else:
        dims, axes = MESHES[(debug_mesh, multi_pod)]
        mesh_name = _mesh_name(debug_mesh, dims)
    chips = math.prod(dims)
    mb = mb_override or TRAIN_MICROBATCHES.get(
        (arch, shape.name), TRAIN_MICROBATCHES["default"])

    t0 = time.time()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=chips)
    try:
        mesh = make_mesh(dims, axes, device)
        cm, param_bytes, traced, (arg_b, out_b, alias_b), trips = _trace(
            cfg, shape, mesh, mb)
        device_type = mesh.device_type
    finally:
        dist.destroy_process_group()
    compile_s = time.time() - t0
    if traced != param_bytes:
        raise AssertionError(f"{arch} {shape.name} {mesh_name}: traced "
                             f"parameter bytes {traced} != sharded_bytes_"
                             f"per_device {param_bytes}")

    hc = cm.cost(trips)
    rf = roofline_terms(
        per_device_flops=hc.flops,
        per_device_bytes=hc.bytes_accessed,
        per_device_collective_bytes=hc.collective_by_link,
        chips=chips,
        model_flops=model_flops(cfg, shape),
    )
    mem = {"argument_size_in_bytes": arg_b, "output_size_in_bytes": out_b,
           "temp_size_in_bytes": cm.peak_bytes,
           "alias_size_in_bytes": alias_b}
    peak = arg_b + cm.peak_bytes
    result = {
        "arch": arch,
        "shape": shape.name,
        "mesh": mesh_name,
        "chips": chips,
        "kind": shape.kind,
        "device": device_type,
        "compile_seconds": round(compile_s, 1),
        "params_total": int(cfg.param_count()),
        "params_active": int(cfg.active_param_count()),
        "param_bytes_per_device": int(param_bytes),
        "memory_analysis": mem,
        "peak_bytes_per_device": peak,
        "fits_h100": peak <= HBM_BYTES,
        "hlo_corrected": {
            "per_device_flops": hc.flops,
            "per_device_bytes": hc.bytes_accessed,
            "loop_trip_counts": hc.trip_counts,
        },
        "collectives": {
            "per_device_bytes_by_type": dict(hc.collective_by_type),
            "per_device_bytes_by_link": dict(hc.collective_by_link),
            "op_count": hc.collective_count,
        },
        "roofline": rf.to_dict(),
        "attn_impl": attn_impl,
        "remat_mode": remat_mode,
    }
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    fname = f"{arch}__{shape.name}__{mesh_name}{suffix}.json"
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(result, f, indent=2)
    return result


def ok_line(cell: str, r: Dict) -> str:
    rf = r["roofline"]
    return (f"OK   {cell}: compile={r['compile_seconds']}s "
            f"compute={rf['compute_s']:.4f}s memory={rf['memory_s']:.4f}s "
            f"coll={rf['collective_s']:.4f}s bound={rf['bottleneck']} "
            f"MF/HF={rf['flops_ratio']:.3f} "
            f"peak={r['peak_bytes_per_device'] / 2**30:.2f}GiB "
            f"fits_h100={r['fits_h100']}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--debug-mesh", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--attn-impl", default="blocked",
                    choices=["blocked", "online"])
    ap.add_argument("--remat-mode", default="per_period",
                    choices=["per_period", "sqrt"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="the mesh's device (default cuda)")
    args = ap.parse_args(argv)

    load_all()
    if args.all:
        cells = [(arch, sh) for arch in ARCH_IDS
                 for sh in supported_shapes(get_config(arch))]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = 0
    t0 = time.time()
    for arch, sh in cells:
        for mp in meshes:
            dims = MESHES[(args.debug_mesh, mp)][0]
            cell = f"{arch} x {sh} x {_mesh_name(args.debug_mesh, dims)}"
            try:
                r = run_cell(arch, sh, mp, args.debug_mesh, args.out_dir,
                             args.microbatches, attn_impl=args.attn_impl,
                             remat_mode=args.remat_mode, tag=args.tag,
                             device=args.device)
                print(ok_line(cell, r), flush=True)
            except Exception as e:  # a cell's failure is reported, then counted
                failures += 1
                print(f"FAIL {cell}: {type(e).__name__}: {e}", flush=True)
                traceback.print_exc()
    print(f"{len(cells) * len(meshes) - failures} of "
          f"{len(cells) * len(meshes)} cells OK in "
          f"{time.time() - t0:.1f} s", flush=True)
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")


if __name__ == "__main__":
    main()
