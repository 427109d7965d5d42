"""Device meshes over ``torch.distributed``, as the JAX package builds them.

The production mesh is 16 x 16 ``("data", "model")`` (256 ranks); the
multi-pod mesh adds a leading ``"pod"`` axis (2 x 16 x 16), pure data
parallelism.  The debug meshes are 2 x 4 and 2 x 2 x 2 (8 ranks).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` made by
``init_device_mesh`` on a process group that :func:`init_process_group`
(or the caller) has started, one process a rank, whose world size is the
mesh's size.  Meshes are made by functions, never at import.  Each entry
point works on the card unless the caller passes ``device="cpu"``:
``cuda`` runs over NCCL, ``cpu`` over gloo, and nothing falls back from
one to the other.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .sharding import axis_sizes

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _device_type(device: Optional[str]) -> str:
    """The device type of ``device``, ``"cuda"`` when it is None; raises
    for a card that is not there (pass ``device="cpu"`` to run on gloo)."""
    device_type = "cuda" if device is None else torch.device(device).type
    if device_type not in BACKENDS:
        raise ValueError(f"device {device!r}: want one of "
                         f"{sorted(BACKENDS)}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the distributed layer runs on an NVIDIA GPU over NCCL and none "
            "is present; pass device='cpu' to run on the CPU over gloo")
    return device_type


def init_process_group(rank: int, world_size: int, *,
                       device: Optional[str] = None,
                       init_method: Optional[str] = None,
                       store=None) -> str:
    """Start this process's default group: NCCL on ``cuda`` (rank r takes
    card ``r % device_count``), gloo on ``cpu``.  Rendezvous through
    ``init_method`` (``"file://<path>"``, ``"tcp://host:port"``) or a
    ``store``.  Returns the backend."""
    device_type = _device_type(device)
    if (init_method is None) == (store is None):
        raise ValueError("pass one of init_method= and store=")
    backend = BACKENDS[device_type]
    kwargs = {}
    if device_type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method, store=store,
                            rank=rank, world_size=world_size, **kwargs)
    return backend


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device: Optional[str] = None) -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the default group, whose
    world size must be the product of ``shape``."""
    return init_device_mesh(_device_type(device), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[str] = None) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_debug_mesh(*, multi_pod: bool = False,
                    device: Optional[str] = None) -> DeviceMesh:
    """Small mesh for CI-sized runs (8 ranks)."""
    shape = (2, 2, 2) if multi_pod else (2, 4)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def dp_axes(mesh) -> Tuple[str, ...]:
    names = mesh.mesh_dim_names or ()
    return tuple(a for a in ("pod", "data") if a in names)


def shard_ctx(mesh):
    from ..models.layers import ShardCtx

    return ShardCtx(dp=dp_axes(mesh), tp="model", axis_sizes=axis_sizes(mesh))
