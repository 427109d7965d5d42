"""Checkpoint and restore in the JAX package's on-disk format, and
save-on-preemption.

A checkpoint of step s is a directory ``step_<s, 10 digits>/`` (written as
``.tmp`` and renamed) holding ``shard_0_of_1.npz`` (one array per leaf,
named by its path; bfloat16 stored as its uint16 bits) and
``manifest.json`` (``step``, ``mesh_shape``, ``leaves`` [path, shape,
dtype, spec] and ``written_at``).  Paths are the JAX package's key paths
(``['params']/['embed']``, ``[0]`` for a sequence, ``.mu`` for a
NamedTuple's field; mappings in sorted key order), so either package
restores the other's checkpoints.

Trees are nested mappings, lists, tuples and NamedTuples with tensor,
numpy or scalar leaves (``None`` holds no leaf).  A model goes in as
``dict(model.named_parameters())``, an optimiser state as its
``AdamWState``.  An async save copies every leaf to the host before its
thread starts, so the caller blocks only for that copy; one save is in
flight at a time.

``shardings`` is a tree shaped like ``tree`` (a missing or None leaf: one
device) whose leaves are ``launch.sharding.NamedSharding``s.  A save with
shardings or ``DTensor`` leaves is collective, as the JAX package writes
it: every leaf is gathered whole (``DTensor.full_tensor``), global rank 0
writes ``shard_0_of_1.npz`` and the manifest, with the mesh's ``{axis:
size}`` as ``mesh_shape`` and each leaf's spec as a list (an axis name, a
list of names or null per dimension), and a blocking save returns on
every rank once the files are there (after an async one, once every rank
has called ``wait``).
``restore`` with shardings hands each rank its ``DTensor`` on the new mesh
(``distribute_tensor`` with ``sharding.placements``), so a checkpoint saved
on 4 ranks restores on 8.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from ..launch.sharding import NamedSharding, axis_sizes, placements

MANIFEST = "manifest.json"
SHARD = "shard_0_of_1.npz"


def _flatten(tree, path: Tuple[str, ...] = ()):
    """(path, leaf) pairs in the JAX package's order and key-path text."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (f"[{k!r}]",))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _flatten(getattr(tree, f), path + (f".{f}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (f"[{i}]",))
    else:
        yield "/".join(path), tree


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in order from
    ``leaves`` (an iterator)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(getattr(tree, f), leaves)
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(a host copy as npz stores it, dtype name): bfloat16 as uint16
    bits.  Always a copy, so that the caller may go on writing the leaf
    while an async save runs."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
        return a, str(a.dtype)
    a = np.array(leaf, copy=True)
    if a.dtype.name == "bfloat16":  # ml_dtypes' type, recognised by name
        return a.view(np.uint16), "bfloat16"
    return a, str(a.dtype)


def _spec_to_json(spec) -> list:
    return [list(ax) if isinstance(ax, tuple) else ax for ax in spec]


def _shardings(shardings) -> Dict[str, NamedSharding]:
    """The NamedSharding of each leaf path that has one."""
    out = {}
    for path, s in _flatten(shardings):
        if not isinstance(s, NamedSharding):
            raise NotImplementedError(
                f"{path}: a sharding is a launch.sharding.NamedSharding on "
                f"the port's mesh (ROADMAP A8) or None, not {s!r}")
        out[path] = s
    return out


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pending: Optional[threading.Thread] = None
        self._sync = False  # a collective save has yet to be waited for

    def _dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, shardings=None, blocking: bool = True):
        """Write the checkpoint of ``step``; with ``blocking=False`` the
        files are written on a thread after the copy to the host."""
        self.wait()  # one save in flight at a time
        shards = _shardings(shardings)
        host, mesh_shape, collective = [], {}, bool(shards)
        for path, leaf in _flatten(tree):
            if isinstance(leaf, DTensor):
                leaf = leaf.full_tensor()  # collective: every rank calls
                collective = True
            sh = shards.get(path)
            if sh is not None:
                mesh_shape = axis_sizes(sh.mesh)
            host.append((path, *_to_host(leaf),
                         None if sh is None else _spec_to_json(sh.spec)))
        writes = not collective or dist.get_rank() == 0

        def write():
            d = self._dir(step)
            tmp = d + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, SHARD),
                     **{p: a for p, a, _, _ in host})
            manifest = {
                "step": step,
                "mesh_shape": mesh_shape,
                "leaves": [{"path": p, "shape": list(a.shape), "dtype": dt,
                            "spec": spec} for p, a, dt, spec in host],
                "written_at": time.time(),
            }
            with open(os.path.join(tmp, MANIFEST), "w") as f:
                json.dump(manifest, f)
            if os.path.isdir(d):
                shutil.rmtree(d)
            os.replace(tmp, d)
            self._gc()

        self._sync = collective
        if writes and blocking:
            write()
        elif writes:
            self._pending = threading.Thread(target=write, daemon=True)
            self._pending.start()
        if blocking:
            self.wait()
        return step

    def wait(self) -> None:
        """Wait for the save in flight; collective after a collective
        save."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._sync:
            self._sync = False
            dist.barrier()

    def _gc(self) -> None:
        for s in self.list_steps()[: -self.keep]:
            shutil.rmtree(self._dir(s), ignore_errors=True)

    def list_steps(self) -> List[int]:
        return sorted(int(name.split("_")[1])
                      for name in os.listdir(self.directory)
                      if name.startswith("step_")
                      and not name.endswith(".tmp"))

    # --------------------------------------------------------------- restore
    def restore(self, tree_like, step: Optional[int] = None,
                shardings=None):
        """(tree, step): the checkpoint of ``step`` (the latest by
        default) in the structure of ``tree_like``, every leaf a tensor of
        the saved dtype on its prototype's device (the CPU for a leaf that
        is not a tensor), or, where ``shardings`` has a NamedSharding, this
        rank's DTensor on its mesh."""
        steps = self.list_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        step = step if step is not None else steps[-1]
        d = self._dir(step)
        with open(os.path.join(d, MANIFEST)) as f:
            manifest = json.load(f)
        dtypes = {m["path"]: m["dtype"] for m in manifest["leaves"]}
        protos = list(_flatten(tree_like))
        shards = _shardings(shardings)
        out = []
        with np.load(os.path.join(d, SHARD)) as data:
            for path, proto in protos:
                arr = data[path]
                if dtypes.get(path) == "bfloat16":
                    t = torch.from_numpy(arr.view(np.int16)).view(
                        torch.bfloat16)
                else:
                    t = torch.from_numpy(arr)
                sh = shards.get(path)
                if sh is not None:
                    out.append(distribute_tensor(
                        t, sh.mesh, placements(sh.spec, sh.mesh)))
                    continue
                device = (proto.device if isinstance(proto, torch.Tensor)
                          else "cpu")
                out.append(t.to(device))
        return _unflatten(tree_like, iter(out)), step


def install_preemption_handler(save_fn: Callable[[], None]):
    """Flush a checkpoint when the scheduler preempts the job (SIGTERM),
    then exit with 143."""

    def handler(signum, frame):
        save_fn()
        raise SystemExit(143)

    signal.signal(signal.SIGTERM, handler)
    return handler
