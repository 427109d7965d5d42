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

The port has no device mesh until ROADMAP A8, so ``shardings`` is a tree
of ``None`` (one device): every leaf is written whole as shard 0 of 1 with
spec ``null`` and an empty ``mesh_shape``, and restored onto its
prototype's device.  Once A8 brings a mesh, the tree's leaves are the
placements the leaves take there.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

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


def _one_device(shardings) -> None:
    if shardings is not None and any(
            s is not None for _, s in _flatten(shardings)):
        raise NotImplementedError(
            "the port has no device mesh yet (ROADMAP A8): shardings must "
            "be a tree of None")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pending: Optional[threading.Thread] = None

    def _dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, shardings=None, blocking: bool = True):
        """Write the checkpoint of ``step``; with ``blocking=False`` the
        files are written on a thread after the copy to the host."""
        self.wait()  # one save in flight at a time
        leaves = list(_flatten(tree))
        _one_device(shardings)
        host = [(path, *_to_host(leaf)) for path, leaf in leaves]

        def write():
            d = self._dir(step)
            tmp = d + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, SHARD), **{p: a for p, a, _ in host})
            manifest = {
                "step": step,
                "mesh_shape": {},
                "leaves": [{"path": p, "shape": list(a.shape), "dtype": dt,
                            "spec": None} for p, a, dt in host],
                "written_at": time.time(),
            }
            with open(os.path.join(tmp, MANIFEST), "w") as f:
                json.dump(manifest, f)
            if os.path.isdir(d):
                shutil.rmtree(d)
            os.replace(tmp, d)
            self._gc()

        if blocking:
            write()
        else:
            self._pending = threading.Thread(target=write, daemon=True)
            self._pending.start()
        return step

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

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
        is not a tensor)."""
        steps = self.list_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        step = step if step is not None else steps[-1]
        d = self._dir(step)
        with open(os.path.join(d, MANIFEST)) as f:
            manifest = json.load(f)
        dtypes = {m["path"]: m["dtype"] for m in manifest["leaves"]}
        protos = list(_flatten(tree_like))
        _one_device(shardings)
        out = []
        with np.load(os.path.join(d, SHARD)) as data:
            for path, proto in protos:
                arr = data[path]
                if dtypes.get(path) == "bfloat16":
                    t = torch.from_numpy(arr.view(np.int16)).view(
                        torch.bfloat16)
                else:
                    t = torch.from_numpy(arr)
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
