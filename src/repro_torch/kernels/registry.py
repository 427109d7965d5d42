"""Engine registry: resolves ``cuda`` vs ``ref`` kernel backends.

Every ported kernel package registers its implementations here under a
stable kernel name (``filter_eval``, ``key_lookup``, ``hash_group``,
``hash_group_minmax``, ``hash_partition``, ``bloom_probe`` on the SQL side;
``ssd_scan`` and ``flash_attention`` on the LM side).  Callers resolve a
backend by name + engine selector:

  * ``cuda``   — the hand-written CUDA kernel's wrapper (``pallas`` is an
                 accepted alias, so configs written for the JAX package keep
                 working); it launches on CUDA tensors and takes the plain
                 torch version only for tensors that lie on the CPU;
  * ``ref``    — the plain torch version, run on the CPU;
  * ``auto``   — resolves to ``cuda`` here; the executor reads it as "take
                 the numpy host paths" and never resolves a kernel.

Registered functions take and return tensors.  :func:`host_call` adapts one
to the executor's numpy-in/numpy-out contract: it copies every array to the
query's device and brings the result back (one round trip per morsel).
"""
from __future__ import annotations

import functools
import threading
from typing import Callable, Dict, Optional

import numpy as np
import torch

VALID_ENGINES = ("auto", "cuda", "pallas", "ref")

_REGISTRY: Dict[str, Dict[str, Callable]] = {}

# process-wide dispatch tally per "kernel[backend]" — plain int bumps under
# the GIL, as in the JAX package (the executor resolves once per kernel
# call, so concurrent executor threads may drop a bump); surfaced through
# ``Connection.metrics()`` gauges and dispatch_counts()
_DISPATCHES: Dict[str, int] = {}

# process-wide launch tally per kernel: each wrapper adds one where it
# launches its CUDA kernel and nowhere else (executor threads launch
# concurrently, so the read-modify-write holds a lock)
_LAUNCHES: Dict[str, int] = {}
_LAUNCH_LOCK = threading.Lock()


def dispatch_counts() -> Dict[str, int]:
    """Snapshot of per-(kernel, backend) resolve() counts this process."""
    return dict(_DISPATCHES)


def count_launch(kernel: str) -> None:
    with _LAUNCH_LOCK:
        _LAUNCHES[kernel] = _LAUNCHES.get(kernel, 0) + 1


def launch_counts() -> Dict[str, int]:
    """Snapshot of per-kernel CUDA launch counts this process."""
    with _LAUNCH_LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _LAUNCH_LOCK:
        _LAUNCHES.clear()


@functools.cache
def on_gpu() -> bool:
    """True only with a CUDA device of compute capability >= 9.0 (Hopper);
    cached, since the answer cannot change within a process."""
    return (torch.cuda.is_available()
            and torch.cuda.get_device_capability() >= (9, 0))


def validate_engine(engine: str) -> str:
    if engine not in VALID_ENGINES:
        raise ValueError(
            f"unknown engine {engine!r}; expected one of {VALID_ENGINES}"
        )
    return engine


def engine_device(engine: str) -> torch.device:
    """The device a query's kernels run on: the GPU under ``cuda`` (and its
    aliases), the CPU under ``ref`` and ``auto``."""
    validate_engine(engine)
    return torch.device("cpu" if engine in ("ref", "auto") else "cuda")


def register(kernel: str, backend: str, fn: Optional[Callable] = None):
    """Register an implementation; usable directly or as a decorator."""
    if backend not in ("cuda", "ref"):
        raise ValueError(f"backend must be 'cuda' or 'ref', got {backend!r}")

    def _do(f: Callable) -> Callable:
        _REGISTRY.setdefault(kernel, {})[backend] = f
        return f

    return _do(fn) if fn is not None else _do


def backends(kernel: str):
    if kernel not in _REGISTRY:
        _import_all()
    return tuple(sorted(_REGISTRY.get(kernel, {})))


def kernels():
    return tuple(sorted(_REGISTRY))


def resolve(kernel: str, engine: str = "auto") -> Callable:
    """Return the implementation of ``kernel`` for ``engine``."""
    validate_engine(engine)
    impls = _REGISTRY.get(kernel)
    if impls is None:
        # kernel packages self-register on import; pull them in lazily so
        # `resolve` works without callers importing repro_torch.kernels.*
        _import_all()
        impls = _REGISTRY.get(kernel)
        if impls is None:
            raise KeyError(f"no kernel registered under {kernel!r}; "
                           f"have {kernels()}")
    backend = "ref" if engine == "ref" else "cuda"
    if backend not in impls:
        raise KeyError(f"kernel {kernel!r} has no {backend!r} backend; "
                       f"have {backends(kernel)}")
    key = f"{kernel}[{backend}]"
    _DISPATCHES[key] = _DISPATCHES.get(key, 0) + 1
    return impls[backend]


def _to_device(x, device: torch.device):
    if isinstance(x, np.ndarray):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)
    if isinstance(x, (tuple, list)):
        return type(x)(_to_device(v, device) for v in x)
    return x


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if isinstance(x, (tuple, list)):
        return type(x)(_to_host(v) for v in x)
    return x


def host_call(fn: Callable, device: torch.device) -> Callable:
    """Wrap a tensor kernel for numpy callers: every array argument (also
    inside tuples) is copied to ``device``, every tensor result back to a
    numpy array.  A CUDA device without a usable GPU raises here, so a
    query under ``engine: cuda`` never runs on the CPU unnoticed."""

    def call(*args):
        if device.type == "cuda" and not on_gpu():
            raise RuntimeError(
                "engine 'cuda' needs an NVIDIA GPU of compute capability "
                ">= 9.0 and none is present; connect with engine='ref' "
                "(torch on the CPU) or engine='auto' (numpy host paths)")
        return _to_host(fn(*_to_device(args, device)))

    return call


def _import_all() -> None:
    import importlib

    for pkg in ("filter_eval", "hash_group", "key_lookup", "hash_partition",
                "bloom", "ssd_scan", "flash_attention"):
        importlib.import_module(f".{pkg}.ops", __package__)
