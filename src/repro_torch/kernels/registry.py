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
to the executor's numpy-in/numpy-out contract (one round trip per morsel).
On the CPU it wraps the arrays as tensors and the results as arrays.  On
the card each kernel's call is one native call, its *trip*
(:func:`trip`), made through ctypes, which releases the interpreter lock
once for all of it: the morsel's arrays go into the calling thread's
page-locked staging buffer and up in one asynchronous copy on the thread's
own stream, the kernel launches there, the results come back into
page-locked memory, that stream alone is synchronised, and the results are
copied into new numpy arrays.  No torch operation runs per morsel: under
the executor's four threads every release of the interpreter lock costs a
hand-over to another thread, and a call that released it at each tensor
operation spent most of its time waiting for it.  Build-side state that does not change while a join or a
scan runs (a join's dictionary, a runtime filter's bitset) is made once on
the device by :func:`upload` and passed to the calls as a tensor.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import _build
from ..core.obs.trace import current_trace

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
# process-wide tally per kernel of build-side state made on a device by
# upload(): one per join dictionary or runtime filter, never per morsel
_UPLOADS: Dict[str, int] = {}
# tensor kernel -> its executor call on the card in one trip (trip())
_TRIP_CALLS: Dict[Callable, Callable] = {}
# registered implementation -> its kernel's name (the kernel:<name> span)
_NAMES: Dict[Callable, str] = {}
# the argument of a kernel's executor call that holds the morsel (else the
# first): its rows are the kernel span's ``rows``
_MORSEL_ARG = {"key_lookup": 1}
# staging buffers are this many bytes at least, and every array packed into
# one starts at a multiple of _ALIGN (the kernels' 16-byte vector loads)
_MIN_STAGING = 1 << 16
_ALIGN = 128


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


def refuse_autograd(kernel: str, plain: str, *tensors) -> None:
    """Raise where autograd would record a launch of ``kernel``: the CUDA
    kernels have no backward (nor have the JAX package's), so their output
    would carry no history and the parameters upstream would silently get
    no gradient.  ``plain`` names the differentiable route."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward and does not run "
            f"where autograd records; take the plain route ({plain}), or "
            f"call it under torch.no_grad() / torch.inference_mode()")


def count_upload(kernel: str) -> None:
    with _LAUNCH_LOCK:
        _UPLOADS[kernel] = _UPLOADS.get(kernel, 0) + 1


def upload_counts() -> Dict[str, int]:
    """Snapshot of per-kernel build-side uploads (:func:`upload`) this
    process."""
    with _LAUNCH_LOCK:
        return dict(_UPLOADS)


def reset_upload_counts() -> None:
    with _LAUNCH_LOCK:
        _UPLOADS.clear()


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
        _NAMES[f] = kernel
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


def _require_gpu() -> None:
    if not on_gpu():
        raise RuntimeError(
            "engine 'cuda' needs an NVIDIA GPU of compute capability "
            ">= 9.0 and none is present; connect with engine='ref' "
            "(torch on the CPU) or engine='auto' (numpy host paths)")


def upload(array: np.ndarray, device: torch.device,
           kernel: str) -> torch.Tensor:
    """Build-side state of ``kernel``'s calls (a join's dictionary, a
    runtime filter's bitset) as a tensor on ``device``, made once and
    counted in :func:`upload_counts`.  On the card the copy has completed
    when this returns, so a stream of any thread may read the tensor; its
    holder keeps it alive past every call that reads it, since each call
    synchronises its stream before it returns."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        _require_gpu()
        t = t.to(device)
        torch.cuda.current_stream(device).synchronize()
    count_upload(kernel)
    return t


def register_trip(fn: Callable, call: Callable) -> None:
    """``call(device, *args)`` is ``fn``'s executor call on the card in one
    trip: numpy arrays (and tensors from :func:`upload`) in, numpy arrays
    out, as :func:`host_call` makes it for ``fn``."""
    _TRIP_CALLS[fn] = call


class _Lane(threading.local):
    """One thread's stream on the card and its staging buffers: page-locked
    host buffers for a call's inputs and results, and one device buffer for
    both and a kernel's scratch after them.  Each grows to the thread's
    largest call and is reused by its next call, which starts after the
    previous one synchronised."""

    # the shape of the thread's last trip's launch, under the cost model's
    # keys (n rows, g groups or dictionary keys, k columns, words, hashes):
    # the traced host_call reads it into its kernel span's arguments
    shape: Optional[dict] = None

    def __init__(self):
        self.device = None

    def ready(self, device: torch.device, in_bytes: int, out_bytes: int,
              scratch_bytes: int) -> None:
        if device != self.device:
            self.device = device
            self.stream = torch.cuda.Stream(device=device)
            self.handle = self.stream.cuda_stream
            self.sizes = dict.fromkeys(("host_in", "host_out", "dev"), 0)
        need = {"host_in": in_bytes, "host_out": out_bytes,
                "dev": in_bytes + out_bytes + scratch_bytes}
        for which, nbytes in need.items():
            if nbytes > self.sizes[which]:
                self._grow(which, max(nbytes, _MIN_STAGING,
                                      2 * self.sizes[which]))

    def _grow(self, which: str, size: int) -> None:
        if which == "dev":
            with torch.cuda.stream(self.stream):
                buf = torch.empty(size, dtype=torch.uint8,
                                  device=self.device)
        else:
            buf = torch.empty(size, dtype=torch.uint8, pin_memory=True)
        setattr(self, which, buf)
        setattr(self, which + "_ptr", buf.data_ptr())
        self.sizes[which] = size


_LANE = _Lane()


def _offsets(sizes) -> tuple:
    """Start of each of ``sizes`` bytes packed at multiples of _ALIGN, and
    the bytes in all."""
    starts, end = [], 0
    for nbytes in sizes:
        starts.append(end)
        end += -(-nbytes // _ALIGN) * _ALIGN
    return starts, end


def _run(entry: str, *args) -> None:
    """The one native call of a trip; raises on a CUDA error."""
    _build.check(getattr(_build.library(), entry)(*args), entry)


def trip(kernel: str, device: torch.device, inputs, outs,
         launch_args: Callable, scratch_bytes: int = 0,
         shape: Optional[dict] = None) -> list:
    """One executor call of ``kernel`` on the card, by its C entry point
    ``<kernel>_trip`` (csrc/common.cuh: trip): each numpy array of
    ``inputs`` goes up through the thread's staging buffers in one copy,
    each tensor (build-side state from :func:`upload`) is read where it
    lies; ``outs`` lists each result's (dtype, shape);
    ``launch_args(input_pointers, output_pointers)`` gives the arguments of
    ``<kernel>_launch`` before its stream.  ``scratch_bytes`` more of the
    thread's device staging buffer, after the results and never copied,
    are the kernel's scratch: its pointer follows the results' in
    ``output_pointers``.  ``shape`` is the launch's shape under the cost
    model's keys (``n``, ``g``, ``k``, ``words``, ``hashes``), kept for the
    call's ``kernel:<name>`` span.  Returns the results as new numpy
    arrays."""
    arrays = [np.ascontiguousarray(x) for x in inputs
              if isinstance(x, np.ndarray)]
    results = [np.empty(shape, dtype) for dtype, shape in outs]
    starts, in_bytes = _offsets(a.nbytes for a in arrays)
    out_starts, out_bytes = _offsets(r.nbytes for r in results)
    lane = _LANE
    lane.shape = shape
    lane.ready(device, in_bytes, out_bytes, scratch_bytes)
    plan = [len(arrays)]
    for a, at in zip(arrays, starts):
        plan += (a.ctypes.data, at, a.nbytes)
    plan.append(len(results))
    for r, at in zip(results, out_starts):
        plan += (r.ctypes.data, at, r.nbytes)
    base = lane.dev_ptr
    staged = iter(starts)
    ptrs = []
    for x in inputs:
        if isinstance(x, np.ndarray):
            ptrs.append(base + next(staged))
        elif x.is_cuda:
            ptrs.append(x.data_ptr())
        else:
            raise ValueError(f"{kernel}: a tensor argument must lie on the "
                             f"card, got one on {x.device}")
    out_base = base + in_bytes
    out_ptrs = [out_base + o for o in out_starts]
    if scratch_bytes:
        out_ptrs.append(out_base + out_bytes)
    _run(f"{kernel}_trip", (ctypes.c_int64 * len(plan))(*plan),
         lane.host_in_ptr, base, in_bytes, out_base, lane.host_out_ptr,
         out_bytes, *launch_args(ptrs, out_ptrs), lane.handle)
    return results


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
    inside tuples) goes to ``device``, every result comes back as a numpy
    array; tensor arguments (build-side state from :func:`upload`) pass as
    they are.  On the card the call is ``fn``'s trip (see the module's
    docstring).  A CUDA device without a usable GPU raises here, so a query
    under ``engine: cuda`` never runs on the CPU unnoticed.

    Where the calling thread works for a traced query
    (``obs.trace.current_trace``), each call is a ``kernel:<name>`` span
    (on the card: the whole trip) with the morsel's ``rows`` and, from a
    trip, the launch's shape; untraced, the call is the plain one."""
    if device.type != "cuda":
        def on_host(*args):
            return _to_host(fn(*_to_device(args, device)))

        return _traced(on_host, fn)
    call = _TRIP_CALLS.get(fn)
    if call is None:
        raise ValueError(f"{getattr(fn, '__name__', fn)!r} has no one-trip "
                         "call on the card (registry.register_trip)")

    def on_card(*args):
        _require_gpu()
        return call(device, *args)

    return _traced(on_card, fn)


def _traced(call: Callable, fn: Callable) -> Callable:
    """``call`` itself with no traced query on this thread, else ``call``
    inside a ``kernel:<name>`` span of the thread's trace."""
    trace = current_trace()
    if trace is None:
        return call
    kernel = _NAMES.get(fn, getattr(fn, "__name__", "kernel"))
    at = _MORSEL_ARG.get(kernel, 0)

    def traced(*args):
        morsel = args[at]
        if isinstance(morsel, (tuple, list)):
            morsel = morsel[0] if morsel else ()
        lane = _LANE
        lane.shape = None
        with trace.span(f"kernel:{kernel}", "kernel",
                        rows=len(morsel)) as span:
            out = call(*args)
            if lane.shape is not None:
                span.note(**lane.shape)
        return out

    traced.__wrapped__ = call
    return traced


def _import_all() -> None:
    import importlib

    for pkg in ("filter_eval", "hash_group", "key_lookup", "hash_partition",
                "bloom", "ssd_scan", "flash_attention"):
        importlib.import_module(f".{pkg}.ops", __package__)
