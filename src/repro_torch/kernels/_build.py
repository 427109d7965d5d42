"""Build and bind the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into an object file, all
sources at once in parallel, and the objects are linked into one shared
library under ``build/repro_torch_kernels/`` at the repository root (git
ignores ``build/``).  The library's name carries a hash of the sources, so a
changed source is rebuilt at its next first use and an unchanged one is
loaded as it is.  The sources have a plain C interface and include no
PyTorch header, so a build takes seconds, not minutes.

The library is loaded with ``ctypes``; every entry point takes device
pointers, sizes and the CUDA stream, launches on that stream, and returns
``cudaGetLastError()``, which :func:`check` turns into an exception.

Nothing here runs at import: the first kernel launch calls :func:`library`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
# C entry points: name -> argtypes (every one returns cudaError_t as int)
_SIGNATURES = {
    # cols (host array of k device pointers), ops, lits, k, n, out, head
    # (rows before the four-row body; -1: every row one by one), stream
    "filter_eval_launch": [_P, _P, _P, _I32, _I64, _P, _I64, _P],
    # sorted, g, probe, n, out, stream
    "key_lookup_launch": [_P, _I64, _P, _I64, _P, _P],
    # codes, vals, n, g, sums, counts, path (0 morsel, 1 grid, 2 global),
    # scratch (the grid path's partials), its blocks, stream
    "hash_group_launch": [_P, _P, _I64, _I64, _P, _P, _I32, _P, _I64, _P],
    # out: the kernel's limits (int64[9], kernels/hash_group/ops.py: limits)
    "hash_group_limits": [_P],
    # codes, vals, n, g, mins, maxs, one_block, stream
    "hash_group_minmax_launch": [_P, _P, _I64, _I64, _P, _P, _I32, _P],
    # cols (host array of k device pointers), k, n, partitions, out, stream
    "hash_partition_launch": [_P, _I32, _I64, _I32, _P, _P],
    # h1, h2, bits, words, num_hashes, mask, n, out, stream
    "bloom_probe_launch": [_P, _P, _P, _I64, _I32, ctypes.c_uint32, _I64,
                           _P, _P],
    # x, dA, B, cum, states, batch, seq, heads, head_dim, d_state, chunk,
    # dtype, stream
    "ssd_chunk_state_launch": [_P, _P, _P, _P, _P, _I64, _I64, _I32, _I32,
                               _I32, _I32, _I32, _P],
    # cum, states, batch, seq, heads, head_dim, d_state, chunk, stream
    "ssd_state_pass_launch": [_P, _P, _I64, _I64, _I32, _I32, _I32, _I32,
                              _P],
    # B, C, cb, batch, seq, d_state, chunk, dtype, stream
    "ssd_bmm_launch": [_P, _P, _P, _I64, _I64, _I32, _I32, _I32, _P],
    # x, C, cum, states, cb, y, batch, seq, heads, head_dim, d_state, chunk,
    # dtype, stream
    "ssd_chunk_scan_launch": [_P, _P, _P, _P, _P, _P, _I64, _I64, _I32, _I32,
                              _I32, _I32, _I32, _P],
    # q, k, v, out, batch*heads, seq, head_dim, scale, causal, dtype, stream
    "flash_attention_launch": [_P, _P, _P, _P, _I64, _I64, _I32,
                               ctypes.c_float, _I32, _I32, _P],
    # q, k, v, out, batch*heads, seq, head_dim, scale, causal, stream
    # (bfloat16, head_dim a multiple of 16 up to 128)
    "flash_attention_wgmma_launch": [_P, _P, _P, _P, _I64, _I64, _I32,
                                     ctypes.c_float, _I32, _P],
    # q, k, v, out, batch*heads, seq, head_dim, scale, causal, stream
    # (float32, head_dim a multiple of 8 up to 128)
    "flash_attention_tf32_launch": [_P, _P, _P, _P, _I64, _I64, _I32,
                                    ctypes.c_float, _I32, _P],
    # stream (an empty kernel: the floor of one executor call)
    "repro_empty_launch": [_P],
    # a captured cudaGraph_t, out: its kernel nodes (int64)
    "repro_graph_kernel_nodes": [_P, _P],
}
# plan, host_in, dev_in, in_bytes, dev_out, host_out, out_bytes: the
# leading arguments of each *_trip entry point, which copies a morsel in,
# launches as its *_launch twin does with the arguments that follow, copies
# the results back and synchronises the stream (csrc/common.cuh: trip)
_TRIP = [_P, _P, _P, _I64, _P, _P, _I64]
TRIPS = ("filter_eval", "key_lookup", "hash_group", "hash_group_minmax",
         "hash_partition", "bloom_probe", "repro_empty")
_SIGNATURES.update({f"{k}_trip": _TRIP + _SIGNATURES[f"{k}_launch"]
                    for k in TRIPS})

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_BUILD_LOG: List[str] = []


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       f"{cuda_home}/bin); the CUDA kernels cannot be built")


def build(verbose: bool = False) -> Path:
    """Compile every source (in parallel) and link the shared library;
    returns its path.  ``verbose`` adds ``-Xptxas -v`` and keeps the
    compiler's report in :func:`build_log`."""
    out = BUILD_DIR / f"librepro_torch_kernels-{_digest()}.so"
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    procs = []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}-{os.getpid()}.o"
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *flags, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, obj, proc in procs:
        log, _ = proc.communicate()
        _BUILD_LOG.append(f"== {src.name}\n{log}")
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
    if failed:
        raise RuntimeError("nvcc failed on " + "\n".join(failed))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def build_log() -> str:
    return "\n".join(_BUILD_LOG)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _LIB
    if _LIB is not None:  # every kernel call asks: no lock once loaded
        return _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def check(err: int, kernel: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        text = library().repro_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err} at launch: {text}")


def takes_kernel(*tensors) -> bool:
    """The wrappers' device rule: False for tensors on the CPU (the caller
    takes the plain torch version), True for tensors on one CUDA device;
    anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs span devices {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return True


def stream(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
