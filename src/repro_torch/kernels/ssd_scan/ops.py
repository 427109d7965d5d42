"""Public wrapper for the SSD chunk-scan kernel (registry-dispatched).

The CUDA kernel is ``csrc/ssd_scan.cu``: four chunk-parallel passes (chunk
states, state passing, C B^T once per chunk, chunk scan) on the tensor
cores; it replaces the TPU kernel ``ssd_scan_pallas`` of the JAX package.
"""
from __future__ import annotations

import torch

from .. import _build
from ..registry import count_launch, refuse_autograd, register, resolve
from .ref import ssd_scan_ref

MAX_HEAD_DIM = 64   # P: y's tile is 64 columns wide
MAX_STATE = 128     # N: a chunk state's tile is 128 columns wide
MAX_CHUNK = 1024    # Q: a chunk's cumulative decays sit in shared memory
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's passes in launch order, each with its own C entry point and
# launch count
PASSES = ("chunk_state", "state_pass", "bmm", "chunk_scan")


def _check(x, dA, Bm, Cm, chunk):
    """(b, s, h, p, n, q) of a call; raises on shapes no scan takes."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    if dA.shape != (b, s, h) or Bm.shape != (b, s, n) or Cm.shape != (b, s, n):
        raise ValueError("ssd_scan shapes: x (B,S,H,P), dA (B,S,H), "
                         f"Bm/Cm (B,S,N); got {tuple(x.shape)}, "
                         f"{tuple(dA.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    q = min(chunk, s)
    if s and (q < 1 or s % q):
        raise ValueError(f"seq {s} % chunk {q} != 0")
    return b, s, h, p, n, q


def _check_kernel(x, dA, Bm, Cm, p, n, q):
    """Raises on what the kernel does not take."""
    if p > MAX_HEAD_DIM or n > MAX_STATE or q > MAX_CHUNK:
        raise ValueError(f"ssd_scan kernel takes P <= {MAX_HEAD_DIM}, "
                         f"N <= {MAX_STATE} and chunk <= {MAX_CHUNK}; got "
                         f"P={p}, N={n}, chunk={q}")
    if x.dtype not in DTYPES or any(t.dtype != x.dtype for t in (dA, Bm, Cm)):
        raise ValueError("ssd_scan kernel takes inputs of one dtype, float32 "
                         f"or bfloat16; got {x.dtype}, {dA.dtype}, "
                         f"{Bm.dtype}, {Cm.dtype}")


def scratch_shapes(b, s, h, p, n, q) -> dict:
    """The float32 buffers of one call: cum (B, H, S), states (B, nc, H, P,
    N; each chunk's own state, then the state entering it), cb (B, nc, Q, Q;
    the causal tiles of C B^T) and y."""
    nc = s // q
    return {"cum": (b, h, s), "states": (b, nc, h, p, n),
            "cb": (b, nc, q, q), "y": (b, s, h, p)}


def scratch_bytes(b, s, h, p, n, q) -> int:
    """Bytes of scratch a call allocates beside y."""
    return sum(4 * torch.Size(shape).numel() for k, shape in
               scratch_shapes(b, s, h, p, n, q).items() if k != "y")


def buffers(x, Bm, chunk: int) -> dict:
    """Every buffer of a call on x's device, made with torch.empty."""
    b, s, h, p = x.shape
    shapes = scratch_shapes(b, s, h, p, Bm.shape[-1], min(chunk, s))
    return {k: torch.empty(v, dtype=torch.float32, device=x.device)
            for k, v in shapes.items()}


def _launch(name, x, dA, Bm, Cm, bufs: dict, dims: tuple) -> None:
    """One pass through its own C entry point, on checked tensors."""
    b, s, h, p, n, q = dims
    lib, code, stream = _build.library(), DTYPES[x.dtype], _build.stream(x)
    ptr = {k: v.data_ptr() for k, v in bufs.items()}
    if name == "chunk_state":
        err = lib.ssd_chunk_state_launch(
            x.data_ptr(), dA.data_ptr(), Bm.data_ptr(), ptr["cum"],
            ptr["states"], b, s, h, p, n, q, code, stream)
    elif name == "state_pass":
        err = lib.ssd_state_pass_launch(ptr["cum"], ptr["states"], b, s, h,
                                        p, n, q, stream)
    elif name == "bmm":
        err = lib.ssd_bmm_launch(Bm.data_ptr(), Cm.data_ptr(), ptr["cb"], b,
                                 s, n, q, code, stream)
    else:
        err = lib.ssd_chunk_scan_launch(
            x.data_ptr(), Cm.data_ptr(), ptr["cum"], ptr["states"],
            ptr["cb"], ptr["y"], b, s, h, p, n, q, code, stream)
    _build.check(err, f"ssd_scan.{name}")


def launch_pass(name, x, dA, Bm, Cm, bufs: dict, chunk: int = 256) -> None:
    """Launch one pass of the kernel as the wrapper does, on ``bufs`` (see
    :func:`buffers`); not counted.  Tests and chip_smoke check and time the
    passes one by one."""
    if name not in PASSES:
        raise ValueError(f"no ssd_scan pass {name!r}; passes: {PASSES}")
    dims = _check(x, dA, Bm, Cm, chunk)
    tensors = (x, dA, Bm, Cm, *bufs.values())
    if not _build.takes_kernel(*tensors):
        raise ValueError("launch_pass needs CUDA tensors")
    _check_kernel(x, dA, Bm, Cm, *dims[3:])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("launch_pass takes contiguous tensors")
    _launch(name, x, dA, Bm, Cm, bufs, dims)


@register("ssd_scan", "cuda")
def ssd_scan_cuda(x, dA, Bm, Cm, chunk: int = 256):
    """x: (B, S, H, P) dt-scaled input; dA: (B, S, H) log decays; Bm/Cm:
    (B, S, N), shared by the heads.  Returns (y, None): y (B, S, H, P)
    float32 with zero initial state, as ``ssd_reference`` gives it.

    CPU tensors take the plain version; CUDA tensors launch the kernel's
    four passes (and raise where autograd records: the kernel has no
    backward; training takes ``ssd_reference``), which read the inputs in their one dtype (float32 or
    bfloat16) and compute in float32.  A call counts once as
    ``ssd_scan`` and each launch once as ``ssd_scan.<pass>``."""
    dims = _check(x, dA, Bm, Cm, chunk)
    b, s, h, p, n, q = dims
    if x.numel() == 0 or n == 0:
        return torch.zeros(x.shape, dtype=torch.float32, device=x.device), None
    if not _build.takes_kernel(x, dA, Bm, Cm):
        return ssd_scan_ref(x, dA, Bm, Cm, chunk), None
    refuse_autograd("ssd_scan", "models.mamba2.ssd_reference, "
                    "use_kernel=False", x, dA, Bm, Cm)
    _check_kernel(x, dA, Bm, Cm, p, n, q)
    x, dA, Bm, Cm = (t.contiguous() for t in (x, dA, Bm, Cm))
    bufs = buffers(x, Bm, q)
    for name in PASSES:
        _launch(name, x, dA, Bm, Cm, bufs, dims)
        count_launch(f"ssd_scan.{name}")
    count_launch("ssd_scan")
    return bufs["y"], None


@register("ssd_scan", "ref")
def _ssd_scan_ref(x, dA, Bm, Cm, chunk: int = 256):
    return ssd_scan_ref(x, dA, Bm, Cm, chunk), None


def ssd_scan(x, dA, Bm, Cm, chunk: int = 256, engine: str = "cuda"):
    """Mamba2 SSD scan; returns (y, None) mirroring ssd_reference's API."""
    return resolve("ssd_scan", engine)(x, dA, Bm, Cm, chunk)
