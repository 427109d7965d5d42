"""Public wrappers for the grouped-aggregation kernels (registry-dispatched).

The CUDA kernels are in ``csrc/hash_group.cu``; they replace the TPU kernels
``hash_group_pallas`` and ``hash_group_minmax_pallas`` of the JAX package.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build
from ..registry import count_launch, register, register_trip, resolve, trip
from .ref import hash_group_minmax_ref, hash_group_ref

# hash_group (SUM/COUNT): three paths, each one launch (csrc/hash_group.cu).
# Up to morsel_rows(G) rows and WARP_COPY_GROUPS groups one block takes the
# whole call; above it a cooperative grid.  Set from chip_smoke.py's timing
# of both paths from 1,024 to 65,536 rows (PERF.md): with the sums in
# registers (G <= 32) the grid path wins from about 16,384 rows, with copies
# in shared memory from about 4,096.
MORSEL_ROWS = 8192
MORSEL_COPY_ROWS = 2048
# The kernel's limits, repeated here for the CPU (where no library is
# built); limits() names them and kernel_limits() reads the compiled ones.
GROUP_PATHS = ("morsel", "grid", "global")  # the kernel's path codes, in order
MORSEL_THREADS = 512  # the morsel path's block; also a grid path block's
WARPS = MORSEL_THREADS // 32
REGISTER_GROUPS = 32  # up to this many groups the sums stay in registers
# a block's shared memory on the H100 with the opt-in (227 KB), less the
# morsel path's staged values (32 floats a warp); a group takes 8 bytes (a
# sum and a count) in each copy: one per warp on the morsel path up to
# WARP_COPY_GROUPS (1,800), one per block on the grid path up to
# SMEM_GROUPS (28,800)
SMEM_OPT_IN = 232448
_FREE_SMEM = SMEM_OPT_IN - WARPS * 32 * 4
WARP_COPY_GROUPS = _FREE_SMEM // (WARPS * 8)
SMEM_GROUPS = _FREE_SMEM // 8
GRID_BLOCKS_PER_SM = 2  # the grid path's blocks are at most this many a SM

# hash_group_minmax: up to this many rows one block takes the whole call in
# one launch; above it, the three-launch multi-block path
# (csrc/hash_group.cu).  Set from chip_smoke.py's timing of both paths
# around it (PERF.md).
ONE_BLOCK_ROWS = 16384
# groups whose order keys fit the 48 KB of shared memory (2 x 4 bytes each)
SMEM_MAX_GROUPS = 6144


def limits() -> dict:
    """This module's copy of the kernel's limits, by name, in the order
    csrc/hash_group.cu: hash_group_limits writes them."""
    return {**{path: code for code, path in enumerate(GROUP_PATHS)},
            "MORSEL_THREADS": MORSEL_THREADS,
            "REGISTER_GROUPS": REGISTER_GROUPS,
            "WARP_COPY_GROUPS": WARP_COPY_GROUPS, "SMEM_GROUPS": SMEM_GROUPS,
            "SMEM_OPT_IN": SMEM_OPT_IN,
            "GRID_BLOCKS_PER_SM": GRID_BLOCKS_PER_SM}


def kernel_limits() -> dict:
    """The same limits as the built kernel has them (needs the library):
    the card tests and chip_smoke.py hold :func:`limits` to these."""
    names = list(limits())
    out = (ctypes.c_int64 * len(names))()
    _build.check(_build.library().hash_group_limits(out), "hash_group_limits")
    return dict(zip(names, out))


def morsel_rows(num_groups: int) -> int:
    """The most rows the morsel path takes in ``num_groups`` groups."""
    return MORSEL_ROWS if num_groups <= REGISTER_GROUPS else MORSEL_COPY_ROWS


def group_path(n: int, num_groups: int) -> str:
    """``morsel``, ``grid`` or ``global``: hash_group's kernel path for n
    rows in ``num_groups`` groups."""
    if num_groups > SMEM_GROUPS:
        return "global"
    if num_groups <= WARP_COPY_GROUPS and n <= morsel_rows(num_groups):
        return "morsel"
    return "grid"


def _count_group(path: str, num_groups: int) -> None:
    """One launch of hash_group on ``path``, also counted by its G to the
    next power of two (``hash_group.grid.G<=256``): which group counts the
    SQL path sends each path (PERF.md)."""
    count_launch("hash_group")
    count_launch(f"hash_group.{path}")
    bucket = 1 << (num_groups - 1).bit_length()
    count_launch(f"hash_group.{path}.G<={bucket}")


@functools.cache
def grid_blocks(device: torch.device) -> int:
    """The most blocks the grid path launches on ``device``: the rows of
    its scratch of partials."""
    return GRID_BLOCKS_PER_SM * torch.cuda.get_device_properties(
        device).multi_processor_count


def minmax_path(n: int, num_groups: int) -> str:
    """``one_block`` or ``multi_block``: the kernel path for n rows in
    ``num_groups`` groups."""
    if n <= ONE_BLOCK_ROWS and num_groups <= SMEM_MAX_GROUPS:
        return "one_block"
    return "multi_block"


def _prepare(codes, values, num_groups: int):
    if codes.dim() != 1 or codes.shape != values.shape:
        raise ValueError("codes and values must be 1-D of one length")
    if num_groups < 0:
        raise ValueError(f"num_groups must be >= 0, got {num_groups}")
    return (codes.to(torch.int32).contiguous(),
            values.to(torch.float32).contiguous())


@register("hash_group", "cuda")
def hash_group_cuda(codes, values, num_groups: int):
    """codes: (N,) group codes (-1 = masked); values: (N,) numeric.

    Returns (sums (G,), counts (G,)) float32.  CPU tensors and empty
    inputs take the plain version; CUDA tensors launch the kernel."""
    codes, values = _prepare(codes, values, num_groups)
    n = codes.shape[0]
    if not _build.takes_kernel(codes, values) or n == 0 or num_groups == 0:
        return hash_group_ref(codes, values, num_groups)
    path = group_path(n, num_groups)
    out = launch_group(codes, values, num_groups, path)
    _count_group(path, num_groups)
    return out[0], out[1]


def launch_group(codes, values, num_groups: int, path: str):
    """Launch one path of the SUM/COUNT kernel on prepared CUDA tensors;
    returns (2, G) float32.  Counts nothing: the wrapper counts."""
    out = torch.empty(2, num_groups, dtype=torch.float32, device=codes.device)
    blocks, scratch = 0, None
    if path == "grid":
        # the grid path's partials: a sum and a count of every group for
        # each block
        blocks = grid_blocks(codes.device)
        scratch = torch.empty(2 * blocks * num_groups, dtype=torch.float32,
                              device=codes.device)
    err = _build.library().hash_group_launch(
        codes.data_ptr(), values.data_ptr(), codes.shape[0], num_groups,
        out[0].data_ptr(), out[1].data_ptr(), GROUP_PATHS.index(path),
        None if scratch is None else scratch.data_ptr(), blocks,
        _build.stream(out))
    _build.check(err, f"hash_group ({path})")
    return out


@register("hash_group_minmax", "cuda")
def hash_group_minmax_cuda(codes, values, num_groups: int):
    """Grouped MIN/MAX: (mins (G,), maxs (G,)) float32; an empty group
    holds +inf / -inf.  CPU tensors and empty inputs take the plain
    version; CUDA tensors launch the kernel."""
    codes, values = _prepare(codes, values, num_groups)
    n = codes.shape[0]
    if not _build.takes_kernel(codes, values) or n == 0 or num_groups == 0:
        return hash_group_minmax_ref(codes, values, num_groups)
    path = minmax_path(n, num_groups)
    out = launch_minmax(codes, values, num_groups, path)
    count_launch("hash_group_minmax")
    count_launch(f"hash_group_minmax.{path}")
    return out[0], out[1]


def launch_minmax(codes, values, num_groups: int, path: str):
    """Launch one path of the MIN/MAX kernel on prepared CUDA tensors;
    returns (2, G) float32.  Counts nothing: the wrapper counts."""
    out = torch.empty(2, num_groups, dtype=torch.float32, device=codes.device)
    err = _build.library().hash_group_minmax_launch(
        codes.data_ptr(), values.data_ptr(), codes.shape[0], num_groups,
        out[0].data_ptr(), out[1].data_ptr(), int(path == "one_block"),
        _build.stream(out))
    _build.check(err, f"hash_group_minmax ({path})")
    return out


def _host_inputs(codes, values, num_groups: int):
    if codes.ndim != 1 or codes.shape != values.shape:
        raise ValueError("codes and values must be 1-D of one length")
    if num_groups < 0:
        raise ValueError(f"num_groups must be >= 0, got {num_groups}")
    return (codes.astype(np.int32, copy=False),
            values.astype(np.float32, copy=False))


def _plain(ref, codes, values, num_groups: int):
    return tuple(t.numpy() for t in ref(torch.from_numpy(codes),
                                        torch.from_numpy(values), num_groups))


def hash_group_trip(device, codes, values, num_groups: int):
    """The executor's call on the card in one trip (registry.trip): numpy
    codes and values in, hash_group_cuda's (sums, counts) as numpy out."""
    codes, values = _host_inputs(codes, values, num_groups)
    n = codes.shape[0]
    if n == 0 or num_groups == 0:
        return _plain(hash_group_ref, codes, values, num_groups)
    path = group_path(n, num_groups)
    blocks = grid_blocks(device) if path == "grid" else 0
    sums, counts = trip("hash_group", device, [codes, values],
                        [(np.float32, (num_groups,))] * 2,
                        lambda i, o: (i[0], i[1], n, num_groups, o[0], o[1],
                                      GROUP_PATHS.index(path),
                                      o[2] if blocks else None, blocks),
                        scratch_bytes=8 * blocks * num_groups,
                        shape={"n": n, "g": num_groups})
    _count_group(path, num_groups)
    return sums, counts


def hash_group_minmax_trip(device, codes, values, num_groups: int):
    """The executor's call on the card in one trip (registry.trip): numpy
    codes and values in, hash_group_minmax_cuda's (mins, maxs) out."""
    codes, values = _host_inputs(codes, values, num_groups)
    n = codes.shape[0]
    if n == 0 or num_groups == 0:
        return _plain(hash_group_minmax_ref, codes, values, num_groups)
    path = minmax_path(n, num_groups)
    mins, maxs = trip("hash_group_minmax", device, [codes, values],
                      [(np.float32, (num_groups,))] * 2,
                      lambda i, o: (i[0], i[1], n, num_groups, o[0], o[1],
                                    int(path == "one_block")),
                      shape={"n": n, "g": num_groups})
    count_launch("hash_group_minmax")
    count_launch(f"hash_group_minmax.{path}")
    return mins, maxs


register_trip(hash_group_cuda, hash_group_trip)
register_trip(hash_group_minmax_cuda, hash_group_minmax_trip)
register("hash_group", "ref", hash_group_ref)
register("hash_group_minmax", "ref", hash_group_minmax_ref)


def hash_group(codes, values, num_groups: int, engine: str = "cuda"):
    return resolve("hash_group", engine)(codes, values, num_groups)


def hash_group_minmax(codes, values, num_groups: int, engine: str = "cuda"):
    return resolve("hash_group_minmax", engine)(codes, values, num_groups)
