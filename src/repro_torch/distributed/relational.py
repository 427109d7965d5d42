"""Distributed relational operators as ``torch.distributed`` collectives.

Hive's Tez edges, as the JAX package maps them onto collectives:

  SHUFFLE (hash repartition)  -> all_to_all_single
  BROADCAST (map join)        -> all_gather_into_tensor
  partial aggregation         -> a local scatter-add, then all_to_all by
                                 key range

Each ``make_*`` returns a callable that every rank of the mesh calls
SPMD-style with its own shard: the rows of its coordinate on ``axis``
(ranks that differ only on other axes hold the same shard).  It returns
what the JAX package's ``shard_map`` gives that shard.  The collectives run
on ``mesh.get_group(axis)``: NCCL on a ``cuda`` mesh, gloo on a ``cpu``
one; the tensors must lie on the mesh's device.  Keys are integer codes
(-1 marks padding) and payloads are float columns; keys keep their dtype.

Two of the JAX package's behaviours are kept on purpose (ROADMAP C11,
C12):
- a negative group code is a negative index in its scatter-add, so a code
  of -1 adds its value to the last group slot ``g_pad - 1`` (and not its
  count); codes outside [-g_pad, g_pad) are dropped;
- its repartition writes every padding row to bucket 0, position 0, and
  relies on the last write winning; here padding rows are masked out of
  the scatter instead, which leaves the same buffer and writes no index
  twice.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.distributed as dist


def _group(mesh, axis: str):
    return mesh.get_group(axis), mesh.size(mesh.mesh_dim_names.index(axis))


def _on_mesh(mesh, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != mesh.device_type:
            raise ValueError(f"a {t.device.type} tensor on a "
                             f"{mesh.device_type} mesh")


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """(n_shards, ...) blocks: block j goes to rank j of ``group``; block
    i of the result came from rank i (``all_to_all(x, 0, 0,
    tiled=False)``)."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def _all_gather(x: torch.Tensor, group, n_shards: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated in rank order (``all_gather(...,
    tiled=True)``)."""
    out = torch.empty((n_shards * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def _argsort(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, stable=True).indices


# ---------------------------------------------------------------------------
# distributed hash aggregation: local partial agg -> all_to_all by key range
# ---------------------------------------------------------------------------
def make_distributed_group_sum(mesh, num_groups: int, axis: str = "data"
                               ) -> Callable:
    """Grouped SUM/COUNT over sharded (codes, values).

    Phase 1 (map side): each shard aggregates its rows into a dense (G,)
    partial — Hive's map-side partial aggregation.
    Phase 2 (shuffle): G is range-partitioned across shards; partials move
    with one all_to_all; each shard sums its range — the reduce side.
    Output: replicated float32 (G,) sums and counts (an all_gather at the
    end).
    """
    group, n_shards = _group(mesh, axis)
    g_pad = ((num_groups + n_shards - 1) // n_shards) * n_shards

    def run(codes: torch.Tensor, values: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        _on_mesh(mesh, codes, values)
        # map-side partial aggregation (dense accumulate); a negative code
        # indexes from the end, as in the JAX package (C11)
        idx = torch.where(codes < 0, codes + g_pad, codes).long()
        keep = (idx >= 0) & (idx < g_pad)
        idx = idx[keep]
        f32 = torch.float32
        sums = torch.zeros(g_pad, dtype=f32, device=codes.device).index_add_(
            0, idx, values[keep].to(f32))
        counts = torch.zeros(g_pad, dtype=f32, device=codes.device)
        counts.index_add_(0, idx, (codes[keep] >= 0).to(f32))
        # shuffle: range-partition the group domain
        sums = _all_to_all(sums.reshape(n_shards, g_pad // n_shards), group)
        counts = _all_to_all(counts.reshape(n_shards, g_pad // n_shards),
                             group)
        # reduce side: sum partials for my key range; final: replicate
        all_sums = _all_gather(sums.sum(0), group, n_shards)
        all_counts = _all_gather(counts.sum(0), group, n_shards)
        return all_sums[:num_groups], all_counts[:num_groups]

    return run


# ---------------------------------------------------------------------------
# distributed hash join: all_to_all hash repartition, then local join
# ---------------------------------------------------------------------------
def make_shuffle_join(mesh, rows_per_shard_out: int, axis: str = "data"
                      ) -> Callable:
    """Inner equi-join of two sharded key/value relations.

    Both sides hash-repartition on the join key with all_to_all so matching
    keys land on the same shard (Tez SHUFFLE edge), then each shard runs the
    vectorized local hash join.  Fixed output capacity per shard; overflow
    is reported so the planner can re-run with more capacity (mirrors
    Hive's reoptimization on memory errors, §4.2).

    Inputs: (l_keys, l_vals) and (r_keys, r_vals), each this rank's shard;
    key >= 0; -1 marks padding.
    Returns this shard's (out_keys, out_lv, out_rv) of
    ``rows_per_shard_out`` rows and the total overflow of all shards.
    """
    group, n_shards = _group(mesh, axis)

    def repartition(keys, vals):
        n = keys.shape[0]
        dest = torch.where(keys >= 0, torch.remainder(keys, n_shards),
                           -1).to(torch.int32)
        order = _argsort(dest)
        keys_s, vals_s, dest_s = keys[order], vals[order], dest[order]
        # position within destination bucket (cap = n, so every real row
        # fits)
        pos = torch.arange(n, device=keys.device) - torch.searchsorted(
            dest_s, dest_s, side="left")
        buf_k = torch.full((n_shards, n), -1, dtype=keys.dtype,
                           device=keys.device)
        buf_v = torch.zeros((n_shards, n), dtype=vals.dtype,
                            device=vals.device)
        ok = dest_s >= 0  # padding rows write nothing (C12)
        buf_k[dest_s[ok].long(), pos[ok]] = keys_s[ok]
        buf_v[dest_s[ok].long(), pos[ok]] = vals_s[ok]
        return (_all_to_all(buf_k, group).reshape(-1),
                _all_to_all(buf_v, group).reshape(-1))

    def local_join(lk, lv, rk, rv):
        order = _argsort(rk)
        rk_s, rv_s = rk[order], rv[order]
        lo = torch.searchsorted(rk_s, lk, side="left")
        hi = torch.searchsorted(rk_s, lk, side="right")
        counts = torch.where(lk >= 0, hi - lo, 0)
        total = counts.sum()
        cap = rows_per_shard_out
        ends = torch.cumsum(counts, 0)
        starts = ends - counts
        # expand matches into fixed-capacity output
        idx = torch.arange(cap, device=lk.device)
        src_row = torch.searchsorted(ends, idx, side="right").clamp_max(
            lk.shape[0] - 1)
        within = idx - starts[src_row]
        valid = (idx < total) & (within < counts[src_row])
        r_at = (lo[src_row] + within).clamp_max(rk.shape[0] - 1)
        out_k = torch.where(valid, lk[src_row], -1)
        out_l = torch.where(valid, lv[src_row], 0)
        out_r = torch.where(valid, rv_s[r_at], 0)
        overflow = (total - cap).clamp_min(0).to(torch.int32)
        return out_k, out_l, out_r, overflow

    def run(lk, lv, rk, rv):
        _on_mesh(mesh, lk, lv, rk, rv)
        lk2, lv2 = repartition(lk, lv)
        rk2, rv2 = repartition(rk, rv)
        out_k, out_l, out_r, ovf = local_join(lk2, lv2, rk2, rv2)
        dist.all_reduce(ovf, op=dist.ReduceOp.SUM, group=group)
        return out_k, out_l, out_r, ovf

    return run


# ---------------------------------------------------------------------------
# broadcast (map) join: all_gather the small side
# ---------------------------------------------------------------------------
def make_broadcast_join(mesh, axis: str = "data") -> Callable:
    """Inner equi-join where the (small) right side is replicated via
    all_gather — Hive's map join / Tez BROADCAST edge.  Returns this
    shard's (keys, left values, right values), -1 / 0 where a row found no
    match."""
    group, n_shards = _group(mesh, axis)

    def run(lk, lv, rk, rv):
        _on_mesh(mesh, lk, lv, rk, rv)
        rk_all = _all_gather(rk, group, n_shards)
        rv_all = _all_gather(rv, group, n_shards)
        order = _argsort(rk_all)
        rk_s, rv_s = rk_all[order], rv_all[order]
        lo = torch.searchsorted(rk_s, lk, side="left")
        at = lo.clamp_max(rk_s.shape[0] - 1)
        found = (lo < rk_s.shape[0]) & (rk_s[at] == lk) & (lk >= 0)
        return (torch.where(found, lk, -1), torch.where(found, lv, 0),
                torch.where(found, rv_s[at], 0))

    return run
