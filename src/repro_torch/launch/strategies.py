"""DTensor sharding strategies for the ops the models run that DTensor
has none for (``register_sharding``).

``register()`` installs them once per process; ``launch.mesh.shard_ctx``
calls it, so every sharded run of the models has them.  Each strategy
lists the placements under which the op computes locally what it computes
on the whole tensor; DTensor redistributes the operands to the cheapest
of them, and that redistribution is counted like any other collective.
"""
from __future__ import annotations

import functools


@functools.lru_cache(maxsize=None)
def register() -> None:
    import torch
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    aten = torch.ops.aten

    @register_sharding(aten.detach_.default)
    def detach_(x):
        # in place and metadata only: any placement stays as it is (torch
        # 2.11 has no strategy; its redistributions call it under
        # inference mode)
        return [([p], [p]) for p in
                (Replicate(), Partial(), *(Shard(d) for d in range(x.ndim)))]

    def along(x, dim, tail):
        """Placements of an op that writes rows of ``x`` along ``dim`` at
        a replicated index: x (and the output) whole along ``dim``, split
        alike along any other dim; ``tail`` the placements of the operands
        after (dim, index)."""
        dim = dim % x.ndim
        out = [([Replicate()], [Replicate(), None, Replicate()]
                + [Replicate() if t else None for t in tail])]
        out += [([Shard(d)], [Shard(d), None, Replicate()]
                 + [Shard(d) if t else None for t in tail])
                for d in range(x.ndim) if d != dim]
        return out

    # torch 2.11 has no strategy for these; the MoE dispatch runs the
    # first, its gradient the second
    @register_sharding(aten.index_copy_.default)
    def index_copy_(x, dim, index, source):
        return along(x, dim, (True,))

    @register_sharding(aten.index_fill.int_Scalar)
    def index_fill(x, dim, index, value):
        return along(x, dim, (False,))
