"""The dry run's cost analysis: per-device FLOPs, bytes and collectives,
counted from a trace of aten ops, and the three-term roofline of an H100.

The JAX package parses the optimized per-device HLO text of a compiled
step.  The port has no XLA and no HLO: the dry run runs the step eagerly on
the meta device, its parameters and inputs ``DTensor``s on a mesh of the
fake process group, and :class:`CostMode`, a ``TorchDispatchMode`` beneath
DTensor, sees what one rank runs: its local aten ops and the functional
collectives DTensor issues between them.  It counts per device:

* FLOPs: 2·M·N·K for ``mm``, ``addmm``, ``bmm``, ``baddbmm`` and the
  ``_scaled_dot_product_*`` attention ops (forward and backward); for a
  convolution 2 · output elements · kernel elements ÷ output channels, so a
  depthwise conv costs 2 · output elements · K (the true count, which the
  JAX package's counter misses for grouped convs: ROADMAP C14);
* bytes: operand bytes plus output bytes of each op that moves data; views,
  ``detach`` and ops that only allocate or read metadata count zero.  This
  is eager traffic with no fusion: every intermediate goes to memory and
  back, so it bounds from above what a fused program moves;
* collectives: each ``_c10d_functional`` collective, its output bytes by
  type (the JAX package's names) and by link, and their count;
* live bytes: each op's new output storage is added when it is made and
  taken off when it is freed (keyed by storage, so views count once); the
  peak is the step's temporary memory above its arguments.

Eager Python unrolls every loop (periods, microbatches, attention chunks),
so no trip count has to be recovered; ``trip_counts`` records the periods
and microbatches the caller traced.

The roofline constants are the datasheet values of an NVIDIA H100 SXM5 80
GB at its 700 W limit.  Ranks are laid out row-major over the mesh, eight
to a node: a collective whose group stays inside one node runs over
NVLink, one whose group spans nodes over InfiniBand.
"""
from __future__ import annotations

import os
import sys
import weakref
from dataclasses import dataclass, field
from typing import Dict, Mapping, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 Tensor Core GPU datasheet, SXM5 column: dense BF16 tensor-core
# rate (1,979 TFLOP/s is with 2:4 sparsity), HBM3 bandwidth and capacity
PEAK_FLOPS = 989.4e12
HBM_BW = 3.35e12
HBM_BYTES = 80e9
# the same datasheet: NVLink 4 gives 900 GB/s a GPU, 450 GB/s each way
NVLINK_BW = 450e9
# one ConnectX-7 400 Gb/s NDR InfiniBand port a GPU (DGX H100): 50 GB/s
IB_BW = 50e9
GPUS_PER_NODE = 8
LINK_BW = {"nvlink": NVLINK_BW, "infiniband": IB_BW}

_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}

_FLOP_OPS = ("mm", "addmm", "bmm", "baddbmm",
             "_scaled_dot_product_efficient_attention",
             "_scaled_dot_product_flash_attention",
             "_scaled_dot_product_cudnn_attention",
             "_scaled_dot_product_efficient_attention_backward",
             "_scaled_dot_product_flash_attention_backward",
             "_scaled_dot_product_cudnn_attention_backward")

# ops that allocate or touch metadata only (views are found by their schema)
_NO_TRAFFIC = ("empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "alias", "lift_fresh",
               "wait_tensor", "_wrap_tensor_autograd")


@dataclass
class HloCost:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    collective_by_type: Dict[str, float] = field(default_factory=dict)
    collective_count: int = 0
    trip_counts: Dict[str, float] = field(default_factory=dict)
    collective_by_link: Dict[str, float] = field(default_factory=dict)
    flops_by_op: Dict[str, float] = field(default_factory=dict)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _conv_flops(x, w, out, transposed: bool) -> float:
    """2 · multiply-adds of a convolution: each output element (each
    input element of a transposed one) takes kernel elements ÷ the
    weight's leading dim of them, (C_in ÷ groups) · K, which is K for a
    depthwise conv."""
    return 2.0 * (x if transposed else out).numel() * w.numel() / w.shape[0]


def _convolution(x, w, bias, stride, padding, dilation, transposed, *args,
                 out_val=None, **kwargs) -> float:
    return _conv_flops(x, w, out_val, transposed)


def _convolution_backward(grad_out, x, w, bias_sizes, stride, padding,
                          dilation, transposed, output_padding, groups,
                          output_mask, out_val=None, **kwargs) -> float:
    # the input's and the weight's gradients each cost the forward's
    # multiply-adds (torch.utils.flop_counter charges a grouped conv's
    # weight gradient as a dense one)
    return _conv_flops(x, w, grad_out, transposed) * (
        bool(output_mask[0]) + bool(output_mask[1]))


def _flop_table() -> dict:
    from torch.utils.flop_counter import flop_registry

    aten = torch.ops.aten
    table = {getattr(aten, n): flop_registry[getattr(aten, n)]
             for n in _FLOP_OPS
             if hasattr(aten, n) and getattr(aten, n) in flop_registry}
    table[aten.convolution] = _convolution
    table[aten.convolution_backward] = _convolution_backward
    return table


def group_link(group_name: str) -> str:
    """``"nvlink"`` if the ranks of the process group ``group_name`` share
    one node (``GPUS_PER_NODE`` consecutive ranks), else
    ``"infiniband"``."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    ranks = dist.get_process_group_ranks(_resolve_process_group(group_name))
    return ("nvlink" if len({r // GPUS_PER_NODE for r in ranks}) == 1
            else "infiniband")


_PROPAGATION = os.path.join("torch", "distributed", "tensor",
                            "_sharding_prop.py")


def _in_sharding_propagation(depth: int = 48) -> bool:
    """Whether DTensor's sharding propagation is on the stack (within
    ``depth`` frames of the op): to choose a placement it runs ops on fake
    or meta tensors of the global shapes (through modes of its own above
    this one), which no rank runs."""
    frame = sys._getframe(2)
    while frame is not None and depth:
        if frame.f_code.co_filename.endswith(_PROPAGATION):
            return True
        frame, depth = frame.f_back, depth - 1
    return False


class CostMode(TorchDispatchMode):
    """Counts what one rank runs (see the module's docstring); read the
    totals with :meth:`cost` and ``peak_bytes``.  DTensor ops are passed
    on (``NotImplemented``) so that DTensor runs them as local ops and
    collectives, which come back here; the fake tensors DTensor makes to
    propagate shapes are not counted."""

    def __init__(self):
        super().__init__()
        from torch.distributed.tensor import DTensor

        self._dtensor = DTensor
        self._flops = _flop_table()
        self._links: Dict[str, str] = {}
        self.hc = HloCost()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, weakref.ref] = {}  # storages in live_bytes

    def cost(self, trip_counts: Mapping[str, float] = ()) -> HloCost:
        self.hc.trip_counts = dict(trip_counts)
        return self.hc

    def _free(self, key: int, nbytes: int) -> None:
        del self._live[key]
        self.live_bytes -= nbytes

    def _track(self, outs, ins) -> None:
        held = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in held or key in self._live:
                continue
            nbytes = st.nbytes()
            self._live[key] = weakref.ref(
                st, lambda _, key=key, nbytes=nbytes: self._free(key, nbytes))
            self.live_bytes += nbytes
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _collective(self, name: str, args, outs) -> None:
        kind = _COLLECTIVES[name]
        group = args[-1]
        if group not in self._links:
            self._links[group] = group_link(group)
        link = self._links[group]
        nbytes = float(sum(_nbytes(t) for t in outs))
        hc = self.hc
        hc.collective_bytes += nbytes
        hc.collective_by_type[kind] = hc.collective_by_type.get(kind, 0.0) \
            + nbytes
        hc.collective_by_link[link] = hc.collective_by_link.get(link, 0.0) \
            + nbytes
        hc.collective_count += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        if _in_sharding_propagation():
            return func(*args, **kwargs)
        if func.overloadpacket not in self._flops:
            # without autograd (inference mode) a composite op such as
            # einsum reaches the mode whole: count the ops it runs
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        ins, outs = list(_tensors((args, kwargs))), list(_tensors(out))
        name = func.overloadpacket.__name__
        namespace = func.namespace
        if func.overloadpacket in self._flops:
            flops = float(self._flops[func.overloadpacket](
                *args, **kwargs, out_val=out))
            self.hc.flops += flops
            self.hc.flops_by_op[name] = self.hc.flops_by_op.get(name, 0.0) \
                + flops
        if namespace == "_c10d_functional" and name in _COLLECTIVES:
            self._collective(name, args, outs)
        if not (func.is_view or name in _NO_TRAFFIC):
            self.hc.bytes_accessed += float(
                sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs))
        self._track(outs, ins)
        return out


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float  # global (per-device x chips)
    hlo_bytes: float
    collective_bytes: float
    model_flops: float
    flops_ratio: float  # model_flops / hlo_flops
    bottleneck: str
    chips: int

    def to_dict(self) -> dict:
        return self.__dict__.copy()


def roofline_terms(per_device_flops, per_device_bytes,
                   per_device_collective_bytes: Union[float, Mapping],
                   chips, model_flops) -> Roofline:
    """The three terms on ``chips`` H100s.  ``per_device_collective_bytes``
    is a byte count, charged at NVLink's rate, or ``{link: bytes}`` over
    ``LINK_BW``'s links (``HloCost.collective_by_link``)."""
    by_link = (dict(per_device_collective_bytes)
               if isinstance(per_device_collective_bytes, Mapping)
               else {"nvlink": float(per_device_collective_bytes)})
    coll_dev = sum(by_link.values())
    hlo_flops = per_device_flops * chips
    hlo_bytes = per_device_bytes * chips
    coll_bytes = coll_dev * chips
    compute_s = per_device_flops / PEAK_FLOPS
    memory_s = per_device_bytes / HBM_BW
    collective_s = sum(b / LINK_BW[link] for link, b in by_link.items())
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    return Roofline(
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        hlo_flops=hlo_flops, hlo_bytes=hlo_bytes, collective_bytes=coll_bytes,
        model_flops=model_flops,
        flops_ratio=model_flops / hlo_flops if hlo_flops else 0.0,
        bottleneck=max(terms, key=terms.get), chips=chips,
    )
