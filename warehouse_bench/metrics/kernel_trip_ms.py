"""kernel_trip_ms: ms a query in the program's ``kernel:*`` spans, one a
kernel call (``registry.host_call``): on the card the whole trip, the
packing of the morsel and the native call (copy in, launch, copy back,
synchronise)."""
from warehouse_bench.metrics import _spans


def measure(trace):
    calls = [s.ms for s in _spans.spans(trace)
             if s.name.startswith("kernel:")]
    return sum(calls) if calls else None


def read(obs):
    return _spans.per_query(obs["records"], measure)
