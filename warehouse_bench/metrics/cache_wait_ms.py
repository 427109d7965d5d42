"""cache_wait_ms: ms a query blocked in the result cache on another
query's pending entry of the same statement (``cache:pending_wait``
spans, inside ``stage:cache_probe``; a query that did not wait adds 0)."""
from warehouse_bench.metrics import _spans


def measure(trace):
    if not _spans.states_clock(trace):
        return None  # a program that does not record the wait
    return sum(s.ms for s in _spans.spans(trace)
               if s.name == "cache:pending_wait")


def read(obs):
    return _spans.per_query(obs["records"], measure)
