"""probe_self_ms: the executor's own ms a query in its join and
runtime-filter probes: each ``probe:*`` span (``_BuildTable._lookup``,
``_KernelBloomProbe.might_contain``) less the ``kernel:*`` spans inside it,
the lookups that take NumPy's host path included."""
from warehouse_bench.metrics import _spans


def measure(trace):
    spans = _spans.spans(trace)
    own = {i: s.ms for i, s in enumerate(spans)
           if s.name.startswith("probe:")}
    if not own:
        return None
    for i, s in enumerate(spans):
        if s.name.startswith("kernel:"):
            j = _spans.enclosing(spans, i, "probe:")
            if j is not None:
                own[j] -= s.ms
    return sum(own.values())


def read(obs):
    return _spans.per_query(obs["records"], measure)
