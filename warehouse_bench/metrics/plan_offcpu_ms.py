"""plan_offcpu_ms: ms a query that the pipeline's host stages (every
``stage:*`` span but execute) spent off the CPU: each stage's wall time
less its thread's CPU time (``cpu_ms``), less the same of the
``cache:pending_wait`` inside it, which ``cache_wait_ms`` reads.  What is
left is the thread waiting for the interpreter lock or the OS."""
from warehouse_bench.metrics import _spans


def measure(trace):
    spans = _spans.spans(trace)
    off = {i: _spans.off_cpu_ms(s) for i, s in enumerate(spans)
           if s.name.startswith("stage:") and s.name != "stage:execute"
           and "cpu_ms" in s.args}
    if not off:
        return None
    for i, s in enumerate(spans):
        if s.name == "cache:pending_wait":
            j = _spans.enclosing(spans, i, "stage:")
            if j in off:
                off[j] -= _spans.off_cpu_ms(s)
    return sum(off.values())


def read(obs):
    return _spans.per_query(obs["records"], measure)
