"""The program's spans in the window's obs traces, for the span readers.

Each record of a traced run carries its query's Chrome trace
(``r.trace["traceEvents"]``); B and E events are paired by ``tid``, as
the program nests its live spans on the thread that ran them.  A trace
that states its clock (``otherData["t0_s"]``) comes from a program that
records the kernel, probe, result-cache and CPU-time spans these readers
read; an older program's traces lack it, and lack those spans.
"""
from __future__ import annotations

from typing import NamedTuple, Optional


class Span(NamedTuple):
    name: str
    tid: int
    begin_us: float
    end_us: float
    args: dict
    parent: Optional[int]  # index of the span open around it on its tid

    @property
    def ms(self) -> float:
        return (self.end_us - self.begin_us) / 1e3


def traces(records: list) -> list:
    """The obs traces of the window's traced queries."""
    return [r.trace for r in records if r.trace]


def states_clock(trace: dict) -> bool:
    return "t0_s" in trace.get("otherData", {})


def spans(trace: dict) -> list:
    """Every B/E pair of the trace as a :class:`Span`, in the order the
    spans close."""
    out, open_at = [], {}
    for ev in trace["traceEvents"]:
        ph = ev.get("ph")
        if ph == "B":
            open_at.setdefault(ev["tid"], []).append(ev)
        elif ph == "E" and open_at.get(ev["tid"]):
            stack = open_at[ev["tid"]]
            b = stack.pop()
            out.append([b["name"], ev["tid"], b["ts"], ev["ts"],
                        b.get("args") or {}, id(stack[-1]) if stack else None,
                        id(b)])
    index = {row[6]: i for i, row in enumerate(out)}
    return [Span(name, tid, b, e, args, index.get(parent))
            for name, tid, b, e, args, parent, _ in out]


def enclosing(all_spans: list, i: int, prefix: str) -> Optional[int]:
    """The innermost span around span ``i`` whose name starts with
    ``prefix``, or None."""
    j = all_spans[i].parent
    while j is not None and not all_spans[j].name.startswith(prefix):
        j = all_spans[j].parent
    return j


def off_cpu_ms(span: Span) -> float:
    """The span's wall time less its thread's CPU time (``cpu_ms``)."""
    return span.ms - span.args["cpu_ms"]


def per_query(records: list, measure) -> Optional[float]:
    """Mean over the traced queries of ``measure(trace)`` (a float, or None
    where the trace holds nothing it reads, counted as 0); None when no
    traced query holds anything."""
    values = [measure(t) for t in traces(records)]
    if not values or all(v is None for v in values):
        return None
    return sum(v or 0.0 for v in values) / len(values)
