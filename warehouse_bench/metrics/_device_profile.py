"""The device's activity over the measured window, from torch.profiler.

A copy of ``chip_smoke.device_profile`` with the window taken from the
host clock: the profiler (CPU and CUDA activities, no stacks or shapes)
runs from before the window opens to after it closes, a marker op at each
end ties the profiler's clock to ``time.perf_counter``, and every device
interval (kernels and copies) is clipped to the window.  The busy time is
the union of those intervals; an idle gap is a stretch of the window with
none, named by the host span open at its middle.
"""
from __future__ import annotations

import time

OPEN, CLOSE = "warehouse_bench.window_open", "warehouse_bench.window_close"
TOP = 10


class DeviceProfile:
    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        self._prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            record_shapes=False, with_stack=False)
        self._prof.__enter__()
        return self

    def mark(self, name: str) -> float:
        """A marker op in the trace; returns the host clock beside it."""
        from torch.profiler import record_function

        t = time.perf_counter()
        with record_function(name):
            pass
        return t

    def __exit__(self, *exc):
        self._torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        return False

    def read(self, marked: tuple, t_open: float, t_close: float) -> dict:
        """Device intervals in the host window [t_open, t_close], as
        (start, end, name) on the host clock, after the profiler stopped;
        ``marked`` is the host clock at the two markers."""
        from torch.autograd import DeviceType

        events = list(self._prof.events())
        marks = {e.name: e.time_range.start for e in events
                 if e.name in (OPEN, CLOSE)}
        # profiler microseconds -> host seconds, fitted on the two markers
        p0, p1 = marks[OPEN], marks[CLOSE]
        scale = (marked[1] - marked[0]) / ((p1 - p0) or 1.0)

        def host(us: float) -> float:
            return marked[0] + (us - p0) * scale

        spans = []
        for e in events:
            if e.device_type != DeviceType.CUDA:
                continue
            s = max(host(e.time_range.start), t_open)
            t = min(host(e.time_range.end), t_close)
            if t > s:
                spans.append((s, t, e.name))
        spans.sort()
        return {"window_s": t_close - t_open, "spans": spans,
                "events": len(events)}


def busy_and_gaps(spans: list, t_open: float, t_close: float) -> tuple:
    """(union of the intervals in seconds, the idle gaps as (start, end))."""
    busy, end, gaps = 0.0, t_open, []
    for s, t, _ in spans:
        if s > end:
            gaps.append((end, s))
        if t > end:
            busy += t - max(s, end)
            end = t
    if t_close > end:
        gaps.append((end, t_close))
    return busy, gaps


def by_name(spans: list) -> list:
    """[name, seconds] of the device operations that took most time."""
    total = {}
    for s, t, name in spans:
        total[name] = total.get(name, 0.0) + (t - s)
    return [[n, v] for n, v in sorted(total.items(), key=lambda kv: -kv[1])]


def name_gaps(gaps: list, host_spans: list) -> list:
    """[name, seconds] of the longest gaps, each named by the innermost
    host span ((start, end, name) on the host clock) open at its middle."""
    out = []
    for s, t in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
        mid = (s + t) / 2
        open_now = [(e - b, name) for b, e, name in host_spans
                    if b <= mid <= e]
        out.append([min(open_now)[1] if open_now else "no query open",
                    t - s])
    return out
