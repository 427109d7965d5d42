"""The sanctioned clocks for runtime/serving/federation timing.

Every duration that feeds telemetry — vertex walls, exchange waits, spill
I/O, adaptive straggler ages — must come from one clock family so spans
from different modules compose into a single consistent
:class:`~.trace.QueryTrace` timeline.  Lint rule REP007 enforces the
chokepoint: raw ``time.monotonic()`` / ``time.perf_counter()`` (and the CPU
clocks ``time.thread_time()`` / ``time.process_time()``) calls inside
``core/runtime``, ``core/serving`` and ``core/federation`` are findings;
code there imports these aliases (or uses span helpers) instead.  The only
allowlisted exceptions are scheduler *deadline* math (WLM admission
timeouts, result-stream stall guards), where the raw clock is the point.
"""
from __future__ import annotations

import time

#: High-resolution duration clock (span timestamps, vertex walls).
perf_counter = time.perf_counter

#: Monotonic event clock (straggler ages, production telemetry).
monotonic = time.monotonic

#: This thread's CPU seconds (a span's ``cpu_ms``: its wall time less this
#: is the time its thread spent off the CPU).
thread_time = time.thread_time

#: Wall clock, for human-facing timestamps only (query-log entries).
now = time.time
