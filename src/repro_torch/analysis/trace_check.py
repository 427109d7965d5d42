"""Chrome trace-event JSON validator (the CI obs-smoke checker).

Checks the structural contract Perfetto / ``chrome://tracing`` rely on:

  * every event carries ``ph``, ``ts``, ``pid``, ``tid`` and ``name``;
  * ``ph`` is one of B/E/X/i/I/M;
  * per ``(pid, tid)`` track, timestamps are non-decreasing and B/E pairs
    are balanced with matching names (proper nesting — an ``E`` must close
    the innermost open ``B``);
  * no ``B`` left open at end of trace.

Usable as a library (``validate_chrome_trace``) from tests and the obs
smoke, or as a CLI::

    PYTHONPATH=src python -m repro_torch.analysis.trace_check trace.json

exits 0 when the trace validates, 1 with one problem per line otherwise.
"""
from __future__ import annotations

import json
import sys
from typing import Dict, List, Tuple

_VALID_PH = {"B", "E", "X", "i", "I", "M"}
_REQUIRED = ("ph", "ts", "pid", "tid", "name")


def validate_chrome_trace(data) -> List[str]:
    """Return a list of problems (empty = valid).  ``data`` is the loaded
    JSON object ({"traceEvents": [...]}) or the raw event list."""
    events = data.get("traceEvents") if isinstance(data, dict) else data
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    problems: List[str] = []
    stacks: Dict[Tuple, List[str]] = {}
    last_ts: Dict[Tuple, float] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        missing = [f for f in _REQUIRED if f not in ev]
        if missing:
            problems.append(f"event {i} ({ev.get('name')!r}): missing "
                            f"required fields {missing}")
            continue
        ph = ev["ph"]
        if ph not in _VALID_PH:
            problems.append(f"event {i} ({ev['name']!r}): unknown ph {ph!r}")
            continue
        if ph == "M":
            continue  # metadata: no timeline position
        if not isinstance(ev["ts"], (int, float)):
            problems.append(f"event {i} ({ev['name']!r}): non-numeric ts")
            continue
        key = (ev["pid"], ev["tid"])
        if ev["ts"] < last_ts.get(key, float("-inf")):
            problems.append(
                f"event {i} ({ev['name']!r}): ts {ev['ts']} goes backwards "
                f"on track {key} (last {last_ts[key]})")
        last_ts[key] = ev["ts"]
        if ph == "B":
            stacks.setdefault(key, []).append(ev["name"])
        elif ph == "E":
            stack = stacks.get(key) or []
            if not stack:
                problems.append(f"event {i} ({ev['name']!r}): E with no "
                                f"open B on track {key}")
            elif stack[-1] != ev["name"]:
                problems.append(
                    f"event {i}: E {ev['name']!r} does not close innermost "
                    f"open span {stack[-1]!r} on track {key}")
                stack.pop()
            else:
                stack.pop()
    for key, stack in stacks.items():
        if stack:
            problems.append(f"track {key}: unclosed spans at end of "
                            f"trace: {stack}")
    return problems


def main(argv: List[str]) -> int:
    if len(argv) != 1:
        print("usage: python -m repro_torch.analysis.trace_check TRACE.json",
              file=sys.stderr)
        return 2
    with open(argv[0]) as f:
        data = json.load(f)
    problems = validate_chrome_trace(data)
    for p in problems:
        print(p)
    if not problems:
        events = data.get("traceEvents", data)
        spans = sum(1 for e in events if e.get("ph") == "B")
        print(f"OK: {len(events)} events, {spans} spans, trace validates")
    return 1 if problems else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
