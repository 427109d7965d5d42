"""Host clocks around the executor's kernel calls, for the traced run.

A copy of ``chip_smoke.PartClocks`` widened to every trip: while in a
``with`` block it wraps the program's one native call of a trip
(``kernels/registry.py: _run``: stage the morsel, copy it in, launch, copy
back, synchronise, copy out) and records its seconds and the launch's
shapes, and it wraps ``exec._BuildTable._lookup`` and
``exec._KernelBloomProbe.might_contain``, whose seconds less those of the
trips made inside them are the executor's own work around a key_lookup or
bloom_probe call (the float32 cast and round-trip test, the hashing, the
trip's arguments).  Only calls that made a trip are counted.  It patches
private names of the program: spans inside the program should replace it.
"""
from __future__ import annotations

import threading
import time

# where the shapes lie among a trip's launch arguments (those after the
# seven leading arguments of every ``<kernel>_trip`` entry point), as
# ``kernels/*/ops.py`` passes them
SHAPES = {
    "filter_eval": {"k": 3, "n": 4},
    "key_lookup": {"g": 1, "n": 3},
    "hash_group": {"n": 2, "g": 3},
    "hash_group_minmax": {"n": 2, "g": 3},
    "hash_partition": {"k": 1, "n": 2},
    "bloom_probe": {"words": 3, "hashes": 4, "n": 6},
}
TRIP_ARGS = 7


class Clocks:
    def __init__(self):
        self.trip_s = 0.0
        self.trips = 0
        self.probe = {k: {"calls": 0, "call_s": 0.0, "trip_s": 0.0}
                      for k in ("key_lookup", "bloom_probe")}
        self.launches = []  # (kernel, shape) of every trip
        self._lock = threading.Lock()
        self._local = threading.local()
        self._undo = []

    def _trip(self, run):
        local = self._local

        def timed(entry, *args):
            t0 = time.perf_counter()
            try:
                return run(entry, *args)
            finally:
                dt = time.perf_counter() - t0
                kernel = entry[:-len("_trip")]
                where = SHAPES.get(kernel)
                launch = args[TRIP_ARGS:]
                shape = ({k: int(launch[i]) for k, i in where.items()}
                         if where else None)
                with self._lock:
                    self.trip_s += dt
                    self.trips += 1
                    if shape is not None:
                        self.launches.append((kernel, shape))
                if getattr(local, "inside", None) is not None:
                    local.inside += dt
        return timed

    def _outer(self, kernel, fn):
        local = self._local

        def whole(*a, **kw):
            local.inside = 0.0
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                dt = time.perf_counter() - t0
                inside, local.inside = local.inside, None
                if inside:
                    with self._lock:
                        p = self.probe[kernel]
                        p["calls"] += 1
                        p["call_s"] += dt
                        p["trip_s"] += inside
        return whole

    def _patch(self, owner, name, value):
        self._undo.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, value)

    def __enter__(self):
        from repro_torch.core.runtime import exec as ex
        from repro_torch.kernels import registry

        self._patch(registry, "_run", self._trip(registry._run))
        self._patch(ex._BuildTable, "_lookup",
                    self._outer("key_lookup", ex._BuildTable._lookup))
        self._patch(ex._KernelBloomProbe, "might_contain",
                    self._outer("bloom_probe",
                                ex._KernelBloomProbe.might_contain))
        return self

    def __exit__(self, *exc):
        for owner, name, value in reversed(self._undo):
            setattr(owner, name, value)
        self._undo.clear()
        return False

    def summary(self) -> dict:
        with self._lock:
            return {"trip_s": self.trip_s, "trips": self.trips,
                    "probe": {k: dict(v) for k, v in self.probe.items()},
                    "launches": list(self.launches)}
