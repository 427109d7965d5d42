"""trip_ms: host ms a query inside the registry's trips (one native call a
kernel call: copy in, launch, copy back, synchronise)."""


def read(obs):
    clocks, n = obs["clocks"], len(obs["records"])
    if not clocks or not clocks["trips"] or not n:
        return None
    return clocks["trip_s"] * 1e3 / n
