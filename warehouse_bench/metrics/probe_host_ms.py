"""probe_host_ms: host ms a query in the executor's key_lookup and
bloom_probe calls outside their trips (metrics/_part_clocks.py)."""


def read(obs):
    clocks, n = obs["clocks"], len(obs["records"])
    if not clocks or not n:
        return None
    probe = clocks["probe"].values()
    if not sum(p["calls"] for p in probe):
        return None
    return sum(p["call_s"] - p["trip_s"] for p in probe) * 1e3 / n
