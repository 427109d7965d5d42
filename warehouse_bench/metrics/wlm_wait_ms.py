"""wlm_wait_ms: mean WLM admission wait a query (obs tracing's
``wlm:admission_wait`` spans; a query that skipped admission, as a
result-cache hit does, adds 0)."""


def read(obs):
    traced = [r for r in obs["records"] if r.trace]
    if not traced:
        return None
    total = 0.0
    for r in traced:
        begin = {}
        for ev in r.trace["traceEvents"]:
            if ev.get("name") != "wlm:admission_wait":
                continue
            if ev["ph"] == "B":
                begin[ev["tid"]] = ev["ts"]
            elif ev["ph"] == "E" and ev["tid"] in begin:
                total += (ev["ts"] - begin.pop(ev["tid"])) / 1e3
    return total / len(traced)
