"""dash_p95_ms: the 95th percentile (nearest rank) of every query of the
window, from its send to its last row; a failed query counts as slower
than every success."""
import math


def read(obs):
    ms = sorted((r.done - r.sent) * 1e3 if r.error is None else math.inf
                for r in obs["records"])
    if not ms:
        return None
    p95 = ms[math.ceil(0.95 * len(ms)) - 1]
    return p95 if math.isfinite(p95) else None
