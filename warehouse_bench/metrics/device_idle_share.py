"""device_idle_share: 1 - the union of the device's kernel and copy
intervals over the window on the host clock (torch.profiler)."""
from warehouse_bench.metrics._device_profile import busy_and_gaps


def read(obs):
    seen = obs["profile"]
    if not seen:
        return None
    busy, _ = busy_and_gaps(seen["spans"], obs["t_open"], obs["t_close"])
    return 1.0 - busy / obs["window_s"]
