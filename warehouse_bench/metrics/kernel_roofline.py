"""kernel_roofline: for the six SQL kernels, the sum of each launch's bound
time (kernels_cost.py, from the launch's shapes) over the sum of their
device time in the profiler, in percent."""
from warehouse_bench import kernels_cost

# the device functions of each kernel (csrc/*.cu), matched in the trace
DEVICE_NAMES = (
    ("hash_group_minmax", ("minmax_",)),
    ("hash_group", ("group_morsel", "group_grid", "group_global")),
    ("filter_eval", ("filter_eval",)),
    ("key_lookup", ("key_lookup",)),
    ("hash_partition", ("hash_partition",)),
    ("bloom_probe", ("bloom_probe",)),
)


def kernel_of(name: str):
    for kernel, parts in DEVICE_NAMES:
        if any(p in name for p in parts):
            return kernel
    return None


def read(obs):
    seen, clocks = obs["profile"], obs["clocks"]
    if not seen or not clocks or not clocks["launches"]:
        return None
    device_s = sum(t - s for s, t, name in seen["spans"]
                   if not name.startswith("Memcpy") and kernel_of(name))
    if not device_s:
        return None
    bound = sum(kernels_cost.bound_s(k, shape)
                for k, shape in clocks["launches"])
    return 100.0 * bound / device_s
