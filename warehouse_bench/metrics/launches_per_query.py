"""launches_per_query: launches of the six SQL kernels in the window
(``registry.launch_counts()``), a query."""
KERNELS = ("filter_eval", "key_lookup", "hash_group", "hash_group_minmax",
           "hash_partition", "bloom_probe")


def read(obs):
    n = len(obs["records"])
    total = sum(obs["launches"].get(k, 0) for k in KERNELS)
    return total / n if n and total else None
