"""The benchmark of the PyTorch/CUDA port's SQL warehouse (``repro_torch``):
Star Schema Benchmark deployments served through ``repro_torch.api``.  Run
one cell once with ``python3 warehouse_bench/run.py --workload <name>
--seed <n> --seconds <s> --trace <0|1>``."""
