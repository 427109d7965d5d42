"""Shared small sizes and helpers of the benchmark's CPU tests."""
import time

from warehouse_bench import cell

# a few thousand fact rows; every dimension small but date whole
SIZES = {"lineorder": 6000, "customer": 300, "supplier": 40, "part": 2000,
         "date_dim": 2556}


def bench() -> dict:
    return cell.load_json(cell.ROOT / "BENCHMARK.json")


WORKLOADS = tuple(w["name"] for w in bench()["workloads"])


def run(workload: str, seed: int, engine: str = "auto", seconds=1.5,
        trace=False, sizes=SIZES) -> dict:
    """One run of ``workload`` on the CPU at ``sizes``."""
    return cell.run(bench(), workload, seed, seconds, trace,
                    time.perf_counter(), engine=engine, sizes=sizes,
                    on_card=False)
