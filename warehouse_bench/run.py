"""Run one cell of the benchmark once on the local card and print its
result as the last line of standard output.

    python3 warehouse_bench/run.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

The cell is ``BENCHMARK.json``'s workload entry (``warehouse_bench/cell.py``
says what a run does).  The last line is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` (with ``--trace 1`` also
``busy_s`` and ``window_s``), with ``--trace 1`` ``breakdown``, and last
``compared``: each number the correctness check compared, beside its limit,
also printed as the last lines of standard error.  Exits 2 and prints no
result without a CUDA card (or with fewer than the cell asks for), without
the port's package beside this directory, or when JAX or the JAX package
is loaded after the window.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the kernel caches of the program stay inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / sub)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def fail(msg: str) -> int:
    print(f"warehouse_bench: {msg}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench_file = ROOT / "BENCHMARK.json"
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").exists():
        return fail(f"no port package under {src}")
    sys.path[0:1] = [str(src), str(ROOT)]
    import torch

    from warehouse_bench import cell

    bench = cell.load_json(bench_file)
    chips = cell.cell_spec(bench, args.workload)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return fail(f"{args.workload} needs {chips} CUDA card(s); "
                    f"torch sees {torch.cuda.device_count()}")
    import repro_torch

    if Path(repro_torch.__file__).resolve().parents[1] != src:
        return fail(f"repro_torch comes from {repro_torch.__file__}, "
                    f"not from {src}")
    out = cell.run(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), T_START)
    loaded = sorted({m.split(".", 1)[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        return fail(f"loaded after the window: {', '.join(loaded)}")
    for name, v in out["compared"].items():
        print(f"compared {name}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
