"""The correctness check's control: the plain reference put in the
program's place, computed in float32 (the precision below the DOUBLE
columns the configurations state), judged by the check as a run's answers
are.  It has to come out as not correct.

    python3 warehouse_bench/control.py --workload <name> --seeds <n> ... \\
        --queries <count>

For each seed it draws the cell's data and the statements a run would send
(warm-up first, then the window's first ``count``), answers each in float32
and prints the three numbers of ``check.py`` beside their limits as one
JSON line.  It needs no card and runs no part of the program.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def control(spec: dict, seed: int, queries: int, sizes=None) -> dict:
    """The check's numbers for the float32 reference in the program's place
    over the first ``queries`` statements of the cell's stream."""
    from warehouse_bench import check
    from warehouse_bench.generator import Record, StatementStream
    from warehouse_bench.reference import ssbgen, star

    cfg, mix, templates = spec["config"], spec["mix"], spec["templates"]
    data = ssbgen.generate(
        sizes or {t: cfg[f"{t}_rows"] for t in ssbgen.SCHEMA}, seed)
    stream = StatementStream(mix, templates, seed)
    stream.warmup()
    answers, records, joins = {}, [], {}
    for _ in range(queries):
        st = stream.next()
        if st.sql not in answers:
            tspec = templates[st.template]["spec"]
            answers[st.sql] = star.ordered(star.evaluate(
                data, tspec, st.params, np.float32, joins), tspec)
        records.append(Record(st, 0.0, 0.0, answers[st.sql], {}, None, None))
    return check.judge(data, templates, records)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--queries", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path[0:1] = [str(ROOT)]
    from warehouse_bench import cell, check

    spec = cell.cell_spec(cell.load_json(ROOT / "BENCHMARK.json"),
                          args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        numbers = control(spec, seed, args.queries)
        correct, compared = check.verdict(numbers, spec["config"]["limits"])
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "queries": args.queries, "correct": correct,
                          "seconds": time.perf_counter() - t0,
                          "compared": compared}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
