"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--rows 2000000]

Phases (any failure raises and exits non-zero; nothing is caught):
  1. the card's name and power limit (nvidia-smi); fails without CUDA/sm_90;
  2. build the CUDA kernels from src/repro_torch/csrc into build/;
  3. hold each kernel against its plain torch version on the card, at the
     main path's shapes (1024-row morsels and 8192-row stripes, SSB's
     dictionaries, few to thousands of groups) and at a shape of millions
     of rows, and time the
     kernel, the plain version, one PyTorch library call computing the same
     function (a yardstick only; the port never calls it) and the bound;
  4. load SSB (lineorder at 2,000,000 rows by default) and run the 13
     SSB queries plus KERNEL_QUERIES through repro_torch.api under
     ``engine: cuda`` and ``engine: auto`` (numpy host paths) on the same
     warehouse, with the slice configuration; the row sets must agree and
     every path kernel's launch counter must have risen;
  5. print the ``kernels`` JSON line, the card line, and last
     ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
SLICE = {"semijoin_reduction": False, "result_cache": False,
         "shuffle.partitions": 1}
LINEORDER_COLS = ("lo_orderkey", "lo_custkey", "lo_partkey", "lo_suppkey",
                  "lo_orderdate", "lo_quantity", "lo_extendedprice",
                  "lo_discount", "lo_revenue", "lo_supplycost")
PATH_KERNELS = ("filter_eval", "key_lookup", "hash_group",
                "hash_group_minmax")
REPLACES = {
    "filter_eval": "src/repro/kernels/filter_eval/filter_eval.py:45",
    "key_lookup": "src/repro/kernels/key_lookup/key_lookup.py:42",
    "hash_group": "src/repro/kernels/hash_group/hash_group.py:94",
    "hash_group_minmax": "src/repro/kernels/hash_group/hash_group.py:59",
}
SOURCES = {
    "filter_eval": "src/repro_torch/csrc/filter_eval.cu",
    "key_lookup": "src/repro_torch/csrc/key_lookup.cu",
    "hash_group": "src/repro_torch/csrc/hash_group.cu",
    "hash_group_minmax": "src/repro_torch/csrc/hash_group.cu",
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls, by CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, args, reps: int = 200) -> float:
    """Mean ms per numpy-in/numpy-out call (copy in, launch, copy out), as
    the executor makes it for every morsel; host clock, the copy back
    synchronises."""
    for _ in range(3):
        fn(*args)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    return (time.perf_counter() - t0) * 1e3 / reps


def host_round_trips() -> dict:
    """The executor's per-morsel kernel call at the main path's shapes."""
    from repro_torch.kernels import registry

    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    n = 1024
    codes = rng.integers(0, 7, n).astype(np.int32)
    vals = rng.integers(1, 50, n).astype(np.float32)
    calls = {
        "filter_eval": ((rng.integers(0, 50, n).astype(np.float32),),
                        (0,), (25.0,)),
        "key_lookup": (np.arange(2556, dtype=np.float32),
                       rng.integers(0, 2556, n).astype(np.float32)),
        "hash_group": (codes, vals, 7),
        "hash_group_minmax": (codes, vals, 7),
    }
    out = {}
    for k, args in calls.items():
        fn = registry.host_call(registry.resolve(k, "cuda"), dev)
        out[k] = host_ms(fn, args)
        print(f"  {k:18s} host round trip {out[k]:.4f} ms", flush=True)
    return out


def bound_ms(nbytes: float, ops: float) -> tuple:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version on the card
# ---------------------------------------------------------------------------
def check_kernels(dev, rng) -> dict:
    from repro_torch.kernels.filter_eval.ops import filter_eval_cuda
    from repro_torch.kernels.filter_eval.ref import filter_eval_ref
    from repro_torch.kernels.hash_group.ops import (hash_group_cuda,
                                                    hash_group_minmax_cuda)
    from repro_torch.kernels.hash_group.ref import (hash_group_minmax_ref,
                                                    hash_group_ref)
    from repro_torch.kernels.key_lookup.ops import key_lookup_cuda
    from repro_torch.kernels.key_lookup.ref import key_lookup_ref

    err = {k: 0.0 for k in PATH_KERNELS}
    timed = {}

    def t(a):
        return torch.as_tensor(a, device=dev)

    def record(name, shape, reps, kern, plain, lib, nbytes, ops, main):
        ms, pms = time_ms(kern, reps), time_ms(plain, reps)
        lms = time_ms(lib, reps) if lib is not None else None
        bms, by = bound_ms(nbytes, ops)
        row = {"shape": shape, "ms": ms, "plain_ms": pms, "library_ms": lms,
               "bound_ms": bms, "bound_by": by}
        print(f"  {name:18s} {shape:22s} kernel {ms:.4f} ms  plain "
              f"{pms:.4f} ms  library {'-' if lms is None else f'{lms:.4f}'}"
              f" ms  bound {bms:.6f} ms ({by})", flush=True)
        if main:
            timed[name] = row
        else:
            timed.setdefault(name + "@large", row)

    # filter_eval: bit-exact
    for n, k, main in ((1024, 1, False), (1024, 2, True), (1024, 4, False),
                       (8192, 1, False), (4_000_000, 3, False)):
        cols = [t(rng.integers(0, 100, n).astype(np.float32))
                for _ in range(k)]
        ops = tuple(i % 6 for i in range(k))
        lits = tuple(float(rng.integers(20, 80)) for _ in range(k))
        got = filter_eval_cuda(cols, ops, lits)
        exp = filter_eval_ref(cols, ops, lits)
        torch.cuda.synchronize()
        bad = int((got != exp).sum())
        assert bad == 0, f"filter_eval n={n} k={k}: {bad} rows differ"
        err["filter_eval"] = max(err["filter_eval"], float(bad))
        if main or n > 8192:
            record("filter_eval", f"n={n} K={k}", 200 if n <= 1024 else 20,
                   lambda: filter_eval_cuda(cols, ops, lits),
                   lambda: filter_eval_ref(cols, ops, lits), None,
                   n * (4 * k + 1), n * k, main)

    # key_lookup: exact; SSB's dictionaries (supplier, part, customer, date)
    for g, n, main in ((200, 1024, False), (400, 1024, False),
                       (1000, 1024, False), (2556, 1024, True),
                       (2556, 8192, False), (2556, 4_000_000, False)):
        uniq = t(np.arange(g, dtype=np.float32))
        probe = t(rng.integers(-10, g + 10, n).astype(np.float32))
        got = key_lookup_cuda(uniq, probe)
        exp = key_lookup_ref(uniq, probe)
        torch.cuda.synchronize()
        e = float((got.long() - exp.long()).abs().max())
        assert e == 0, f"key_lookup g={g} n={n}: max error {e}"
        err["key_lookup"] = max(err["key_lookup"], e)
        if main or n > 8192:
            steps = math.ceil(math.log2(g + 1))

            def lib(uniq=uniq, probe=probe):
                idx = torch.searchsorted(uniq, probe)
                return torch.where(
                    uniq[idx.clamp(max=g - 1)] == probe, idx, -1)

            record("key_lookup", f"G={g} n={n}", 200 if n <= 1024 else 20,
                   lambda: key_lookup_cuda(uniq, probe),
                   lambda: key_lookup_ref(uniq, probe), lib,
                   4 * g + 8 * n, n * steps, main)

    # hash_group / hash_group_minmax: counts, integer sums, min/max exact;
    # float sums at atol 1e-3 (atomics add in a run-dependent order)
    for g, n, main in ((1, 1024, False), (7, 1024, True), (640, 1024, False),
                       (3000, 1024, False), (6144, 1024, False),
                       (8000, 1024, False), (3000, 4_000_000, False)):
        codes = t(rng.integers(-1, g, n).astype(np.int32))
        fvals = t(rng.normal(size=n).astype(np.float32))
        ivals = t(rng.integers(1, 50, n).astype(np.float32))
        s, c = hash_group_cuda(codes, fvals, g)
        es, ec = hash_group_ref(codes, fvals, g)
        si, _ = hash_group_cuda(codes, ivals, g)
        esi, _ = hash_group_ref(codes, ivals, g)
        mi, ma = hash_group_minmax_cuda(codes, fvals, g)
        emi, ema = hash_group_minmax_ref(codes, fvals, g)
        torch.cuda.synchronize()
        e_sum = float((s - es).abs().max())
        assert e_sum <= 1e-3, f"hash_group g={g} n={n}: sum error {e_sum}"
        assert torch.equal(c, ec), f"hash_group g={g} n={n}: counts differ"
        assert torch.equal(si, esi), f"hash_group g={g} n={n}: int sums"
        assert torch.equal(mi, emi) and torch.equal(ma, ema), \
            f"hash_group_minmax g={g} n={n}: differs"
        err["hash_group"] = max(err["hash_group"], e_sum)
        if main or n > 1024:
            reps = 200 if n <= 1024 else 20
            # the library calls take the masked rows out beforehand (not
            # timed): bincount needs codes >= 0
            keep = codes >= 0
            safe = codes.clamp(min=0).long()
            wsum, wcnt = fvals * keep, keep.float()
            lo = torch.full((g,), math.inf, device=dev)
            hi = torch.full((g,), -math.inf, device=dev)
            kcodes, kvals = safe[keep], fvals[keep]
            record("hash_group", f"G={g} n={n}", reps,
                   lambda: hash_group_cuda(codes, fvals, g),
                   lambda: hash_group_ref(codes, fvals, g),
                   lambda: (torch.bincount(safe, weights=wsum, minlength=g),
                            torch.bincount(safe, weights=wcnt, minlength=g)),
                   8 * n + 8 * g, 2 * n, main)
            record("hash_group_minmax", f"G={g} n={n}", reps,
                   lambda: hash_group_minmax_cuda(codes, fvals, g),
                   lambda: hash_group_minmax_ref(codes, fvals, g),
                   lambda: (lo.scatter_reduce(0, kcodes, kvals, "amin"),
                            hi.scatter_reduce(0, kcodes, kvals, "amax")),
                   8 * n + 8 * g, 2 * n, main)
    return {"err": err, "timed": timed}


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------
def rows_of(cur):
    return cur.fetchall()


def same_rows(got, exp) -> bool:
    if len(got) != len(exp):
        return False
    key = lambda r: tuple(str(v) if isinstance(v, str) else  # noqa: E731
                          (round(v, 4) if isinstance(v, float) else v)
                          for v in r)
    for g, e in zip(sorted(got, key=key), sorted(exp, key=key)):
        for gv, ev in zip(g, e):
            if gv is None or ev is None:
                if not (gv is None and ev is None):
                    return False
            elif isinstance(ev, float) or isinstance(gv, float):
                if not ((math.isnan(gv) and math.isnan(ev))
                        or np.allclose(gv, ev)):
                    return False
            elif gv != ev:
                return False
    return True


def main_path(rows: int, work_dir: str) -> dict:
    import repro_torch.api as db
    from repro_torch.core.session import Warehouse
    from repro_torch.kernels import registry
    from repro_torch.workloads.ssb import (KERNEL_QUERIES, SSB_QUERIES,
                                           load_ssb)

    queries = {**SSB_QUERIES, **KERNEL_QUERIES}
    shutil.rmtree(work_dir, ignore_errors=True)
    spill = os.path.join(work_dir, "spill")
    wh = Warehouse(os.path.join(work_dir, "wh"))
    try:
        t0 = time.perf_counter()
        load_ssb(wh, scale_rows=rows)
        print(f"load_ssb rows={rows}: {time.perf_counter() - t0:.1f} s",
              flush=True)
        # warm the scan caches over every lineorder column, so the first
        # query of the first engine does not pay for a cold read alone
        t0 = time.perf_counter()
        with db.connect(warehouse=wh, engine="auto", **SLICE) as warm:
            warm.execute("SELECT " + ", ".join(
                f"SUM({c})" for c in LINEORDER_COLS) + " FROM lineorder"
            ).fetchall()
        print(f"cold scan of every lineorder column: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        cfg = {**SLICE, "exchange.spill_dir": spill}
        print(f"{'query':10s} {'rows':>6s} {'cuda ms':>10s} {'auto ms':>10s}"
              "  cuda launches (filter_eval key_lookup hash_group "
              "hash_group_minmax)", flush=True)
        with db.connect(warehouse=wh, engine="cuda", **cfg) as cuda, \
                db.connect(warehouse=wh, engine="auto", **cfg) as auto:
            registry.reset_launch_counts()
            for name, sql in queries.items():
                # each query runs under cuda, then under auto, so both see
                # the same scan-cache state
                before = registry.launch_counts()
                t0 = time.perf_counter()
                got = rows_of(cuda.execute(sql))
                mc = (time.perf_counter() - t0) * 1e3
                after = registry.launch_counts()
                t0 = time.perf_counter()
                exp = rows_of(auto.execute(sql))
                ma = (time.perf_counter() - t0) * 1e3
                assert same_rows(got, exp), f"{name}: cuda rows != auto rows"
                counts = " ".join(str(after.get(k, 0) - before.get(k, 0))
                                  for k in PATH_KERNELS)
                print(f"{name:10s} {len(got):6d} {mc:10.1f} {ma:10.1f}  "
                      f"{counts}", flush=True)
            torch.cuda.synchronize()
            launches = registry.launch_counts()
        print(f"launches on the main path: {launches}", flush=True)
        for k in PATH_KERNELS:
            assert launches.get(k, 0) > 0, f"{k} never launched on the path"
        return launches
    finally:
        wh.close()
        shutil.rmtree(work_dir, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # SSB SF1 has 6,000,000 lineorder rows; the host stripe reader carried
    # over from the reference re-reads a file's whole zip directory for
    # every stripe column it reads (quadratic in stripes per file), which
    # puts SF1 past the run's time limit: PERF.md records the cut
    ap.add_argument("--rows", type=int, default=2_000_000,
                    help="lineorder rows (default 2,000,000; SSB SF1 has "
                         "6,000,000)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no port package under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.kernels import _build, registry

    card = card_line()
    print(f"card: {card}", flush=True)
    cap = torch.cuda.get_device_capability()
    assert registry.on_gpu(), f"needs sm_90 or newer, have sm_{cap[0]}{cap[1]}"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"capability {cap}", flush=True)

    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    print(f"built {os.path.relpath(lib, HERE)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in _build.build_log().splitlines():
        if "Compiling entry function" in line or "Used" in line:
            print("  " + line.split("ptxas info    : ", 1)[-1], flush=True)
    _build.library()

    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    print("kernel checks against the plain versions on the card:",
          flush=True)
    checked = check_kernels(dev, rng)
    print("executor calls (numpy in, numpy out) at n=1024:", flush=True)
    round_trip = host_round_trips()

    work = os.path.join(HERE, "build", "chip_smoke_wh")
    launches = main_path(args.rows, work)

    kernels = []
    for k in PATH_KERNELS:
        row = checked["timed"][k]
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCES[k],
            "replaces": REPLACES[k], "launches": launches[k],
            "max_abs_err": checked["err"][k], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], "host_call_ms": round_trip[k],
            "large": checked["timed"].get(k + "@large"),
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
