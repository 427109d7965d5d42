"""One run of one cell: set-up, the measured window, the check, the metrics.

Everything a cell is comes from files found by name: ``BENCHMARK.json``'s
workload entry names a configuration (``configs/<config>.json``: row
counts, warehouse, session configuration, limits) and a traffic mix
(``traffic/<mix>.json``, read by ``generator.py``); the mix names its query
templates (``queries/<template>.json``); each metric that
``BENCHMARK.json`` lists for the cell has a reader in
``metrics/<name>.py`` or, for ``<quantity>.<suffix>``, in
``metrics/<quantity>.py``.

Set-up runs from process start to the window's first send: the kernel
library (built from the compile cache under ``build/`` inside the checkout),
the data drawn from the seed, the ACID load in one committed transaction,
the mix's resource plan, the clients' connections and the warm-up, each
template once on statements the window never sends.  The window is the closed loop of
``generator.closed_loop``.  With ``trace``, the window also runs under
torch.profiler, obs tracing and the host clocks of
``metrics/_part_clocks.py``, and the per-layer metrics are read instead of
the end-to-end ones.  After the window: the device's peak memory, the
program's state freed, then every answer judged against the reference.
"""
from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

from . import check
from .generator import StatementStream, closed_loop
from .metrics import _device_profile
from .reference import ssbgen

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
QUERY_TIMEOUT_S = 120.0


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(bench: dict, workload: str) -> dict:
    """The workload's entry with its configuration, mix, templates and the
    metrics it reports, each list in ``BENCHMARK.json``'s order."""
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    mix = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    templates = {name: load_json(HERE / "queries" / f"{name}.json")
                 for name in mix["templates"]}

    def listed(kind):
        return [m for m in bench[kind]
                if workload in m.get("workloads", [workload])]

    return {"cell": cell, "config": load_json(ROOT / config["file"]),
            "mix": mix, "templates": templates,
            "end_to_end": listed("end_to_end"),
            "per_layer": listed("per_layer")}


def reader(name: str):
    """``read(obs)`` of the metric's reader, found by name."""
    for stem in (name, name.split(".", 1)[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            mod_name = "warehouse_bench.metrics." + stem.replace(".", "_")
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} in metrics/")


def card() -> dict:
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1}
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        limit = ""
    out["power_limit"] = limit or "not read"
    return out


def load(wh, data: dict) -> None:
    """The tables as ACID tables, filled in one committed transaction."""
    from repro_torch.core.acid import AcidTable
    from repro_torch.core.runtime.vector import VectorBatch

    s = wh.session()
    for table, cols in ssbgen.SCHEMA.items():
        s.execute(f"CREATE TABLE {table} ("
                  + ", ".join(f"{c} {t}" for c, t in cols) + ")")
    tx = wh.hms.open_txn()
    for table, cols in data.items():
        AcidTable(wh.hms.get_table(table), wh.hms).insert(
            tx, VectorBatch(cols))
    wh.hms.commit_txn(tx)


def process_cpu_s() -> float:
    """This process's CPU seconds, user and system, all threads."""
    import resource

    own = resource.getrusage(resource.RUSAGE_SELF)
    return own.ru_utime + own.ru_stime


def host_spans(records: list) -> list:
    """(start, end, "<template> <span>") on the host clock of every span in
    the queries' obs traces (a trace's times count from its query's send,
    within the time the handle takes to open)."""
    out = []
    for rec in records:
        if not rec.trace:
            continue
        open_at = {}
        for ev in rec.trace["traceEvents"]:
            key = (ev.get("tid"), ev.get("name"))
            if ev.get("ph") == "B":
                open_at.setdefault(key, []).append(ev["ts"])
            elif ev.get("ph") == "E" and open_at.get(key):
                b = open_at[key].pop()
                out.append((rec.sent + b / 1e6, rec.sent + ev["ts"] / 1e6,
                            f"{rec.statement.template} {ev['name']}"))
    return out


def run(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, *, engine: Optional[str] = None,
        sizes: Optional[dict] = None, on_card: bool = True) -> dict:
    """One run; returns the result line's fields.  ``engine`` and ``sizes``
    replace the configuration's (tests on the CPU); without ``on_card`` no
    card is read."""
    import repro_torch.api as api
    from repro_torch.core.session import Warehouse
    from repro_torch.kernels import registry

    spec = cell_spec(bench, workload)
    cfg, mix, templates = spec["config"], spec["mix"], spec["templates"]
    session = dict(cfg["session"], **({"engine": engine} if engine else {}))
    if trace:
        session["obs.tracing"] = True
    if on_card:
        import torch

        from repro_torch.kernels import _build

        _build.library()
        torch.cuda.reset_peak_memory_stats()
    data = ssbgen.generate(
        sizes or {t: cfg[f"{t}_rows"] for t in ssbgen.SCHEMA}, seed)
    work = tempfile.mkdtemp(prefix="warehouse_bench_")
    conns, wh = [], None
    try:
        wh = Warehouse(os.path.join(work, "wh"), **cfg["warehouse"])
        session["exchange.spill_dir"] = os.path.join(work, "spill")
        load(wh, data)
        with api.connect(warehouse=wh, **session) as admin:
            for ddl in mix.get("resource_plan", ()):
                admin.execute(ddl)
        extra = ({"application": mix["application"]}
                 if mix.get("application") else {})
        conns = [api.connect(warehouse=wh, **session, **extra)
                 for _ in range(mix["clients"])]

        def send(k, st, timeout_s):
            h = conns[k].execute_async(st.sql)
            cur = h.result(timeout_s)
            rows = cur.fetchall()
            return rows, dict(cur.info), h.trace() if trace else None

        stream = StatementStream(mix, templates, seed)
        for st in stream.warmup():
            send(0, st, QUERY_TIMEOUT_S)
        if on_card:
            torch.cuda.synchronize()
        profile = clocks = None
        if trace:
            from .metrics._part_clocks import Clocks

            clocks = Clocks().__enter__()
            if on_card:
                profile = _device_profile.DeviceProfile().__enter__()
        llap0 = dict(wh.llap.counters)
        launches0 = registry.launch_counts()
        marked = [profile.mark(_device_profile.OPEN)] if profile else []
        cpu0 = process_cpu_s()
        t_open, t_close, records = closed_loop(
            stream, mix["clients"], seconds, send, QUERY_TIMEOUT_S)
        cpu_s = process_cpu_s() - cpu0
        if profile:
            marked.append(profile.mark(_device_profile.CLOSE))
        llap = {k: v - llap0.get(k, 0) for k, v in wh.llap.counters.items()}
        launches = registry.launch_counts()
        launches = {k: v - launches0.get(k, 0) for k, v in launches.items()}
        device = {"platform": "cpu", "kind": "cpu", "count": 0,
                  "memory_peak_bytes": 0}
        if on_card:
            torch.cuda.synchronize()
            device = {**card(),
                      "memory_peak_bytes": torch.cuda.max_memory_allocated()}
        seen = None
        if profile:
            profile.__exit__(None, None, None)
            seen = profile.read(marked, t_open, t_close)
        if clocks:
            clocks.__exit__(None, None, None)
        written = sum(f.stat().st_size for f in Path(work).rglob("*")
                      if f.is_file())
    finally:
        for c in conns:
            c.close()
        if wh is not None:
            wh.close()
        shutil.rmtree(work, ignore_errors=True)

    t_check = time.perf_counter()
    numbers = check.judge(data, templates, records)
    check_s = time.perf_counter() - t_check
    correct, compared = check.verdict(numbers, cfg["limits"])
    obs = {"records": records,
           "setup_s": t_open - t_start, "window_s": t_close - t_open,
           "t_open": t_open, "t_close": t_close,
           "lineorder_rows": len(data["lineorder"]["lo_orderkey"]),
           "launches": launches,
           "clocks": clocks.summary() if clocks else None,
           "profile": seen}
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec[kind]:
        value = reader(m["name"])(obs)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": correct, "attempted": len(records),
           "failed": numbers["unanswered"] + numbers["wrong_answers"],
           "metrics": metrics, "device": device}
    if seen is not None:
        busy, gaps = _device_profile.busy_and_gaps(seen["spans"], t_open,
                                                   t_close)
        device["busy_s"], device["window_s"] = busy, seen["window_s"]
        out["breakdown"] = {
            "device_ops": _device_profile.by_name(
                seen["spans"])[:_device_profile.TOP],
            "idle_gaps": _device_profile.name_gaps(gaps,
                                                   host_spans(records))}
    # diagnostics for whoever reads the line; no metric depends on them
    out.update(reused_statements=stream.reused, check_s=check_s,
               window_cpu_s=cpu_s, warehouse_bytes=written, llap=llap,
               compared=compared)
    return out
