"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--rows 6000000] [--seed 0]

Phases (any failure raises and exits non-zero; nothing is caught):
  1. the card's name and power limit (nvidia-smi); fails without CUDA/sm_90;
  2. build the CUDA kernels from src/repro_torch/csrc into build/; print
     the two tensor-core flash_attention kernels' registers, shared memory
     and spills (ptxas -v; bfloat16 and float32 in three TF32 terms) and
     the HGMMA instructions in their SASS (cuobjdump), which must be more
     than 0; the same for ssd_scan's four passes, with the HMMA (mma.sync)
     instructions of the three that multiply; and hash_group's atomic
     instructions;
  3. hold each kernel against its plain torch version on the card, at the
     main path's shapes (1024-row morsels and 8192-row stripes, SSB's
     dictionaries and runtime bloom filters, few to thousands of groups,
     four shuffle lanes) and at a shape of millions of rows, and time the
     kernel, the plain version, one PyTorch library call computing the same
     function where there is one (a yardstick only; the port never calls
     it) and the bound, and each SQL kernel also from a CUDA graph (the
     card's time without the host's issue time); hash_partition is also
     held against the numpy host path and bloom_probe against
     BloomFilter.might_contain, bit-exact; filter_eval on views at offsets
     0-3 for K 1-8; hash_group's sums at the path's shape against the CPU
     emulation of the morsel path's order, bit for bit over 100 calls, its
     limits equal to the built kernel's, its morsel and grid paths timed
     against each other from 1,024 to 65,536 rows and its grid path at 4M
     rows; hash_group_minmax's two paths are timed
     against each other at its one-block limit, and flash_attention's
     three routes at the path shape
     (bfloat16 on the tensor cores beside the CUDA-core kernel on the same
     inputs; float32 on the tensor cores in three TF32 terms beside the
     CUDA-core kernel, each float32 check counted on the tf32x3 route);
  4. the LM serving path: mamba2-130m at full width and depth, random bf16
     weights from --seed; one prefill_32k step on 2 x 32,768 tokens (the
     batch of 32 cut to 2) that must launch ssd_scan once per layer (each
     of its four passes once per call, counted where it is launched), then
     128 sequences decoded through make_serve_step (a 256-token prompt
     token by token, then 32 greedy tokens); prints tokens/s, ms a step,
     peak memory and launches; then, outside the counted window, holds the
     decode logits against a prefill of the same prompt, the kernel
     prefill's logits against the plain scan's, and every layer's scan
     against its plain version on that layer's own inputs from the
     prefill.  Then the MoE serving path: olmoe-1b-7b at full width and
     depth (6,919,100,416 parameters), random bf16 weights from --seed,
     one prefill_32k step on 2 x 32,768 tokens and 128 sequences decoded
     for 288 steps as above, with tokens/s, ms a step, peak memory, each
     step's capacity C and each prefill layer's dropped share (through
     models.moe.route); it launches none of the eight kernels (the expert
     products are torch.bmm).  Outside that window: moe_ffn against a
     plain per-expert loop on layers 0 and 15's prefill inputs, the first
     two layers on the card against the CPU, and decode against prefill
     with nothing dropped (``moe: {...}`` before the card line).  Then
     flash_attention's own
     phase: its entry point once at zamba2-1.2b's shared attention, which
     must take the tensor-core route.  Then the LM training path, fed by
     the warehouse: an ACID corpus (2,048 documents of 256 tokens over
     mamba2-130m's vocabulary) read through batches_from_warehouse under
     ``engine: cuda`` (the SQL kernels' counters that rose printed, at
     least one required; the batches held to ``engine: auto``'s), then
     mamba2-130m at full width and depth trained for 6 steps of train_4k's
     length (its batch of 256 cut to 16) with make_train_step
     (microbatches 4, remat, the plain scan: no LM kernel launches under
     autograd), loss, grad norm and ms a step, tokens/s and peak memory
     printed, the loss required to fall; an async checkpoint of the
     weights and optimiser state restored bit-equal into a fresh model;
     one step on 1 x 512 tokens on the card against the CPU, and one step
     in each remat mode (none, per_period, sqrt) with its peak memory.
     Then the distributed layer (``distributed_phase``): an NCCL group of
     world size 1 (file store under build/) and a ("data",) mesh of 1, on
     SSB's columns as load_ssb draws them (lineorder --rows, --seed):
     the group sum of lo_revenue over the 2,556 dates (counts exact, sums
     within float32's bound), the shuffle join with customer (every row
     matched once, overflow 0, numpy's rows), the broadcast join with the
     dates (numpy's join, row for row), and the int8 compressed psum over
     a float32 tree of mamba2-130m's parameter shapes (payloads, scales and
     result bit-equal to the CPU's, within 2% of the plain all-reduce);
     ms a call (CUDA events, median of 5), rows/s and peak memory, and
     ``distributed: {...}`` before the card line; it launches none of the
     eight kernels (torch ops and collectives, as the JAX package computes
     them in jnp);
  5. load SSB (lineorder at SF1's 6,000,000 rows by default) and run the
     13 SSB queries plus KERNEL_QUERIES through repro_torch.api under
     ``engine: cuda`` and ``engine: auto`` (numpy host paths) on the same
     warehouse, under the default SQL configuration (semijoin reduction on,
     four shuffle lanes, no result cache); the row sets must agree and all
     six path kernels' launch counters (and hash_group_minmax's one-block
     path's and hash_group's morsel path's) must have risen.  Then the first
     slice's configuration (no semijoin reduction, one lane) runs as an
     earlier path over EARLIER_QUERIES on the same warehouse, and its four
     kernels' counters must have risen;
  6. print the launches by route and path, the ``kernels`` JSON line (all
     eight kernels), the training phase's numbers (``train: {...}``), the
     MoE phase's (``moe: {...}``), the distributed phase's
     (``distributed: {...}``), the card line, and last ``{"ok": true,
     "device": {...}}``.

``python3 -c 'import chip_smoke; chip_smoke.sql_kernels()'`` runs phases
1-3 for the six SQL kernels and their executor calls and stops with no
result line: a quick call after a change to an SQL kernel's body.

ssd_scan and flash_attention are checked and timed in phase 3 beside the
SQL kernels (their sweeps from the JAX package's tests, the path shapes,
and chunk 64 against 256).  ssd_scan's bound is the tighter of float32 on
the CUDA cores and its 3xTF32 split on the tensor cores (the products the
kernel runs); a line of its own gives both bounds, each pass's time (CUDA
events, each pass launched alone) and the bytes one call allocates
(torch.cuda.memory_allocated).  flash_attention's float32 route gets both
bounds the same way.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12     # H100 SXM dense TF32 on the tensor cores
# ssd_scan's products and those of flash_attention's float32 route on the
# tensor cores: each a sum of three TF32 products (hi*hi + hi*lo + lo*hi;
# csrc/ssd_scan.cu, csrc/flash_attention_tf32.cu; emulated in
# tests/test_torch_ssd_passes.py and tests/test_torch_flash_tf32.py)
TF32_TERMS = 3
BF16_OPS_PER_S = 989e12     # H100 SXM dense bfloat16 on the tensor cores
# the default SQL configuration, with the lane count pinned ("auto" follows
# the host's core count) and the result cache off so every query runs
CONFIG = {"result_cache": False, "shuffle.partitions": 4}
# the first slice's configuration, kept as an earlier path at less depth
EARLIER = {"semijoin_reduction": False, "result_cache": False,
           "shuffle.partitions": 1}
# k.int_agg alone reaches all four of that path's kernels
EARLIER_QUERIES = ("k.int_agg",)
LINEORDER_COLS = ("lo_orderkey", "lo_custkey", "lo_partkey", "lo_suppkey",
                  "lo_orderdate", "lo_quantity", "lo_extendedprice",
                  "lo_discount", "lo_revenue", "lo_supplycost")
PATH_KERNELS = ("filter_eval", "key_lookup", "hash_group",
                "hash_group_minmax", "hash_partition", "bloom_probe")
EARLIER_KERNELS = PATH_KERNELS[:4]
# the executor's pool (core/runtime/llap.py: LLAPDaemon's num_executors)
THREADS = 4
# the calls whose parts are timed, and the query profiled for them: it
# probes runtime filters on every lineorder stripe and joins three
# dimensions
PROFILED_KERNELS = ("key_lookup", "bloom_probe")
PROFILE_QUERY = "q2.1"
TOP_DEVICE_OPS = 10
GRAPH_REPLAYS = 10
# build-side uploads against launches on the path: far fewer (SSB at SF1
# has hundreds of stripes a query)
MORSELS_PER_UPLOAD = 10
# the LM side: ssd_scan on the serving path, flash_attention at its own
# entry point (no model path of the JAX package calls it)
LM_KERNELS = ("ssd_scan", "flash_attention")
REPLACES = {
    "filter_eval": "src/repro/kernels/filter_eval/filter_eval.py:45",
    "key_lookup": "src/repro/kernels/key_lookup/key_lookup.py:42",
    "hash_group": "src/repro/kernels/hash_group/hash_group.py:94",
    "hash_group_minmax": "src/repro/kernels/hash_group/hash_group.py:59",
    "hash_partition":
        "src/repro/kernels/hash_partition/hash_partition.py:56",
    "bloom_probe": "src/repro/kernels/bloom/bloom.py:38",
    "ssd_scan": "src/repro/kernels/ssd_scan/ssd_scan.py:63",
    "flash_attention":
        "src/repro/kernels/flash_attention/flash_attention.py:62",
}
SOURCES = {
    "filter_eval": "src/repro_torch/csrc/filter_eval.cu",
    "key_lookup": "src/repro_torch/csrc/key_lookup.cu",
    "hash_group": "src/repro_torch/csrc/hash_group.cu",
    "hash_group_minmax": "src/repro_torch/csrc/hash_group.cu",
    "hash_partition": "src/repro_torch/csrc/hash_partition.cu",
    "bloom_probe": "src/repro_torch/csrc/bloom_probe.cu",
    "ssd_scan": "src/repro_torch/csrc/ssd_scan.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention_wgmma.cu",
}
# flash_attention's routes (kernels/flash_attention/ops.py:route) and
# hash_group_minmax's paths (ops.py:minmax_path), each with its own count
FLASH_ROUTES = ("flash_attention.wgmma", "flash_attention.tf32x3",
                "flash_attention.simt")
MINMAX_PATHS = ("hash_group_minmax.one_block", "hash_group_minmax.multi_block")
# hash_group's paths (ops.py:group_path), each with its own count
GROUP_PATHS = ("hash_group.morsel", "hash_group.grid", "hash_group.global")
ROUTES = FLASH_ROUTES + MINMAX_PATHS + GROUP_PATHS
ROUTE_SOURCES = {
    "flash_attention.tf32x3": "src/repro_torch/csrc/flash_attention_tf32.cu",
    "flash_attention.simt": "src/repro_torch/csrc/flash_attention.cu",
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


def graph_ms(fn, reps: int = 100) -> float:
    """Mean ms per call of ``fn`` (a kernel's wrapper on card tensors)
    replayed from a CUDA graph of ``reps`` calls, by CUDA events: the
    card's time per launch without the host's issue time, which a loop of
    wrapper calls measures at the path's small shapes."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(GRAPH_REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (GRAPH_REPLAYS * reps)


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


def threaded_ms(fn, args, threads: int = THREADS, reps: int = 200) -> float:
    """Mean ms per call on each of ``threads`` threads calling ``fn`` at
    once (the executor's pool has THREADS), host clock."""
    start = threading.Barrier(threads)

    def run(_):
        for _ in range(3):
            fn(*args)
        start.wait()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(threads) as pool:
        spent = list(pool.map(run, range(threads)))
    return sum(spent) / threads * 1e3 / reps


def empty_call(x):
    """An empty kernel: ``x`` in, an int32 result of its length out,
    nothing computed."""
    from repro_torch.kernels import _build

    out = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    _build.check(_build.library().repro_empty_launch(_build.stream(out)),
                 "empty")
    return out


def empty_trip(device, x):
    """The empty kernel behind the executor's call on the card (the floor
    of a call): ``x`` up, the launch, as many int32 back, one trip."""
    from repro_torch.kernels import registry

    (out,) = registry.trip("repro_empty", device, [x],
                           [(np.int32, x.shape)], lambda i, o: ())
    return out


def round_trip_calls(rng) -> dict:
    """The executor's per-morsel kernel calls at the main path's shapes:
    kernel name -> (tensor function, arguments as the executor passes
    them).  The join dictionary and the runtime filter's bitset are
    build-side state, made once on the card (registry.upload), as
    _BuildTable and _KernelBloomProbe hold them."""
    from repro_torch.kernels import registry

    dev = torch.device("cuda")
    n = 1024
    codes = rng.integers(0, 7, n).astype(np.int32)
    vals = rng.integers(1, 50, n).astype(np.float32)
    calls = {
        "filter_eval": ((rng.integers(0, 50, n).astype(np.float32),),
                        (0,), (25.0,)),
        "key_lookup": (registry.upload(np.arange(2556, dtype=np.float32),
                                       dev, "key_lookup"),
                       rng.integers(0, 2556, n).astype(np.float32)),
        "hash_group": (codes, vals, 7),
        "hash_group_minmax": (codes, vals, 7),
        # one numeric shuffle key over four lanes, as SSB's aggregates have
        "hash_partition": ((rng.integers(0, 2556, n).astype(np.float32),),
                           4),
        # an 8192-row stripe against a 512-bit runtime filter, k = 6
        "bloom_probe": (rng.integers(0, 2**32, 8192, dtype=np.uint32),
                        rng.integers(0, 2**32, 8192, dtype=np.uint32),
                        registry.upload(rng.integers(0, 2**32, 16,
                                                     dtype=np.uint32),
                                        dev, "bloom_probe"), 6, 512),
    }
    return {k: (registry.resolve(k, "cuda"), args)
            for k, args in calls.items()}


def pageable_call(fn, dev):
    """``fn`` called through pageable torch copies, as host_call called
    every kernel before the trip and the yardstick of it: each array copied
    to the card by a synchronous copy from pageable memory on the calling
    thread's current stream, the result back by ``.cpu()``."""
    from repro_torch.kernels import registry

    return lambda *args: registry._to_host(fn(*registry._to_device(args,
                                                                   dev)))


def host_round_trips(rng) -> dict:
    """Each SQL kernel's executor call at the path's shapes on one thread
    and on THREADS threads at once, beside the empty kernel's call (the
    floor) and, for key_lookup, bloom_probe and the empty kernel, the
    pageable call (pageable_call) with the dictionary and bitset sent each
    call; and the split of key_lookup's and bloom_probe's call into its
    parts on one thread (PartClocks).  Returns {"1": {kernel: ms}, "4":
    {kernel: ms}, "pageable": {kernel: [ms on 1, on 4 threads]}, "split":
    ...}."""
    from repro_torch.kernels import registry

    dev = torch.device("cuda")
    calls = round_trip_calls(rng)
    registry.register_trip(empty_call, empty_trip)
    calls["empty"] = (empty_call, (rng.integers(0, 50, 1024)
                                   .astype(np.float32),))
    one, many = {}, {}
    for k, (fn, args) in calls.items():
        call = registry.host_call(fn, dev)
        one[k] = host_ms(call, args)
        many[k] = threaded_ms(call, args)
        print(f"  {k:18s} host round trip {one[k]:.4f} ms; "
              f"{THREADS} threads at once {many[k]:.4f} ms a call",
              flush=True)
    pageable = {}
    for k in PROFILED_KERNELS + ("empty",):
        fn, args = calls[k]
        args = tuple(a.cpu().numpy() if isinstance(a, torch.Tensor) else a
                     for a in args)
        call = pageable_call(fn, dev)
        pageable[k] = [host_ms(call, args), threaded_ms(call, args)]
        print(f"  {k:18s} pageable call (torch copies, build-side state "
              f"sent each call) {pageable[k][0]:.4f} ms; {THREADS} threads "
              f"at once {pageable[k][1]:.4f} ms a call", flush=True)
    with PartClocks() as clocks:
        for k in PROFILED_KERNELS:
            fn, args = calls[k]
            host_ms(clocks.outer(k, registry.host_call(fn, dev)), args)
    split = clocks.means()
    print("  alone, one thread: " + clocks.line(split), flush=True)
    return {"1": one, str(THREADS): many, "pageable": pageable,
            "split": split}


class PartClocks:
    """Host time of the parts of the executor's key_lookup and bloom_probe
    calls, on the host clock, while in a ``with`` block.  It wraps the
    registry's one native call that stages the morsel, copies it in,
    launches, copies the results back, synchronises and copies them out
    (``_run``, the trip), and, inside ``_BuildTable._lookup`` and
    ``_KernelBloomProbe.might_contain``, the whole call; what the trip
    leaves of the call is the executor's own work around it (the float32
    cast and round-trip test, the hashing, the kernel's resolution, the
    trip's arguments).  Only calls that made a trip are counted."""

    PARTS = ("call", "trip")

    def __init__(self):
        self._sums = {k: dict.fromkeys(self.PARTS + ("calls",), 0.0)
                      for k in PROFILED_KERNELS}
        self._lock = threading.Lock()
        self._local = threading.local()
        self._undo = []

    def _part(self, part, fn):
        """``fn`` timed as ``part``; a call of it made inside another (a
        function that recurses through its module's name) counts once."""
        local = self._local

        def timed(*a, **kw):
            depth = getattr(local, "depth", None)
            if depth is None:
                depth = local.depth = {}
            if depth.get(part, 0):
                return fn(*a, **kw)
            depth[part] = 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                depth[part] = 0
                parts = getattr(local, "parts", None)
                if parts is not None:
                    parts[part] = parts.get(part, 0.0) + \
                        time.perf_counter() - t0
        return timed

    def outer(self, kernel, fn):
        """``fn`` timed as one whole call of ``kernel``."""
        local = self._local

        def whole(*a, **kw):
            local.parts, local.launched = {}, False
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                dt = time.perf_counter() - t0
                if local.launched:
                    with self._lock:
                        sums = self._sums[kernel]
                        sums["call"] += dt
                        sums["calls"] += 1
                        for part, v in local.parts.items():
                            sums[part] += v
                local.parts = None
        return whole

    def _patch(self, owner, name, value):
        self._undo.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, value)

    def __enter__(self):
        from repro_torch.core.runtime import exec as ex
        from repro_torch.kernels import registry

        timed_run = self._part("trip", registry._run)

        def run(*a, **kw):
            self._local.launched = True
            return timed_run(*a, **kw)

        self._patch(registry, "_run", run)
        self._patch(ex._BuildTable, "_lookup",
                    self.outer("key_lookup", ex._BuildTable._lookup))
        self._patch(ex._KernelBloomProbe, "might_contain",
                    self.outer("bloom_probe",
                               ex._KernelBloomProbe.might_contain))
        return self

    def __exit__(self, *exc):
        for owner, name, value in reversed(self._undo):
            setattr(owner, name, value)
        self._undo.clear()
        return False

    def means(self) -> dict:
        """kernel -> {"calls": n, part: mean ms per call, "rest": ms}."""
        out = {}
        for k, sums in self._sums.items():
            n = int(sums["calls"])
            row = {"calls": n}
            for part in self.PARTS:
                row[part] = sums[part] * 1e3 / n if n else None
            if n:
                row["rest"] = row["call"] - sum(
                    row[p] for p in self.PARTS[1:])
            out[k] = row
        return out

    @staticmethod
    def line(means: dict) -> str:
        return "; ".join(
            f"{k}: {row['calls']} calls, " + ", ".join(
                f"{p} {row[p]:.4f}" for p in PartClocks.PARTS + ("rest",)
                if row.get(p) is not None) + " ms"
            for k, row in means.items())


def device_profile(run) -> dict:
    """torch.profiler (CPU and CUDA activities, no stacks or shapes) over
    ``run()``: the device's busy share of the window (the union of the
    device's kernel and copy intervals over the span from the first to
    the last event), and device time by operation name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=False, with_stack=False) as prof:
        run()
        torch.cuda.synchronize()
    events = list(prof.events())
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    window = (max(e for _, e in spans) - min(s for s, _ in spans)
              if spans else 0.0)
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    by_name = {}
    for s, e, name in dev:
        if e > end:
            busy += e - max(s, end)
            end = e
        total, count = by_name.get(name, (0.0, 0))
        by_name[name] = (total + e - s, count + 1)
    return {"window_ms": window / 1e3, "busy_ms": busy / 1e3,
            "busy_share": busy / window if window else None,
            "device_events": len(dev), "host_events": len(events) - len(dev),
            "by_name": by_name}


def profile_path(db, wh, cfg: dict, name: str, sql: str,
                 isolated: dict) -> dict:
    """``name`` under ``engine: cuda`` twice: under torch.profiler (the
    device's busy share and its top operations), then under PartClocks
    (the split of each key_lookup and bloom_probe call); the split is set
    beside the one-thread split of the same calls alone (``isolated``),
    and what the path adds to copy back and synchronise is time spent
    waiting on the other threads' work."""
    with db.connect(warehouse=wh, engine="cuda", **cfg) as conn:
        prof = device_profile(lambda: rows_of(conn.execute(sql)))
        print(f"profile of {name} under cuda (torch.profiler, CPU and CUDA "
              f"activities): window {prof['window_ms']:.1f} ms, "
              f"{prof['host_events']} host events, {prof['device_events']} "
              f"device events", flush=True)
        if prof["device_events"]:
            print(f"  device busy {prof['busy_ms']:.2f} ms, share "
                  f"{prof['busy_share']:.5f} of the window", flush=True)
            top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1][0])
            for op, (us, count) in top[:TOP_DEVICE_OPS]:
                print(f"  device op {us / 1e3:10.3f} ms {count:7d} x "
                      f"{us / count:8.2f} us  {op}", flush=True)
        else:
            print("  the profiler recorded no device time: busy share not "
                  "measured; the parts below are host clocks", flush=True)
        with PartClocks() as clocks:
            t0 = time.perf_counter()
            rows_of(conn.execute(sql))
            wall = (time.perf_counter() - t0) * 1e3
    path = clocks.means()
    print(f"  {name} under PartClocks {wall:.1f} ms; on the path: "
          + clocks.line(path), flush=True)
    for k in PROFILED_KERNELS:
        if path[k]["calls"] and isolated[k]["calls"]:
            wait = path[k]["trip"] - isolated[k]["trip"]
            print(f"  {k}: the trip (copy in, launch, copy back, "
                  f"synchronise) {path[k]['trip']:.4f} ms on the path "
                  f"against {isolated[k]['trip']:.4f} ms alone: "
                  f"{wait:.4f} ms waiting on other threads' work",
                  flush=True)
    return {"profile": {k: v for k, v in prof.items() if k != "by_name"},
            "split": path}


def tensor_core_report(lib, log: str) -> None:
    """ptxas's registers, shared memory and spills for the tensor-core
    kernels, and their tensor-core instructions in the SASS of each
    instantiation: HGMMA (wgmma) in flash_attention_wgmma.cu and
    flash_attention_tf32.cu, HMMA (mma.sync) in ssd_scan.cu's chunk_state,
    bmm and chunk_scan passes; fails when there are none."""
    for source in ("flash_attention_wgmma.cu", "flash_attention_tf32.cu",
                   "ssd_scan.cu"):
        part = log.split(f"== {source}", 1)[1].split("\n== ", 1)[0]
        print(f"{source}, ptxas -v:", flush=True)
        for line in part.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print("  " + line.split("ptxas info    : ", 1)[-1].strip(),
                      flush=True)
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        cuda_home, "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    for kernels, op in ((("flash_wgmma_kernel", "flash_tf32_kernel"),
                         "HGMMA"),
                        (("chunk_state_kernel", "bmm_kernel",
                          "chunk_scan_kernel"), "HMMA")):
        counts = {}
        for fn in sass.split("Function : ")[1:]:
            name, body = fn.split("\n", 1)
            if any(k in name for k in kernels):
                counts[name.strip()] = sum(f" {op}." in ln
                                           for ln in body.splitlines())
        print(f"  {op} instructions in the SASS: {counts}", flush=True)
        assert len(counts) >= 2 * len(kernels) and \
            all(c > 0 for c in counts.values()), counts


def atomics_report(lib) -> None:
    """The atomic instructions in the SASS of hash_group's kernels: a float
    atomicAdd on shared memory compiles to a compare-and-swap loop
    (ATOMS.CAST.SPIN) on this card, the counts' increments to ATOMS.POPC.INC
    (one a warp)."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        cuda_home, "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    print("hash_group's atomics in the SASS:", flush=True)
    for fn in sass.split("Function : ")[1:]:
        name, body = fn.split("\n", 1)
        if "group_grid" in name or "group_morsel" in name:
            ops = {}
            for ln in body.splitlines():
                for word in ln.split():
                    if word.startswith(("ATOMS", "ATOM.", "RED.")):
                        ops[word.rstrip(";")] = ops.get(word.rstrip(";"),
                                                        0) + 1
            print(f"  {name.strip()}: {ops}", flush=True)


def bound_ms(nbytes: float, ops: float, peak: float = FP32_OPS_PER_S) -> tuple:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version on the card
# ---------------------------------------------------------------------------
def check_kernels(dev, rng, lm: bool = True) -> dict:
    from repro_torch.kernels.filter_eval.ops import filter_eval_cuda
    from repro_torch.kernels.filter_eval.ref import filter_eval_ref
    from repro_torch.kernels.hash_group.ops import (hash_group_cuda,
                                                    hash_group_minmax_cuda)
    from repro_torch.kernels.hash_group.ref import (hash_group_minmax_ref,
                                                    hash_group_ref)
    from repro_torch.kernels.key_lookup.ops import key_lookup_cuda
    from repro_torch.kernels.key_lookup.ref import key_lookup_ref

    err = {k: 0.0 for k in PATH_KERNELS + LM_KERNELS}
    timed = {}

    def t(a):
        return torch.as_tensor(a, device=dev)

    def record(name, shape, reps, kern, plain, lib, nbytes, ops, main,
               peak=FP32_OPS_PER_S, key=None):
        ms, pms = time_ms(kern, reps), time_ms(plain, reps)
        lms = time_ms(lib, reps) if lib is not None else None
        bms, by = bound_ms(nbytes, ops, peak)
        row = {"shape": shape, "ms": ms, "plain_ms": pms, "library_ms": lms,
               "bound_ms": bms, "bound_by": by}
        if name in PATH_KERNELS:
            row["graph_ms"] = graph_ms(kern)
        print(f"  {name:18s} {shape:22s} kernel {ms:.4f} ms  plain "
              f"{pms:.4f} ms  library {'-' if lms is None else f'{lms:.4f}'}"
              f" ms  bound {bms:.6f} ms ({by})"
              + (f"  from a CUDA graph {row['graph_ms']:.4f} ms"
                 if "graph_ms" in row else ""), flush=True)
        if key is not None:
            timed[key] = row
        elif main:
            timed[name] = row
        else:
            timed.setdefault(name + "@large", row)
        return row

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

    # filter_eval on views at offsets 0-3, alike and mixed (the kernel's
    # head, four-row body and tail, or one row a thread), n not a multiple
    # of 4, K 1-8, all six ops, NaN and -0.0 among the values: bit-exact
    n = 100_003
    for k in range(1, 9):
        bases = [_with_specials(rng.integers(-3, 4, n + 4).astype(np.float32),
                                rng) for _ in range(k)]
        ops = tuple((k + i) % 6 for i in range(k))
        lits = tuple([0.0, -0.0, 1.0, 2.0, -1.0, 0.0, 3.0, -2.0][:k])
        for offsets in [(o,) * k for o in range(4)] + [
                tuple(i % 4 for i in range(k))]:
            cols = [t(b)[o:o + n] for b, o in zip(bases, offsets)]
            got = filter_eval_cuda(cols, ops, lits)
            exp = filter_eval_ref(cols, ops, lits)
            torch.cuda.synchronize()
            assert torch.equal(got, exp), \
                f"filter_eval K={k} offsets {offsets}: rows differ"

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
    # float sums at atol 1e-3 (the paths without a fixed order add with
    # atomics; check_group_paths holds the morsel path to its order's bits)
    for g, n, main in ((1, 1024, False), (7, 1024, True), (640, 1024, False),
                       (3000, 1024, False), (6144, 1024, False),
                       (8000, 1024, False), (3000, 4_000_000, False),
                       (8000, 4_000_000, False)):
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
            # G 8,000 at 4M rows: the grid path's shared-memory copy, which
            # the 48 KB limit kept from it before
            big = g == 8000 and n > 1024
            record("hash_group", f"G={g} n={n}", reps,
                   lambda: hash_group_cuda(codes, fvals, g),
                   lambda: hash_group_ref(codes, fvals, g),
                   lambda: (torch.bincount(safe, weights=wsum, minlength=g),
                            torch.bincount(safe, weights=wcnt, minlength=g)),
                   8 * n + 8 * g, 2 * n, main,
                   key="hash_group@G8000 large" if big else None)
            record("hash_group_minmax", f"G={g} n={n}", reps,
                   lambda: hash_group_minmax_cuda(codes, fvals, g),
                   lambda: hash_group_minmax_ref(codes, fvals, g),
                   lambda: (lo.scatter_reduce(0, kcodes, kvals, "amin"),
                            hi.scatter_reduce(0, kcodes, kvals, "amax")),
                   8 * n + 8 * g, 2 * n, main,
                   key="hash_group_minmax@G8000 large" if big else None)

    check_group_paths(t, rng)
    check_minmax_paths(t, rng)
    check_hash_partition(t, rng, err, record)
    check_bloom_probe(t, rng, err, record)
    if lm:
        check_ssd_scan(t, rng, err, record)
        check_flash_attention(dev, rng, err, record)
    return {"err": err, "timed": timed}


def check_group_paths(t, rng) -> None:
    """hash_group's morsel and grid paths: at the SQL path's shape (G 7, n
    1,024) the wrapper's sums equal the CPU emulation of the morsel path's
    order (kernels/hash_group/order.py) bit for bit, in each of 100 calls,
    and each call moves the morsel path's count alone; both paths equal the
    plain version (integer sums and counts exactly) and are timed against
    each other, from a loop of launches and from a CUDA graph, at G 7, 640
    and 1,800 (the morsel path's most) from 1,024 to 65,536 rows; either
    side of each limit the wrapper's call is exact and counted on its path;
    the grid path at 4M rows; the wrapper's copy of the kernel's limits
    equals the built kernel's."""
    from repro_torch.kernels import registry
    from repro_torch.kernels.hash_group.ops import (SMEM_GROUPS,
                                                    WARP_COPY_GROUPS,
                                                    _prepare, group_path,
                                                    hash_group_cuda,
                                                    kernel_limits,
                                                    launch_group, limits,
                                                    morsel_rows)
    from repro_torch.kernels.hash_group.order import morsel_order
    from repro_torch.kernels.hash_group.ref import hash_group_ref

    assert limits() == kernel_limits(), (limits(), kernel_limits())
    print(f"  hash_group         limits as built: {kernel_limits()}",
          flush=True)
    codes = rng.integers(-1, 10, 1024).astype(np.int32)
    vals = rng.normal(size=1024).astype(np.float32)
    want = morsel_order(torch.from_numpy(codes), torch.from_numpy(vals), 7)
    tc, tv = t(codes), t(vals)
    before = registry.launch_counts()
    for _ in range(100):
        s, c = hash_group_cuda(tc, tv, 7)
        assert torch.equal(s.cpu().view(torch.int32),
                           want[0].view(torch.int32)), \
            "hash_group at G=7 n=1024: sums differ from the morsel order"
        assert torch.equal(c.cpu(), want[1])
    after = registry.launch_counts()
    moved = {k: after.get(k, 0) - before.get(k, 0) for k in GROUP_PATHS}
    assert moved == {"hash_group.morsel": 100, "hash_group.grid": 0,
                     "hash_group.global": 0}, moved
    print("  hash_group         G=7 n=1024: 100 calls, each the morsel "
          "order's bits", flush=True)
    # either side of each limit: integer sums and counts exact, one count of
    # the path's own
    for n, g in ((1024, 32), (1024, 33), (1024, 6144), (1024, 6145),
                 (1024, WARP_COPY_GROUPS), (1024, WARP_COPY_GROUPS + 1),
                 (1024, SMEM_GROUPS), (1024, SMEM_GROUPS + 1),
                 (morsel_rows(7), 7), (morsel_rows(7) + 1, 7),
                 (morsel_rows(33), 33), (morsel_rows(33) + 1, 33),
                 (100_003, SMEM_GROUPS), (100_003, SMEM_GROUPS + 1)):
        codes = t(rng.integers(-1, g + 3, n).astype(np.int32))
        ints = t(rng.integers(-3, 50, n).astype(np.float32))
        path = f"hash_group.{group_path(n, g)}"
        before = registry.launch_counts().get(path, 0)
        got = hash_group_cuda(codes, ints, g)
        assert registry.launch_counts()[path] == before + 1, (n, g, path)
        exp = hash_group_ref(codes, ints, g)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, exp)), (n, g)
    for g, n in [(g, n) for n in (1024, 2048, 4096, 8192, 16384, 65536)
                 for g in (7, 640, WARP_COPY_GROUPS)]:
        ints = t(rng.integers(-3, 50, n).astype(np.float32))
        codes, vals = _prepare(t(rng.integers(-1, g, n).astype(np.int32)),
                               ints, g)
        exp = torch.stack(hash_group_ref(codes, vals, g))
        ms = {}
        for path in ("morsel", "grid"):
            got = launch_group(codes, vals, g, path)
            torch.cuda.synchronize()
            assert torch.equal(got, exp), f"hash_group {path} G={g} n={n}"
            run = lambda path=path: launch_group(codes, vals, g, path)  # noqa: E731
            ms[path] = (time_ms(run, 200), graph_ms(run))
        print(f"  hash_group         paths at G={g} n={n}: " + ", ".join(
            f"{p} {a:.4f} ms (graph {b:.4f})" for p, (a, b) in ms.items())
            + f"; the wrapper takes {group_path(n, g)} (up to "
            f"{morsel_rows(g)} rows the morsel path)", flush=True)
    # the grid path at 4M rows: 7 groups in registers (no atomics), 3,000
    # and 8,000 in a shared copy per block
    for g in (7, 3000, 8000):
        n = 4_000_000
        codes = t(rng.integers(-1, g, n).astype(np.int32))
        ints = t(rng.integers(-3, 4, n).astype(np.float32))
        exp = torch.stack(hash_group_ref(codes, ints, g))
        got = launch_group(codes, ints, g, "grid")
        torch.cuda.synchronize()
        assert torch.equal(got, exp), f"hash_group grid G={g} n={n}"
        ms = graph_ms(lambda: launch_group(codes, ints, g, "grid"))
        print(f"  hash_group         grid path at G={g} n={n}, from a CUDA "
              f"graph: {ms:.4f} ms (bound "
              f"{bound_ms(8 * n + 8 * g, 2 * n)[0]:.4f} ms)", flush=True)


def check_minmax_paths(t, rng) -> None:
    """hash_group_minmax's two paths, bit-exact against the plain version
    and timed against each other at the SQL path's 1,024-row morsel and at
    the one-block limit (ONE_BLOCK_ROWS) and four times it; the wrapper's
    call at the morsel makes one launch, through the one-block path."""
    from repro_torch.kernels import registry
    from repro_torch.kernels.hash_group.ops import (ONE_BLOCK_ROWS, _prepare,
                                                    hash_group_minmax_cuda,
                                                    launch_minmax,
                                                    minmax_path)
    from repro_torch.kernels.hash_group.ref import hash_group_minmax_ref

    for n in (1024, ONE_BLOCK_ROWS, 4 * ONE_BLOCK_ROWS):
        codes, vals = _prepare(t(rng.integers(-1, 7, n).astype(np.int32)),
                               t(rng.normal(size=n).astype(np.float32)), 7)
        exp = torch.stack(hash_group_minmax_ref(codes, vals, 7))
        ms = {}
        for path in ("one_block", "multi_block"):
            got = launch_minmax(codes, vals, 7, path)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int32), exp.view(torch.int32)), \
                f"hash_group_minmax {path} n={n}: differs"
            ms[path] = time_ms(lambda: launch_minmax(codes, vals, 7, path),
                               200)
        print(f"  hash_group_minmax  paths at G=7 n={n}: one_block "
              f"{ms['one_block']:.4f} ms, multi_block {ms['multi_block']:.4f}"
              f" ms; the wrapper takes {minmax_path(n, 7)} "
              f"(ONE_BLOCK_ROWS {ONE_BLOCK_ROWS})", flush=True)
        if n == 1024:
            before = registry.launch_counts()
            hash_group_minmax_cuda(codes, vals, 7)
            after = registry.launch_counts()
            moved = {k: after.get(k, 0) - before.get(k, 0)
                     for k in MINMAX_PATHS}
            assert moved == {"hash_group_minmax.one_block": 1,
                             "hash_group_minmax.multi_block": 0}, moved


def _with_specials(col, rng):
    """Put -0.0, +0.0, NaN and -NaN (NULL keys) at random rows."""
    n = len(col)
    for v in (-0.0, 0.0, np.float32(np.nan), -np.float32(np.nan)):
        col[rng.integers(0, n, max(1, n // 64))] = v
    return col


def check_hash_partition(t, rng, err, record):
    """Bit-exact against the plain version and the numpy host path."""
    from repro_torch.core.runtime.shuffle import partition_codes
    from repro_torch.core.runtime.vector import VectorBatch
    from repro_torch.kernels.hash_partition.ops import hash_partition_cuda
    from repro_torch.kernels.hash_partition.ref import hash_partition_ref

    for n in (1024, 8192, 4_000_000):
        for k in (1, 2, 3, 8):
            keys = [_with_specials(
                rng.integers(-5000, 5000, n).astype(np.float32) if i % 2 == 0
                else rng.normal(size=n).astype(np.float32), rng)
                for i in range(k)]
            batch = VectorBatch({f"k{i}": c for i, c in enumerate(keys)})
            cols = [t(c) for c in keys]
            for p in (4, 8):
                got = hash_partition_cuda(cols, p)
                exp = hash_partition_ref(cols, p)
                host = partition_codes(batch, list(batch.cols), p, "auto")
                torch.cuda.synchronize()
                bad = int((got != exp).sum())
                bad_host = int((got.cpu().numpy() != host).sum())
                assert bad == 0 and bad_host == 0, \
                    (f"hash_partition n={n} K={k} P={p}: {bad} rows differ "
                     f"from the plain version, {bad_host} from the host path")
            main = (n, k) == (1024, 1)
            if main or (n, k) == (4_000_000, 3):
                record("hash_partition", f"n={n} K={k} P=4",
                       200 if n <= 8192 else 20,
                       lambda: hash_partition_cuda(cols, 4),
                       lambda: hash_partition_ref(cols, 4), None,
                       4 * k * n + 4 * n, n * (3 * k + 8), main)


def check_bloom_probe(t, rng, err, record):
    """Bit-exact against the plain version and BloomFilter.might_contain;
    2**20 bits takes the kernel's device-memory branch."""
    from repro_torch.core.bloomfilter import BloomFilter, hash_values
    from repro_torch.kernels.bloom.ops import bloom_probe_cuda
    from repro_torch.kernels.bloom.ref import bloom_probe_ref

    cases = [(64, 6, 5, 8192), (512, 6, 60, 8192), (32768, 6, 4000, 8192),
             (1 << 20, 6, 100_000, 8192), (32768, 6, 4000, 4_000_000)]
    cases += [(4096, k, 400, 8192) for k in (1, 2, 3, 4, 5, 7, 8)]
    for num_bits, k, members, n in cases:
        space = 4 * members + 1000
        bf = BloomFilter(num_bits, k)
        bf.add(rng.integers(0, space, members))
        queries = rng.integers(0, space, n)
        h = hash_values(queries)
        h1 = t((h & np.uint64(0xFFFFFFFF)).astype(np.uint32))
        h2 = t((h >> np.uint64(32)).astype(np.uint32))
        bits = t(bf.bits.view(np.uint32))
        got = bloom_probe_cuda(h1, h2, bits, k, num_bits)
        exp = bloom_probe_ref(h1, h2, bits, k, num_bits)
        host = bf.might_contain(queries)
        torch.cuda.synchronize()
        bad = int((got != exp).sum())
        bad_host = int((got.cpu().numpy() != host).sum())
        assert bad == 0 and bad_host == 0, \
            (f"bloom_probe bits={num_bits} k={k} n={n}: {bad} rows differ "
             f"from the plain version, {bad_host} from might_contain")
        main = (num_bits, n) == (512, 8192)
        if main or n > 8192:
            record("bloom_probe", f"n={n} bits={num_bits} k={k}",
                   200 if n <= 8192 else 20,
                   lambda: bloom_probe_cuda(h1, h2, bits, k, num_bits),
                   lambda: bloom_probe_ref(h1, h2, bits, k, num_bits), None,
                   9 * n + num_bits // 8, 5 * k * n, main)


# the JAX package's sweeps (tests/test_kernels.py:43-44, 60-61)
SSD_SWEEP = [(1, 32, 2, 8, 4, 8), (2, 64, 3, 16, 8, 16),
             (1, 128, 4, 32, 16, 32), (2, 96, 2, 8, 8, 48)]
FLASH_SWEEP = [(1, 1, 64, 16), (2, 3, 128, 32), (2, 2, 256, 64),
               (1, 4, 96, 8)]
# path shapes: mamba2-130m's heads (B, H, P, chunk) at the lengths below
# (decay 6: its strongest decays; the last, the prefill's own length), and
# zamba2-1.2b's shared attention (B, H, S, d) in bfloat16
SSD_PATH = (2, 24, 64, 256)  # B, H, P, chunk
# (S, N, decay, timed row): mamba2-130m's d_state 128, and 64 (zamba2-1.2b's)
SSD_LENGTHS = ((4096, 128, 6.0, None), (4096, 128, 0.2, "ssd_scan"),
               (32768, 128, 0.2, "ssd_scan@large"), (4096, 64, 6.0, None),
               (4096, 64, 0.2, "ssd_scan@N64"),
               (32768, 64, 0.2, "ssd_scan@N64 large"))
FLASH_PATH = (2, 32, 4096, 64)
# ssd_scan: the JAX sweep's tolerance (float32 sums in another order)
SSD_TOL = {"atol": 5e-5, "rtol": 1e-3}
# ssd_scan inside the model: its outputs are far smaller than the sweep's
# (largest |y| about 2e-3, median about 2e-5 at mamba2-130m's random
# weights), so the absolute part is scaled to the plain output's largest
# magnitude; chunk 64 against chunk 256 differs by about 1e-5 of it
SSD_MODEL_TOL = {"atol_of_max": 1e-3, "rtol": 1e-3}
# flash_attention, elementwise |got - exp| <= atol + rtol |exp|.  float32:
# the JAX sweep's 3e-5.  bfloat16: both versions sum in float32 and round
# once, so they differ by at most one bfloat16 step of the output (at most
# 2^-7 of |exp|) beside float32 noise; the JAX sweep's 3e-2 stays a cap.
# At zamba2-1.2b's S = 4096 a typical |out| is about 0.03, so 3e-2 alone
# would be as large as what it compares; one step there is about 1e-4.
FLASH_TOL = {torch.float32: {"atol": 3e-5, "rtol": 0.0},
             torch.bfloat16: {"atol": 1e-4, "rtol": 2 ** -7}}
FLASH_CAP = 3e-2


def ssd_arrays(t, rng, B, S, H, P, N, decay=0.2):
    """The JAX sweep's inputs: x * 0.1, dA = -|n| * decay, B and C * 0.3;
    decay 6 gives mamba2-130m's strongest decays (dt near 0.4-1.3 times
    A down to -16)."""
    x = rng.normal(size=(B, S, H, P)).astype(np.float32) * 0.1
    dA = -np.abs(rng.normal(size=(B, S, H)).astype(np.float32)) * decay
    Bm = rng.normal(size=(B, S, N)).astype(np.float32) * 0.3
    Cm = rng.normal(size=(B, S, N)).astype(np.float32) * 0.3
    return [t(a) for a in (x, dA, Bm, Cm)]


def ssd_cost(B, S, H, P, N, Q) -> tuple:
    """(bytes, operations) of one scan: each input read once, y written
    once; the causal work the function needs: per chunk, the Q(Q+1)/2
    pairs j <= i of C_i.B_j (2N each), once, since B and C are shared by
    the heads; per chunk and head, those pairs of L x (2P each), then
    C state^T and the state update (2QNP each).  The JAX kernel computes
    the full Q x Q square for every head."""
    nbytes = 4 * (2 * B * S * H * P + B * S * H + 2 * B * S * N)
    nc = S // Q
    ops = B * nc * Q * (Q + 1) * N + \
        B * H * nc * (Q * (Q + 1) * P + 4 * Q * N * P)
    return nbytes, ops


def check_ssd_scan(t, rng, err, record):
    """Against the plain version on the sweep, at the path's head shape
    (mamba2-130m: H 24, P 64, N 128, chunk 256; and N 64) with weak and
    strong decays, chunk 64 against 256, and at the prefill's own length.
    The timed rows' bound is the tighter of float32 on the CUDA cores and
    the 3xTF32 split on the tensor cores; a line each gives both bounds,
    each pass's time and the bytes a call allocates."""
    from repro_torch.kernels.ssd_scan.ops import (PASSES, buffers,
                                                  launch_pass, scratch_bytes,
                                                  ssd_scan_cuda)
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    def compare(label, got, exp):
        torch.cuda.synchronize()
        e = float((got - exp).abs().max())
        assert torch.allclose(got, exp, **SSD_TOL), \
            f"ssd_scan {label}: max error {e} beyond {SSD_TOL}"
        err["ssd_scan"] = max(err["ssd_scan"], e)

    for B, S, H, P, N, Q in SSD_SWEEP:
        a = ssd_arrays(t, rng, B, S, H, P, N)
        compare(f"sweep {(B, S, H, P, N, Q)}", ssd_scan_cuda(*a, chunk=Q)[0],
                ssd_scan_ref(*a, chunk=Q))
    split_peak = TF32_OPS_PER_S / TF32_TERMS
    B, H, P, Q = SSD_PATH
    for S, N, decay, key in SSD_LENGTHS:
        a = ssd_arrays(t, rng, B, S, H, P, N, decay)
        y = ssd_scan_cuda(*a, chunk=Q)[0]
        assert torch.isfinite(y).all(), f"ssd_scan S={S} N={N}: not finite"
        compare(f"S={S} N={N} decay {decay}", y, ssd_scan_ref(*a, chunk=Q))
        compare(f"S={S} N={N} decay {decay} chunk 64 vs 256",
                ssd_scan_cuda(*a, chunk=64)[0], y)
        if key is None:
            continue
        reps = 10 if S <= 4096 else 5
        nbytes, ops = ssd_cost(B, S, H, P, N, Q)
        row = record("ssd_scan", f"B={B} S={S} H={H} P={P} N={N} Q={Q}",
                     reps, lambda: ssd_scan_cuda(*a, chunk=Q),
                     lambda: ssd_scan_ref(*a, chunk=Q), None, nbytes, ops,
                     key == "ssd_scan", peak=max(FP32_OPS_PER_S, split_peak),
                     key=key)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        y = ssd_scan_cuda(*a, chunk=Q)[0]
        torch.cuda.synchronize()
        allocated = torch.cuda.max_memory_allocated() - base
        del y
        bufs = buffers(a[0], a[2], Q)
        passes = {name: time_ms(
            lambda name=name: launch_pass(name, *a, bufs, Q), reps)
            for name in PASSES}
        del bufs
        scratch = scratch_bytes(B, S, H, P, N, Q)
        assert allocated >= scratch, (allocated, scratch)
        print(f"  ssd_scan           {key}: passes " + ", ".join(
            f"{k} {v:.4f}" for k, v in passes.items()) + " ms; bounds: "
            f"float32 {bound_ms(nbytes, ops)[0]:.4f} ms, {TF32_TERMS}xTF32"
            f" {bound_ms(nbytes, ops, split_peak)[0]:.4f} ms; "
            f"{ops / row['ms'] / 1e9:.1f} TFLOP/s of needed work; a call "
            f"allocates {allocated:,} bytes (scratch {scratch:,} beside y)",
            flush=True)


def check_flash_attention(dev, rng, err, record):
    """Against the plain version on the sweep (causal and full), at head
    dims 64, 128, 256, and at zamba2-1.2b's shared attention (B 2, H 32,
    S 4096, d 64) in bfloat16 and in float32, beside one SDPA call (library
    time only).  Each call through the wrapper must move its route's
    counter alone: every float32 case with d a multiple of 8 up to 128 the
    tf32x3 route's."""
    import torch.nn.functional as F
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash_attention.ops import (flash_attention_cuda,
                                                         launch_route, route)
    from repro_torch.kernels.flash_attention.ref import attention_ref

    def arrays(shape, dtype):
        return [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                .to(dev, dtype) for _ in range(3)]

    def check(q, k, v, causal, label):
        """The wrapper's call, its route's count and its error."""
        bq = 32 if q.shape[2] % 32 == 0 else q.shape[2]
        before = registry.launch_counts()
        got = flash_attention_cuda(q, k, v, causal=causal, block_q=bq,
                                   block_k=bq)
        after = registry.launch_counts()
        moved = {r: after.get(r, 0) - before.get(r, 0) for r in FLASH_ROUTES}
        want = f"flash_attention.{route(q.dtype, q.shape[3])}"
        assert moved == {r: int(r == want) for r in FLASH_ROUTES}, \
            (label, moved)
        exp = attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        e = float((got.float() - exp.float()).abs().max())
        assert got.dtype == q.dtype and e <= FLASH_CAP and torch.allclose(
            got.float(), exp.float(), **FLASH_TOL[q.dtype]), \
            f"flash_attention {label}: max error {e} beyond " \
            f"{FLASH_TOL[q.dtype]}"
        err["flash_attention"] = max(err["flash_attention"], e)
        return exp

    cases = [(s, dt, c) for s in FLASH_SWEEP
             for dt in (torch.float32, torch.bfloat16) for c in (True, False)]
    cases += [((2, 4, 512, d), dt, c) for d in (64, 128, 256)
              for dt in (torch.float32, torch.bfloat16) for c in (True, False)]
    # the tensor-core routes' head dims (bf16 48 and 96, float32 8, 40 and
    # 72 pad to their tiles) at lengths on and off their 32-, 64- and
    # 128-row tiles
    cases += [((2, 3, s, d), torch.bfloat16, c)
              for d in (16, 32, 48, 64, 96, 128)
              for s in (64, 96, 128, 256) for c in (True, False)]
    cases += [((2, 3, s, d), torch.float32, c) for d in (8, 40, 64, 72, 128)
              for s in (96, 256) for c in (True, False)]
    before = registry.launch_counts()
    for shape, dtype, causal in cases:
        check(*arrays(shape, dtype), causal,
              f"{shape} {dtype} causal={causal}")
    after = registry.launch_counts()
    moved = {r: after.get(r, 0) - before.get(r, 0) for r in FLASH_ROUTES}
    tf32 = sum(dt == torch.float32 and route(dt, sh[3]) == "tf32x3"
               for sh, dt, _ in cases)
    assert moved["flash_attention.tf32x3"] == tf32 > 0, moved
    print(f"  flash_attention    {len(cases)} cases, {tf32} of them float32 "
          f"with d a multiple of 8 up to 128; launches by route: {moved}",
          flush=True)
    B, H, S, d = FLASH_PATH
    q, k, v = arrays(FLASH_PATH, torch.bfloat16)
    assert route(q.dtype, d) == "wgmma"
    exp = check(q, k, v, True, f"{FLASH_PATH} bf16")
    ops = 2 * 2 * B * H * S * S * d / 2
    row = record("flash_attention", f"B={B} H={H} S={S} d={d} bf16 causal",
                 10, lambda: flash_attention_cuda(q, k, v),
                 lambda: attention_ref(q, k, v),
                 lambda: F.scaled_dot_product_attention(q, k, v,
                                                        is_causal=True),
                 4 * B * H * S * d * 2, ops, True, BF16_OPS_PER_S)
    # the CUDA-core route on the same bfloat16 inputs (the kernel this path
    # took before the tensor-core one)
    got = launch_route(q, k, v, True, "simt")
    assert torch.allclose(got.float(), exp.float(),
                          **FLASH_TOL[torch.bfloat16])
    simt_bf16 = time_ms(lambda: launch_route(q, k, v, True, "simt"), 3)
    wgmma = row["ms"]
    print(f"  flash_attention    routes at the path shape, bf16: wgmma "
          f"{wgmma:.4f} ms ({ops / wgmma / 1e9:.1f} TFLOP/s), simt "
          f"{simt_bf16:.4f} ms", flush=True)
    row["simt_bf16_ms"] = simt_bf16
    # float32: the tensor-core route in three TF32 terms, its bound that of
    # the split on the tensor cores (the float32 one beside), then the
    # CUDA-core route on the same inputs, launched by hand
    q, k, v = (x.float() for x in (q, k, v))
    assert route(q.dtype, d) == "tf32x3"
    exp = check(q, k, v, True, f"{FLASH_PATH} float32")
    nbytes = 4 * B * H * S * d * 4
    split_peak = TF32_OPS_PER_S / TF32_TERMS
    row = record("flash_attention.tf32x3",
                 f"B={B} H={H} S={S} d={d} f32 causal", 10,
                 lambda: flash_attention_cuda(q, k, v),
                 lambda: attention_ref(q, k, v),
                 lambda: F.scaled_dot_product_attention(q, k, v,
                                                        is_causal=True),
                 nbytes, ops, True, split_peak)
    row["bound_float32_ms"] = bound_ms(nbytes, ops)[0]
    got = launch_route(q, k, v, True, "simt")
    torch.cuda.synchronize()
    e = float((got - exp).abs().max())
    assert torch.allclose(got, exp, **FLASH_TOL[torch.float32]), \
        f"flash_attention simt {FLASH_PATH} float32: max error {e}"
    err["flash_attention"] = max(err["flash_attention"], e)
    simt = record("flash_attention.simt",
                  f"B={B} H={H} S={S} d={d} f32 causal", 3,
                  lambda: launch_route(q, k, v, True, "simt"),
                  lambda: attention_ref(q, k, v),
                  lambda: F.scaled_dot_product_attention(q, k, v,
                                                         is_causal=True),
                  nbytes, ops, True)
    print(f"  flash_attention    routes at the path shape, float32: tf32x3 "
          f"{row['ms']:.4f} ms ({ops / row['ms'] / 1e9:.1f} TFLOP/s of needed "
          f"work), simt {simt['ms']:.4f} ms, SDPA {row['library_ms']:.4f} ms;"
          f" bounds: {TF32_TERMS}xTF32 {row['bound_ms']:.4f} ms, float32 "
          f"{row['bound_float32_ms']:.4f} ms", flush=True)


# ---------------------------------------------------------------------------
# phase 5: the SQL main path
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


def llap_line(wh, since: dict) -> str:
    c = wh.llap.counters
    return (f"LLAP cache hits {c['cache_hits'] - since.get('cache_hits', 0)} "
            f"misses {c['cache_misses'] - since.get('cache_misses', 0)}")


def read_every_stripe(wh, table: str) -> int:
    """Read every stripe column of ``table``'s files through the port's
    stripe reader; returns the number of columns read."""
    from repro_torch.core.storage import StripeFileReader

    location = wh.hms.get_table(table).location
    count = 0
    for d, _, files in os.walk(location):
        for f in sorted(files):
            if not f.endswith(".tahoe"):
                continue
            with StripeFileReader(os.path.join(d, f)) as reader:
                meta = reader.read_meta()
                for si in range(len(meta.stripes)):
                    for col in meta.columns:
                        reader.read_column(si, col)
                        count += 1
    return count


def run_path(db, wh, cfg: dict, queries: dict, kernels: tuple,
             title: str) -> dict:
    """Each query under cuda, then under auto (same scan-cache state), on
    one warehouse; launch counts go to 0 just before and are read just
    after.  Returns the counts."""
    from repro_torch.kernels import registry

    print(title, flush=True)
    print(f"{'query':10s} {'rows':>6s} {'cuda ms':>10s} {'auto ms':>10s}"
          "  cuda launches (" + " ".join(PATH_KERNELS) + "); uploads ("
          + " ".join(PROFILED_KERNELS) + ")", flush=True)
    llap0 = dict(wh.llap.counters)
    total_c = total_a = 0.0
    with db.connect(warehouse=wh, engine="cuda", **cfg) as cuda, \
            db.connect(warehouse=wh, engine="auto", **cfg) as auto:
        registry.reset_launch_counts()
        registry.reset_upload_counts()
        for name, sql in queries.items():
            before = registry.launch_counts()
            up_before = registry.upload_counts()
            t0 = time.perf_counter()
            got = rows_of(cuda.execute(sql))
            mc = (time.perf_counter() - t0) * 1e3
            after = registry.launch_counts()
            up_after = registry.upload_counts()
            t0 = time.perf_counter()
            exp = rows_of(auto.execute(sql))
            ma = (time.perf_counter() - t0) * 1e3
            assert same_rows(got, exp), f"{name}: cuda rows != auto rows"
            total_c, total_a = total_c + mc, total_a + ma
            counts = " ".join(str(after.get(k, 0) - before.get(k, 0))
                              for k in PATH_KERNELS)
            ups = " ".join(str(up_after.get(k, 0) - up_before.get(k, 0))
                           for k in PROFILED_KERNELS)
            print(f"{name:10s} {len(got):6d} {mc:10.1f} {ma:10.1f}  "
                  f"{counts}; {ups}", flush=True)
        torch.cuda.synchronize()
        launches = registry.launch_counts()
        uploads = registry.upload_counts()
    print(f"{'total':10s} {'':6s} {total_c:10.1f} {total_a:10.1f}; "
          f"{llap_line(wh, llap0)}", flush=True)
    print(f"launches: {launches}", flush=True)
    print(f"uploads of build-side state: {uploads}", flush=True)
    for k in kernels:
        assert launches.get(k, 0) > 0, f"{k} never launched on the path"
    # a join's dictionary and a runtime filter's bitset go to the card once
    # each (per build table and per scan), never once per morsel or stripe
    for k in PROFILED_KERNELS:
        if launches.get(k, 0):
            assert 0 < uploads.get(k, 0) * MORSELS_PER_UPLOAD <= \
                launches[k], (k, uploads, launches)
    return launches


def main_path(rows: int, work_dir: str, isolated: dict) -> dict:
    import repro_torch.api as db
    from repro_torch.core.session import Warehouse
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
        # every stripe column of lineorder read once, storage alone: one
        # zip-directory parse per file
        t0 = time.perf_counter()
        members = read_every_stripe(wh, "lineorder")
        print(f"stripe reads of lineorder: {members} columns in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        # one cold read of every lineorder column through LLAP and the
        # executor (lineorder at SF1 outgrows LLAP's 256 MB cache, so later
        # scans read from disk again)
        llap0 = dict(wh.llap.counters)
        t0 = time.perf_counter()
        with db.connect(warehouse=wh, engine="auto", **CONFIG) as warm:
            warm.execute("SELECT " + ", ".join(
                f"SUM({c})" for c in LINEORDER_COLS) + " FROM lineorder"
            ).fetchall()
        print(f"cold scan of every lineorder column: "
              f"{time.perf_counter() - t0:.1f} s; {llap_line(wh, llap0)}",
              flush=True)
        launches = run_path(
            db, wh, {**CONFIG, "exchange.spill_dir": spill}, queries,
            PATH_KERNELS, f"main path: default SQL configuration {CONFIG}, "
            f"{len(queries)} queries, lineorder {rows} rows")
        # the executor's 1,024-row morsels take the one-launch paths
        assert launches.get("hash_group_minmax.one_block", 0) > 0, launches
        assert launches.get("hash_group.morsel", 0) > 0, launches
        profile_path(db, wh, {**CONFIG, "exchange.spill_dir": spill},
                     PROFILE_QUERY, queries[PROFILE_QUERY], isolated)
        run_path(
            db, wh, {**EARLIER, "exchange.spill_dir": spill},
            {name: queries[name] for name in EARLIER_QUERIES},
            EARLIER_KERNELS, f"earlier path (first slice): {EARLIER}, "
            f"depth {len(EARLIER_QUERIES)} of {len(queries)} queries "
            f"{list(EARLIER_QUERIES)}, "
            f"lineorder {rows} rows")
        return launches
    finally:
        wh.close()
        shutil.rmtree(work_dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 4: the LM serving path (mamba2-130m) and flash_attention's phase
# ---------------------------------------------------------------------------
LM_ARCH = "mamba2-130m"
PREFILL_BATCH = 2      # prefill_32k's batch of 32, cut (see serve_lm)
DECODE_BATCH = 128     # decode_32k's batch
PROMPT, GENERATE = 256, 32
# decode's logits at the prompt's last position against a prefill of the
# same prompt: the JAX package's decode-vs-forward bound for bfloat16
# (tests/test_models.py:90-94)
DECODE_TOL = {"atol": 0.15, "rtol": 0.15}
# prefill logits with the kernel against the plain scan, as a fraction of
# the plain logits' largest magnitude: the kernel's float32 sums differ in
# order, which flips bfloat16 roundings of the scan output in some of the
# 24 layers (about 2% of it at --seed 0 on an H100); each layer's scan is
# also held to its plain version on that layer's real inputs
# (SSD_MODEL_TOL), so this bound only has to catch a wrong model around it
LOGIT_REL_TOL = 0.04


def logits_diff(a, b, step: int = 4096) -> tuple:
    """(largest |a - b|, largest |b|, median |b| over the first 256
    positions, argmax agreement) over (B, S, V) logits, a slice of positions at a time
    (float32 copies of the whole would take twice the bfloat16 tensors'
    6.6 GB)."""
    diff = scale = 0.0
    agree = 0
    median = float(b[:, :256].float().abs().median())
    for s in range(0, a.shape[1], step):
        x, y = a[:, s:s + step].float(), b[:, s:s + step].float()
        diff = max(diff, float((x - y).abs().max()))
        scale = max(scale, float(y.abs().max()))
        agree += int((x.argmax(-1) == y.argmax(-1)).sum())
    return diff, scale, median, agree / (a.shape[0] * a.shape[1])


def check_scan_in_model(model, tokens) -> None:
    """Every layer's scan on the inputs the prefill gives it (x, dA, B, C
    from that layer's projections and convolution), the kernel against the
    plain version at SSD_MODEL_TOL; the layers advance on the plain scan."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_cuda
    from repro_torch.models import model as M
    from repro_torch.models.layers import NOSHARD, rms_norm
    from repro_torch.models.mamba2 import mamba2_scan_inputs, ssd_reference

    cfg = model.cfg
    worst = (0.0, -1, 0.0, 0.0)  # (|diff| / largest |y|, layer, both)
    with torch.inference_mode():
        h = M._embed(model, tokens)
        for li, (kind, bp) in enumerate(zip(model.kinds, model.layers)):
            _, _, xs, dA, Bm, Cm = mamba2_scan_inputs(
                bp.mamba, rms_norm(h, bp.ln), cfg)
            got = ssd_scan_cuda(xs, dA, Bm, Cm, chunk=cfg.ssm.chunk)[0]
            exp = ssd_reference(xs, dA, Bm, Cm, chunk=cfg.ssm.chunk)[0]
            scale = float(exp.abs().max())
            e = float((got - exp).abs().max())
            assert torch.allclose(
                got, exp, rtol=SSD_MODEL_TOL["rtol"],
                atol=SSD_MODEL_TOL["atol_of_max"] * scale), \
                f"ssd_scan in layer {li}: max error {e}, largest |y| {scale}"
            worst = max(worst, (e / scale, li, e, scale))
            del got, exp, xs, dA, Bm, Cm
            h = M._apply_block(kind, bp, model.shared, h, cfg, NOSHARD,
                               use_kernel=False)
    print(f"ssd_scan on each layer's own inputs, kernel vs plain: worst "
          f"layer {worst[1]}, max |diff| {worst[2]:.3e} against largest |y| "
          f"{worst[3]:.3e} (tolerance {SSD_MODEL_TOL})", flush=True)


def serve_lm(dev, seed: int) -> int:
    """mamba2-130m at full width and depth, random bf16 weights from a
    seeded generator: one prefill_32k step (batch cut to 2), then 128
    sequences decoded through make_serve_step (a 256-token prompt token by
    token, then 32 greedy tokens).  ssd_scan's count goes to 0 just before
    and is read just after; the comparisons follow outside that window.
    Returns ssd_scan's launches."""
    from repro_torch.configs.base import LM_SHAPES, get_config
    from repro_torch.kernels import registry
    from repro_torch.kernels.ssd_scan.ops import PASSES as SSD_PASSES
    from repro_torch.models import model as M
    from repro_torch.train.steps import make_prefill_step, make_serve_step

    cfg = get_config(LM_ARCH)
    s = cfg.ssm
    shape = LM_SHAPES["prefill_32k"]
    full = shape.global_batch * shape.seq_len * cfg.vocab_size * 2
    print(f"serving path: {cfg.name}, {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {s.num_heads(cfg.d_model)} SSM heads of "
          f"{s.head_dim}, d_state {s.d_state}, chunk {s.chunk}, vocab "
          f"{cfg.vocab_size}; bf16 weights from torch.Generator seed {seed}",
          flush=True)
    print(f"cut: prefill_32k's batch {shape.global_batch} -> "
          f"{PREFILL_BATCH} (its full-sequence bf16 logits would take "
          f"{full / 1e9:.1f} GB); decode_32k's batch {DECODE_BATCH} kept, "
          f"its 32,768-token context cut to a {PROMPT}-token prompt and "
          f"{GENERATE} new tokens", flush=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = M.init_params(cfg, gen, device=dev)
    print(f"parameters: {sum(p.numel() for p in model.parameters()):,}",
          flush=True)
    prefill = make_prefill_step(cfg)
    serve = make_serve_step(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, shape.seq_len),
                           generator=gen, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (DECODE_BATCH, PROMPT),
                           generator=gen, device=dev)
    prefill(model, tokens[:, :1024])  # warm-up: library handles, not counted
    torch.cuda.synchronize()

    registry.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    nxt = prefill(model, tokens)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_peak = torch.cuda.max_memory_allocated()
    counts = registry.launch_counts()
    prefill_launches = counts.get("ssd_scan", 0)
    assert prefill_launches == cfg.num_layers, \
        f"prefill launched ssd_scan {prefill_launches} times, want " \
        f"{cfg.num_layers}"
    pass_launches = {p: counts.get(f"ssd_scan.{p}", 0) for p in SSD_PASSES}
    assert set(pass_launches.values()) == {prefill_launches}, pass_launches

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cache = M.init_cache(cfg, DECODE_BATCH, PROMPT + GENERATE, device=dev)
    for t in range(PROMPT - 1):
        _, cache = serve(model, cache, prompt[:, t], t)
    last, cache = M.decode_step(model, cache, prompt[:, -1], PROMPT - 1)
    tok = last.argmax(-1).to(torch.int32)
    out = [tok]
    for t in range(PROMPT, PROMPT + GENERATE - 1):
        tok, cache = serve(model, cache, tok, t)
        out.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    decode_peak = torch.cuda.max_memory_allocated()
    launches = registry.launch_counts()
    assert launches.get("ssd_scan", 0) == cfg.num_layers, launches
    steps = PROMPT + GENERATE - 1
    print(f"prefill {PREFILL_BATCH} x {shape.seq_len}: {prefill_s:.3f} s, "
          f"{PREFILL_BATCH * shape.seq_len / prefill_s:,.0f} tokens/s, peak "
          f"{prefill_peak / 2**30:.2f} GiB, ssd_scan launches "
          f"{prefill_launches} (wrapper calls), kernel launches by pass "
          f"{pass_launches}: {sum(pass_launches.values()) / prefill_launches}"
          f" a call", flush=True)
    print(f"decode {DECODE_BATCH} sequences x {steps} steps: {decode_s:.3f} "
          f"s, {decode_s / steps * 1e3:.2f} ms a step, "
          f"{DECODE_BATCH * steps / decode_s:,.0f} tokens/s, peak "
          f"{decode_peak / 2**30:.2f} GiB", flush=True)
    print(f"launches on the serving path: {launches}", flush=True)

    # --- checks, outside the counted window
    generated = torch.stack(out, 1)
    assert generated.shape == (DECODE_BATCH, GENERATE)
    assert int(generated.min()) >= 0 and \
        int(generated.max()) < cfg.vocab_size
    assert torch.isfinite(last.float()).all()
    with torch.inference_mode():
        ref_last = M.forward(model, prompt)[:, -1]
    e_dec = float((last.float() - ref_last.float()).abs().max())
    agree_dec = float((last.argmax(-1) == ref_last.argmax(-1)).float().mean())
    print(f"decode vs prefill logits at the prompt's last position: max "
          f"|diff| {e_dec:.5f} (tolerance {DECODE_TOL}), argmax agreement "
          f"{agree_dec:.4f}", flush=True)
    assert torch.allclose(last.float(), ref_last.float(), **DECODE_TOL)
    with torch.inference_mode():
        with_kernel = M.forward(model, tokens)
        plain = M.forward(model, tokens, use_kernel=False)
    assert torch.equal(with_kernel[:, -1].argmax(-1).to(torch.int32), nxt)
    e_pre, scale, median, agree_pre = logits_diff(with_kernel, plain)
    print(f"prefill logits, kernel vs plain scan: max |diff| {e_pre:.5f}, "
          f"largest |logit| {scale:.5f} (tolerance {LOGIT_REL_TOL} of it), "
          f"median |logit| {median:.5f}, argmax agreement over all positions "
          f"{agree_pre:.5f}", flush=True)
    assert e_pre <= LOGIT_REL_TOL * scale, "prefill logits disagree"
    del with_kernel, plain
    check_scan_in_model(model, tokens)
    return launches["ssd_scan"]


# ---------------------------------------------------------------------------
# phase 4a: the MoE serving path (olmoe-1b-7b)
# ---------------------------------------------------------------------------
MOE_ARCH = "olmoe-1b-7b"
# the JAX package's parameter tree (param_count()'s analytic 6,919,096,320
# leaves out the 16 layers' q/k-norm scales, 2 x 128 each)
MOE_PARAMS = 6_919_100_416
MOE_LOOP_LAYERS = (0, 15)   # layers whose prefill inputs the loop check takes
MOE_CPU_LAYERS = 2          # layers held card against CPU on 1 x PROMPT tokens
MOE_NODROP_BATCH = 8        # sequences of PROMPT tokens, decode vs prefill
# top-8 choices may differ between the card and the CPU only where the
# CPU's 8th and 9th router logits lie closer than this, relative to the
# token's largest |logit| (topk_gap)
MOE_TIE_REL = 1e-4
# moe_ffn adds the k gated slots in bfloat16 (as the JAX package does); the
# per-expert loop and the CPU add them otherwise: a few bfloat16 roundings
# of the largest output (k = 8 at d_model 512 on the CPU: relative L2
# 0.0044, max 0.0099 of the largest |y|); a wrong expert or gate reads 1
MOE_ROUNDING_TOL = {"rel_l2": 1e-2, "max_of_largest": 2 ** -5}
# decode against prefill, as a multiple of a second prefill's spread (the
# online attention, top-k held): on the H100 at --seed 0 decode with the
# top-k held read the same 0.328 largest |diff| and the same 4.6-5.7%
# relative L2 of a position's logits as that prefill
MOE_DECODE_SLACK = 1.5


class RouteLog:
    """Patches ``models.moe.route`` to record each call's capacity and
    dropped count (a device scalar: no sync) and, at the calls numbered in
    ``keep_inputs``, its input."""

    def __init__(self, keep_inputs=()):
        from repro_torch.models import moe

        self.moe, self.real = moe, moe.route
        self.keep_inputs = set(keep_inputs)
        self.dropped, self.C, self.inputs = [], [], {}

    def route(self, p, x, cfg):
        r = self.real(p, x, cfg)
        if len(self.C) in self.keep_inputs:
            self.inputs[len(self.C)] = x
        self.dropped.append((~r.keep).sum())
        self.C.append(r.C)
        return r

    def __enter__(self):
        self.moe.route = self.route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.real

    def dropped_counts(self) -> list:
        return [int(d) for d in torch.stack(self.dropped).cpu()]


def rounding_errors(got, exp) -> dict:
    got, exp = got.float(), exp.float()
    d = got - exp
    return {"rel_l2": float(d.norm() / exp.norm()),
            "max_of_largest": float(d.abs().max() / exp.abs().max())}


def assert_roundings(errs: dict, what: str) -> None:
    for k, limit in MOE_ROUNDING_TOL.items():
        assert errs[k] <= limit, f"{what}: {errs} beyond {MOE_ROUNDING_TOL}"


def topk_gap(logits, k: int):
    """The gap between the k-th and (k+1)-th largest router logit, over the
    largest |logit| of the row."""
    top = torch.sort(logits, -1, descending=True).values
    return (top[..., k - 1] - top[..., k]) / top.abs().amax(-1)


def moe_check_loop(model, inputs: dict) -> dict:
    """moe_ffn against the plain per-expert loop on layers' real prefill
    inputs: equal keep masks, outputs to bfloat16 roundings."""
    from repro_torch.models.moe import moe_ffn, moe_ffn_loop, route

    out = {}
    with torch.inference_mode():
        for li, x in sorted(inputs.items()):
            p = model.layers[li].moe
            got = moe_ffn(p, x, model.cfg)
            exp, keep = moe_ffn_loop(p, x, model.cfg)
            assert torch.equal(keep, route(p, x, model.cfg).keep), \
                f"layer {li}: keep masks differ from the per-expert loop"
            errs = rounding_errors(got, exp)
            assert_roundings(errs, f"moe_ffn vs the loop, layer {li}")
            out[li] = {"dropped": int((~keep).sum()), **errs}
    print(f"moe_ffn vs the per-expert loop on the prefill's layer inputs "
          f"(equal keep masks; tolerance {MOE_ROUNDING_TOL}): "
          + json.dumps(out), flush=True)
    return out


def moe_check_cpu(model, tokens) -> dict:
    """The first MOE_CPU_LAYERS layers on (1, PROMPT) tokens: each layer's
    attention from the card's layer input, and its MoE from the card's MoE
    input, run again on the CPU with the layer's weights.  Top-8 choices
    equal except at near-ties (the CPU's topk_gap below MOE_TIE_REL);
    outputs of the tokens routed and kept alike on both to bfloat16
    roundings.  The layers advance on the card."""
    from repro_torch.models import model as M
    from repro_torch.models.layers import attention, rms_norm
    from repro_torch.models.moe import moe_ffn, route

    cfg = model.cfg
    k = cfg.moe.top_k
    out = []
    with torch.inference_mode():
        h = M._embed(model, tokens)
        for li in range(MOE_CPU_LAYERS):
            bp = model.layers[li]
            cpu = M.MoEBlock(cfg, torch.bfloat16, "cpu")
            cpu.load_state_dict(bp.state_dict())
            a = attention(bp.attn, rms_norm(h, bp.ln1), cfg)
            a_cpu = attention(cpu.attn, rms_norm(h.cpu(), cpu.ln1), cfg)
            h = h + a
            ff = rms_norm(h, bp.ln2)
            r, y = route(bp.moe, ff, cfg), moe_ffn(bp.moe, ff, cfg)
            ff_cpu = ff.cpu()
            r_cpu, y_cpu = route(cpu.moe, ff_cpu, cfg), moe_ffn(cpu.moe,
                                                                ff_cpu, cfg)
            tie = topk_gap(ff_cpu.reshape(-1, cfg.d_model).float()
                           @ cpu.moe.router, k) < MOE_TIE_REL
            differ = (r.topi.cpu() != r_cpu.topi).any(-1)
            assert not (differ & ~tie).any(), \
                f"layer {li}: top-{k} differs at tokens " \
                f"{(differ & ~tie).nonzero().flatten().tolist()}"
            alike = ~differ & (r.keep.cpu() == r_cpu.keep).all(-1)
            if not tie.any():
                assert alike.all(), f"layer {li}: keep masks differ"
            y, y_cpu = y.reshape(-1, cfg.d_model).cpu(), \
                y_cpu.reshape(-1, cfg.d_model)
            errs = {"attention": rounding_errors(a.cpu(), a_cpu),
                    "moe": rounding_errors(y[alike], y_cpu[alike])}
            for part, e in errs.items():
                assert_roundings(e, f"card vs CPU, layer {li} {part}")
            out.append({"layer": li, "near_ties": int(tie.sum()),
                        "top_k_differs": int(differ.sum()),
                        "compared_tokens": int(alike.sum()),
                        "dropped": int((~r.keep).sum()), **errs})
            h = h + y.to(h.device).reshape(h.shape)
            del cpu
    print(f"card vs CPU, layers 0-{MOE_CPU_LAYERS - 1} on 1 x "
          f"{tokens.shape[1]} tokens (near-tie: topk_gap below {MOE_TIE_REL} "
          f"on the CPU): " + json.dumps(out),
          flush=True)
    return out


def moe_check_decode(model, prompt) -> dict:
    """Decode against prefill on MOE_NODROP_BATCH sequences of PROMPT
    tokens, under a copy of the config with capacity_factor E / top_k, so
    that C >= T and no slot drops on either path.

    At full size the two paths cannot meet DECODE_TOL, nor can two
    prefills: olmoe's experts (std 1/8, ROADMAP C8) amplify bfloat16
    roundings, and where a token's 8th and 9th router logits nearly tie,
    one rounding sends it to another expert, whose output then reaches
    every later position through attention.  So the yardstick is the
    prefill's own spread: a second prefill with the online attention
    (models.layers.set_attention_impl), each layer's top-k held to the
    blocked prefill's, against that prefill.  Decode with the top-k held
    the same way must agree with the prefill within MOE_DECODE_SLACK times
    that spread (largest |logit diff| and largest relative L2 of a
    position's logits).  Decode as served must do so at every position
    before a sequence's first top-k difference (any layer), and at that
    difference the MoE input's relative L2 distance from the prefill's is
    no more than the held decode's largest: a rounding flipped a
    near-tie."""
    import dataclasses

    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.models.layers import set_attention_impl

    cfg = model.cfg
    m, L = cfg.moe, cfg.num_layers
    seqs = prompt[:MOE_NODROP_BATCH]
    B, S = seqs.shape
    real = moe.route
    calls = []

    def recorded(p, x, c):
        r = real(p, x, c)
        calls.append((x.reshape(-1, cfg.d_model), r.topi))
        return r

    def held(p, x, c):
        """The prefill's top-k for this call: the layer's in a forward, the
        layer's at this position in a decode step."""
        layer, t = len(calls) % L, len(calls) // L
        topi = (pre_topi[layer].reshape(B * S, -1) if x.shape[1] == S
                else pre_topi[layer][:, t])
        x = x.reshape(-1, cfg.d_model)
        calls.append((x, topi))
        gates = torch.softmax((x.float() @ p.router).gather(1, topi), -1)
        pos = moe.slot_positions(topi, m.num_experts)
        C = moe.capacity(x.shape[0], m.top_k, m.num_experts,
                         c.moe.capacity_factor)
        return moe.Routing(topi, gates, pos, pos < C, C)

    def decode(route):
        calls.clear()
        moe.route = route
        cache = M.init_cache(model.cfg, B, S, device=seqs.device)
        out = [M.decode_step(model, cache, seqs[:, t], t)[0]
               for t in range(S)]
        return torch.stack(out, 1).float()

    def spread(got, exp) -> dict:
        rel = (got - exp).norm(dim=-1) / exp.norm(dim=-1)
        return {"max_diff": float((got - exp).abs().max()),
                "max_rel_l2": float(rel.max()),
                "argmax": float((got.argmax(-1) == exp.argmax(-1))
                                .float().mean())}

    model.cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))
    try:
        with torch.inference_mode():
            moe.route = recorded
            full = M.forward(model, seqs).float()
            pre_x = [x.reshape(B, S, -1) for x, _ in calls]
            pre_topi = [t.reshape(B, S, -1) for _, t in calls]
            calls.clear()
            moe.route = held
            set_attention_impl("online")
            try:
                online = M.forward(model, seqs).float()
            finally:
                set_attention_impl("blocked")
            forced = decode(held)
            # each decode call's MoE input against the prefill's
            drift = torch.stack([
                (x.float() - pre_x[i % L][:, i // L].float()).norm(dim=-1)
                / pre_x[i % L][:, i // L].float().norm(dim=-1)
                for i, (x, _) in enumerate(calls)])
            served = decode(recorded)
            dec = calls[:]
    finally:
        moe.route = real
        model.cfg = cfg

    yardstick = spread(online, full)
    limits = {k: MOE_DECODE_SLACK * yardstick[k]
              for k in ("max_diff", "max_rel_l2")}
    held_err = spread(forced, full)
    first, before = [], []
    for b in range(B):
        flip = next(((t, li) for t in range(S) for li in range(L)
                     if not torch.equal(dec[t * L + li][1][b].sort().values,
                                        pre_topi[li][b, t].sort().values)),
                    None)
        upto = S if flip is None else flip[0]
        if upto:
            before.append(spread(served[b, :upto], full[b, :upto]))
        if flip is not None:
            t, li = flip
            errs = rounding_errors(dec[t * L + li][0][b], pre_x[li][b, t])
            gap = float(topk_gap(pre_x[li][b, t].float()
                                 @ model.layers[li].moe.router, m.top_k))
            first.append({"seq": b, "pos": t, "layer": li,
                          "prefill_gap": gap, "input_rel_l2":
                          errs["rel_l2"]})
    out = {"online_prefill_vs_prefill": yardstick, "limits": limits,
           "held_topk": held_err,
           "held_input_drift": {"median": float(drift.median()),
                                "max": float(drift.max())},
           "served_first_topk_difference": first,
           "served_before_it": {k: max(e[k] for e in before)
                                for k in ("max_diff", "max_rel_l2")},
           "served_argmax_last": float((served[:, -1].argmax(-1)
                                        == full[:, -1].argmax(-1))
                                       .float().mean())}
    print(f"decode vs prefill, {B} x {S} tokens, capacity_factor "
          f"{m.num_experts / m.top_k} (nothing dropped; limits "
          f"{MOE_DECODE_SLACK} x the online prefill's spread): "
          + json.dumps(out), flush=True)
    for what, e in [("held top-k", held_err)] + [
            (f"served, before sequence {i}'s first top-k difference", e)
            for i, e in enumerate(before)]:
        for k, limit in limits.items():
            assert e[k] <= limit, f"decode vs prefill, {what}: {e} {limits}"
    for f in first:
        assert f["input_rel_l2"] <= float(drift.max()), f
    return out


def moe_profiles(model, tokens, prompt) -> dict:
    """torch.profiler over layer 0 of the prefill (its 2 x 32,768 tokens)
    and over one decode step at batch 128: the device's busy share and its
    TOP_DEVICE_OPS operations by device time."""
    from repro_torch.models import model as M
    from repro_torch.models.layers import NOSHARD

    cfg = model.cfg
    with torch.inference_mode():
        h = M._embed(model, tokens)
        layer = device_profile(lambda: M._apply_block(
            "moe", model.layers[0], None, h, cfg, NOSHARD, True))
        del h
        cache = M.init_cache(cfg, DECODE_BATCH, PROMPT + GENERATE,
                             device=tokens.device)
        for t in range(2):  # warm-up
            M.decode_step(model, cache, prompt[:, t], t)
        step = device_profile(
            lambda: M.decode_step(model, cache, prompt[:, 2], 2))
    out = {}
    for name, prof in (("prefill_layer_0", layer), ("decode_step", step)):
        top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1][0])
        out[name] = {k: prof[k] for k in ("window_ms", "busy_ms",
                                          "busy_share", "device_events")}
        out[name]["top"] = [[n[:90], round(ms / 1e3, 3), count]
                            for n, (ms, count) in top[:TOP_DEVICE_OPS]]
        print(f"profile, {name}: " + json.dumps(out[name]), flush=True)
    return out


def serve_moe(dev, seed: int) -> dict:
    """olmoe-1b-7b at full width and depth, random bf16 weights from a
    seeded generator: one prefill_32k step (batch cut to 2), then 128
    sequences decoded through make_serve_step (a 256-token prompt token by
    token, then 32 greedy tokens: 288 steps).  The launch counts go to 0
    just before and are read just after (the path has no hand-written
    kernel: the expert products are torch.bmm, as the JAX package computes
    them in jnp); the three checks and two profiles follow outside that
    window.  Returns the numbers of the ``moe:`` line."""
    from repro_torch.configs.base import LM_SHAPES, get_config
    from repro_torch.kernels import registry
    from repro_torch.models import model as M
    from repro_torch.train.steps import make_prefill_step, make_serve_step

    cfg = get_config(MOE_ARCH)
    m = cfg.moe
    shape = LM_SHAPES["prefill_32k"]
    decode_shape = LM_SHAPES["decode_32k"]
    full_logits = shape.global_batch * shape.seq_len * cfg.vocab_size * 2
    kv = (2 * cfg.num_layers * decode_shape.global_batch
          * decode_shape.seq_len * cfg.num_kv_heads * cfg.resolved_head_dim
          * 2)
    print(f"MoE serving path: {cfg.name}, {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads of {cfg.resolved_head_dim}"
          f" (qk-norm {cfg.qk_norm}), {m.num_experts} experts of width "
          f"{m.d_ff_expert}, top-{m.top_k}, capacity factor "
          f"{m.capacity_factor}, vocab {cfg.vocab_size}; bf16 weights from "
          f"torch.Generator seed {seed}", flush=True)
    print(f"cut: prefill_32k's batch {shape.global_batch} -> "
          f"{PREFILL_BATCH} (its full-sequence bf16 logits would take "
          f"{full_logits / 1e9:.1f} GB)", flush=True)
    print(f"cut: decode_32k's batch {decode_shape.global_batch} kept, its "
          f"{decode_shape.seq_len:,}-token context cut to a {PROMPT}-token "
          f"prompt and {GENERATE} new tokens (its KV cache would take "
          f"{kv / 1e9:.0f} GB)", flush=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = M.init_params(cfg, gen, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"parameters: {n_params:,} ({n_bytes / 1e9:.2f} GB)", flush=True)
    assert n_params == MOE_PARAMS, n_params
    prefill = make_prefill_step(cfg)
    serve = make_serve_step(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, shape.seq_len),
                           generator=gen, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (DECODE_BATCH, PROMPT),
                           generator=gen, device=dev)
    prefill(model, tokens[:, :1024])  # warm-up: library handles, not counted
    torch.cuda.synchronize()

    registry.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with RouteLog(keep_inputs=MOE_LOOP_LAYERS) as pre:
        t0 = time.perf_counter()
        nxt = prefill(model, tokens)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    prefill_peak = torch.cuda.max_memory_allocated()

    torch.cuda.reset_peak_memory_stats()
    with RouteLog() as dec:
        t0 = time.perf_counter()
        cache = M.init_cache(cfg, DECODE_BATCH, PROMPT + GENERATE, device=dev)
        for t in range(PROMPT - 1):
            _, cache = serve(model, cache, prompt[:, t], t)
        last, cache = M.decode_step(model, cache, prompt[:, -1], PROMPT - 1)
        tok = last.argmax(-1).to(torch.int32)
        out = [tok]
        for t in range(PROMPT, PROMPT + GENERATE):
            tok, cache = serve(model, cache, tok, t)
            out.append(tok)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    decode_peak = torch.cuda.max_memory_allocated()
    launches = {k: v for k, v in registry.launch_counts().items() if v}
    del cache

    slots = PREFILL_BATCH * shape.seq_len * m.top_k
    prefill_dropped = pre.dropped_counts()
    steps = PROMPT + GENERATE
    decode_slots = DECODE_BATCH * m.top_k * steps * cfg.num_layers
    decode_dropped = sum(dec.dropped_counts())
    assert len(prefill_dropped) == cfg.num_layers
    assert len(dec.C) == cfg.num_layers * steps
    print(f"prefill {PREFILL_BATCH} x {shape.seq_len}: {prefill_s:.3f} s, "
          f"{PREFILL_BATCH * shape.seq_len / prefill_s:,.0f} tokens/s, peak "
          f"{prefill_peak / 2**30:.2f} GiB, C {sorted(set(pre.C))}",
          flush=True)
    print("prefill dropped share by layer: " + json.dumps(
        [round(d / slots, 6) for d in prefill_dropped]), flush=True)
    print(f"decode {DECODE_BATCH} sequences x {steps} steps: {decode_s:.3f} "
          f"s, {decode_s / steps * 1e3:.2f} ms a step, "
          f"{DECODE_BATCH * steps / decode_s:,.0f} tokens/s, peak "
          f"{decode_peak / 2**30:.2f} GiB, C {sorted(set(dec.C))}, dropped "
          f"{decode_dropped} of {decode_slots} slots", flush=True)
    print(f"launches on the MoE path: {launches}", flush=True)
    assert not launches, "the MoE path launched a hand-written kernel"

    # --- checks, outside the counted window
    generated = torch.stack(out, 1)
    assert generated.shape == (DECODE_BATCH, GENERATE + 1)
    assert 0 <= int(generated.min()) and \
        int(generated.max()) < cfg.vocab_size
    assert nxt.shape == (PREFILL_BATCH,) and torch.isfinite(last.float()).all()
    prefill_C, decode_C = sorted(set(pre.C)), sorted(set(dec.C))
    loop = moe_check_loop(model, pre.inputs)
    del pre
    cpu = moe_check_cpu(model, prompt[:1])
    decoded = moe_check_decode(model, prompt)
    profiles = moe_profiles(model, tokens, prompt)
    del model
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "parameters": n_params,
            "prefill": {"batch": PREFILL_BATCH, "seq": shape.seq_len,
                        "s": prefill_s,
                        "tokens_per_s": PREFILL_BATCH * shape.seq_len
                        / prefill_s,
                        "peak_gib": prefill_peak / 2**30, "C": prefill_C,
                        "dropped_share": [d / slots
                                          for d in prefill_dropped]},
            "decode": {"batch": DECODE_BATCH, "steps": steps,
                       "ms_per_step": decode_s / steps * 1e3,
                       "tokens_per_s": DECODE_BATCH * steps / decode_s,
                       "peak_gib": decode_peak / 2**30, "C": decode_C,
                       "dropped_share": decode_dropped / decode_slots},
            "checks": {"loop": loop, "cpu": cpu,
                       "decode_vs_prefill": decoded},
            "profiles": profiles}


def flash_phase(dev, rng) -> dict:
    """flash_attention's own entry point, once, at zamba2-1.2b's shared
    attention (no model path calls it), through the tensor-core route;
    returns its launches, in all and by route."""
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash_attention.ops import flash_attention

    q, k, v = (torch.from_numpy(rng.normal(size=FLASH_PATH)
                                .astype(np.float32)).to(dev, torch.bfloat16)
               for _ in range(3))
    registry.reset_launch_counts()
    out = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    counts = registry.launch_counts()
    launches = {k: counts.get(k, 0) for k in
                ("flash_attention",) + FLASH_ROUTES}
    assert launches == {"flash_attention": 1, "flash_attention.wgmma": 1,
                        "flash_attention.tf32x3": 0,
                        "flash_attention.simt": 0}, launches
    assert torch.isfinite(out.float()).all()
    print(f"flash_attention phase (entry point, (B, H, S, d) = {FLASH_PATH}, "
          f"bf16): {launches}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 4b: the LM training path, fed by the warehouse
# ---------------------------------------------------------------------------
TRAIN_DOCS, TRAIN_DOC_LEN = 2048, 256  # the ACID corpus: 524,288 tokens
TRAIN_BATCH = 16       # train_4k's global batch of 256, cut (see train_lm)
TRAIN_MICROBATCHES = 4
TRAIN_STEPS = 6
TRAIN_LR = 3e-3
CHECK_BATCH = (1, 512)  # the card's step against the CPU's
REMAT_BATCH = 2         # sequences of train_4k's length in each remat step
# the card's step against the CPU's, both in plain torch from the same
# weights, state and batch, float32 products in full float32 on both: the
# bfloat16 products add in another order, so bfloat16 roundings of their
# outputs flip, as between the port and the JAX package on the CPU
# (tests/test_torch_train.py).  Moments and the parameters' updates
# (p_new - p_old, float32 and bfloat16 parameters apart) as relative L2
# errors over all of them.  Each limit lies between the card's reading
# and a faulty step's, the card's on half of the tokens (H100 80GB HBM3,
# 700 W; PERF.md section 6): loss 2.7e-5 / 3.0e-3, grad norm 2.9e-4 /
# 2.3e-2, mu 1.3e-3 / 0.29, nu 7.7e-4 / 6.5e-2, float32 updates 7.8e-4 /
# 9.0e-2, bfloat16 updates 4.2e-3 / 7.7e-2; train_check asserts that the
# fault fails every relative L2 limit.
STEP_TOL = {"loss_rtol": 1e-3, "grad_norm_rtol": 1e-2,
            "moments_rel_l2": 2e-2, "update_rel_l2": 2e-2,
            "bf16_update_rel_l2": 2e-2}
# the remat modes compute the same forward (the loss) and recompute it for
# the backward; the card's backward adds some gradients in a run-dependent
# order (atomics)
REMAT_TOL = {"loss_rtol": 1e-6, "grad_norm_rtol": 1e-3}


def _copy_state(model, opt, device):
    """A copy of (model, optimiser state) on ``device``."""
    import copy

    from repro_torch.train.optimizer import AdamWState

    return (copy.deepcopy(model).to(device),
            AdamWState(opt.step.to(device, copy=True),
                       {k: v.to(device, copy=True) for k, v in opt.mu.items()},
                       {k: v.to(device, copy=True) for k, v in opt.nu.items()}))


def _rel_l2(got: dict, exp: dict) -> float:
    num = sum(float(torch.sum((got[k].cpu() - exp[k].cpu()).double() ** 2))
              for k in exp)
    den = sum(float(torch.sum(exp[k].cpu().double() ** 2)) for k in exp)
    return math.sqrt(num / den)


def _bits(t: torch.Tensor) -> torch.Tensor:
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return t.view(ints[t.dtype]) if t.dtype in ints else t


def train_sql(dev, cfg, seq: int, work: str) -> list:
    """(a) the ACID corpus and its batches through batches_from_warehouse
    under engine cuda, counted, then held to the same pipeline under
    engine auto (numpy host paths); returns TRAIN_STEPS batches."""
    from repro_torch.core.session import Warehouse
    from repro_torch.kernels import registry
    from repro_torch.train.lm_from_warehouse import (batches_from_warehouse,
                                                     build_corpus)

    wh = Warehouse(os.path.join(work, "warehouse"))
    try:
        t0 = time.perf_counter()
        build_corpus(wh, cfg.vocab_size, n_docs=TRAIN_DOCS,
                     doc_len=TRAIN_DOC_LEN)
        build_s = time.perf_counter() - t0
        registry.reset_launch_counts()
        t0 = time.perf_counter()
        data = batches_from_warehouse(wh, "train", TRAIN_BATCH, seq,
                                      cfg.vocab_size, engine="cuda",
                                      device=dev)
        batches = [next(data) for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        sql_s = time.perf_counter() - t0
        rose = {k: v for k, v in sorted(registry.launch_counts().items())
                if v}
        print(f"training data: ACID corpus of {TRAIN_DOCS} documents x "
              f"{TRAIN_DOC_LEN} tokens (vocabulary {cfg.vocab_size}) built "
              f"in {build_s:.2f} s; SQL scan + join + sort under engine "
              f"cuda and {TRAIN_STEPS} batches of {TRAIN_BATCH} x {seq} in "
              f"{sql_s:.2f} s; kernel launches that rose: {rose}",
              flush=True)
        assert rose, "the training data's SQL launched no kernel"
        host = batches_from_warehouse(wh, "train", TRAIN_BATCH, seq,
                                      cfg.vocab_size, engine="auto",
                                      device="cpu")
        for b in batches:
            h = next(host)
            for k in ("inputs", "labels"):
                assert b[k].shape == (TRAIN_BATCH, seq) and \
                    b[k].dtype == torch.int32 and b[k].device.type == dev.type
                assert torch.equal(b[k].cpu(), h[k]), \
                    "engine cuda's batches differ from engine auto's"
            assert int(b["inputs"].min()) >= 0 and \
                int(b["inputs"].max()) < cfg.vocab_size
        print("training batches under engine cuda equal engine auto's",
              flush=True)
        return batches
    finally:
        wh.close()


def train_lm(dev, seed: int) -> dict:
    """mamba2-130m at full width and depth trained on batches from SQL over
    an ACID table: (a) the data under engine cuda; (b) TRAIN_STEPS steps of
    make_train_step(microbatches=4, remat=True) from random bf16 weights,
    timed, with every count set to 0 just before and read just after (no
    kernel: training takes the plain scan); (e) an async checkpoint of the
    weights and optimiser state after the last step, restored bit-equal
    into a fresh model on the card; then, outside the timed window, (c) one
    step on the card against the same step on the CPU and (d) one step in
    each remat mode.  Returns the numbers it printed."""
    from repro_torch.configs.base import LM_SHAPES, get_config
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.kernels import registry
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.steps import make_train_step

    cfg = get_config(LM_ARCH)
    s = cfg.ssm
    shape = LM_SHAPES["train_4k"]
    seq = shape.seq_len
    print(f"training path: {cfg.name}, {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, d_state {s.d_state}, chunk {s.chunk}, vocab "
          f"{cfg.vocab_size}; bf16 weights from torch.Generator seed {seed}; "
          f"make_train_step(microbatches={TRAIN_MICROBATCHES}, remat=True, "
          f"lr={TRAIN_LR}), the plain scan in float32", flush=True)
    print(f"cut: train_4k's global batch {shape.global_batch} -> "
          f"{TRAIN_BATCH} (the phase's time), its length {seq} kept; "
          f"{TRAIN_STEPS} steps", flush=True)
    work = os.path.join(HERE, "build", "chip_smoke_train")
    shutil.rmtree(work, ignore_errors=True)
    try:
        batches = train_sql(dev, cfg, seq, work)
        gen = torch.Generator(device=dev).manual_seed(seed)
        model = M.init_params(cfg, gen, device=dev)
        opt = adamw_init(model)
        step_fn = make_train_step(cfg, microbatches=TRAIN_MICROBATCHES,
                                  remat=True, lr=TRAIN_LR)

        # (b) the timed steps
        registry.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, norms, step_ms = [], [], []
        for i, batch in enumerate(batches, 1):
            t0 = time.perf_counter()
            model, opt, metrics = step_fn(model, opt, batch)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            print(f"train step {i}: loss {losses[-1]:.6f}, grad norm "
                  f"{norms[-1]:.6f}, {step_ms[-1]:.1f} ms", flush=True)
        peak = torch.cuda.max_memory_allocated()
        launches = registry.launch_counts()
        tokens = TRAIN_BATCH * seq
        tokens_per_s = tokens * (len(step_ms) - 1) / (sum(step_ms[1:]) / 1e3)
        print(f"training: {tokens:,} tokens a step, {tokens_per_s:,.0f} "
              f"tokens/s over steps 2-{TRAIN_STEPS}, peak "
              f"{peak / 2**30:.2f} GiB, kernel launches {launches}",
              flush=True)
        assert all(math.isfinite(x) for x in losses + norms), (losses, norms)
        assert losses[-1] < losses[0], f"the loss did not fall: {losses}"
        assert launches.get("ssd_scan", 0) == 0, launches

        # (e) an async checkpoint after the last step, restored bit-equal
        ckpt = CheckpointManager(os.path.join(work, "checkpoints"), keep=2)
        tree = {"params": dict(model.named_parameters()), "opt": opt}
        t0 = time.perf_counter()
        ckpt.save(TRAIN_STEPS, tree, blocking=False)
        blocked_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ckpt.wait()
        write_s = time.perf_counter() - t0
        fresh = M.LM(cfg, torch.bfloat16, dev)
        fresh_opt = adamw_init(fresh)
        t0 = time.perf_counter()
        restored, step = ckpt.restore(
            {"params": dict(fresh.named_parameters()), "opt": fresh_opt})
        with torch.no_grad():
            for name, p in fresh.named_parameters():
                p.copy_(restored["params"][name])
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        assert step == TRAIN_STEPS
        got_opt = restored["opt"]
        pairs = [(p, dict(fresh.named_parameters())[n])
                 for n, p in model.named_parameters()]
        pairs += [(opt.step, got_opt.step)]
        pairs += [(opt.mu[n], got_opt.mu[n]) for n in opt.mu]
        pairs += [(opt.nu[n], got_opt.nu[n]) for n in opt.nu]
        for a, b in pairs:
            assert b.device.type == dev.type and a.dtype == b.dtype
            assert torch.equal(_bits(a.detach()), _bits(b.detach()))
        nbytes = sum(a.numel() * a.element_size() for a, _ in pairs)
        print(f"checkpoint of step {step} ({nbytes / 2**30:.2f} GiB, "
              f"{len(pairs)} tensors): the loop blocked {blocked_ms:.1f} ms "
              f"for the async save, the write took {write_s:.2f} s more, "
              f"the restore into a fresh model on the card {restore_s:.2f} "
              f"s; bit-equal", flush=True)
        del fresh, fresh_opt, restored, got_opt, pairs

        check = train_check(dev, model, opt, batches[-1])
        remat = train_remat(dev, model, opt, batches[-1])
        return {"step_ms": step_ms, "loss": losses, "grad_norm": norms,
                "tokens_per_s": tokens_per_s, "peak_gib": peak / 2**30,
                "checkpoint_blocked_ms": blocked_ms,
                "checkpoint_write_s": write_s, "cpu_check": check,
                "remat": remat}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _step_errors(model, got, exp) -> dict:
    """Relative L2 errors of one step's (model, state) ``got`` against
    ``exp``, both taken from ``model``'s weights: moments, and the updates
    (p_new - p_old) of the float32 and the bfloat16 parameters apart."""
    (mg, og), (me, oe) = got, exp
    old = {n: p.detach().cpu().float() for n, p in model.named_parameters()}
    pg, pe = dict(mg.named_parameters()), dict(me.named_parameters())
    out = {"mu": _rel_l2(og.mu, oe.mu), "nu": _rel_l2(og.nu, oe.nu)}
    for key, dtype in (("update", torch.float32),
                       ("bf16_update", torch.bfloat16)):
        names = [n for n, p in pe.items() if p.dtype == dtype]
        assert names and all(pg[n].dtype == dtype for n in names), key
        out[key] = _rel_l2(
            {n: pg[n].detach().cpu().float() - old[n] for n in names},
            {n: pe[n].detach().cpu().float() - old[n] for n in names})
    return out


def train_check(dev, model, opt, batch) -> dict:
    """(c) one step (no microbatches, no remat) on a CHECK_BATCH slice of
    ``batch``, from the same weights and state, on the card and on the
    CPU, at STEP_TOL; and a faulty step, the card's on half of those
    tokens, held to the CPU's step the same way, which must fail every
    relative L2 limit."""
    from repro_torch.train.steps import make_train_step

    b, n = CHECK_BATCH
    part = {k: v[:b, :n] for k, v in batch.items()}
    step = make_train_step(model.cfg, remat=False, lr=TRAIN_LR)
    out = {}
    runs = (("card", dev, n), ("cpu", torch.device("cpu"), n),
            ("fault", dev, n // 2))
    for name, device, tokens in runs:
        m, o = _copy_state(model, opt, device)
        t0 = time.perf_counter()
        m, o, metrics = step(m, o, {k: v[:, :tokens].to(device)
                                    for k, v in part.items()})
        out[name] = (m, o, float(metrics["loss"]),
                     float(metrics["grad_norm"]), time.perf_counter() - t0)
    (mc, oc, lc, gc, tc), (mp, op, lp, gp, tp) = out["card"], out["cpu"]
    err = _step_errors(model, (mc, oc), (mp, op))
    fault = _step_errors(model, out["fault"][:2], (mp, op))
    fault["loss"], fault["grad_norm"] = out["fault"][2:4]
    print(f"one step on {b} x {n} tokens, card vs CPU (plain torch): loss "
          f"{lc:.6f} / {lp:.6f}, grad norm {gc:.6f} / {gp:.6f}, relative L2 "
          f"errors: moments mu {err['mu']:.2e} nu {err['nu']:.2e}, updates "
          f"of the float32 parameters {err['update']:.2e}, of the bf16 "
          f"parameters {err['bf16_update']:.2e}; {tc:.2f} s / {tp:.2f} s "
          f"(tolerance {STEP_TOL})", flush=True)
    print(f"the fault (the card's step on {b} x {n // 2} of those tokens) "
          f"against the CPU's step: loss {fault['loss']:.6f}, grad norm "
          f"{fault['grad_norm']:.6f}, relative L2 errors: moments mu "
          f"{fault['mu']:.2e} nu {fault['nu']:.2e}, float32 updates "
          f"{fault['update']:.2e}, bf16 updates {fault['bf16_update']:.2e}",
          flush=True)
    assert abs(lc - lp) <= STEP_TOL["loss_rtol"] * abs(lp), (lc, lp)
    assert abs(gc - gp) <= STEP_TOL["grad_norm_rtol"] * abs(gp), (gc, gp)
    limits = {"mu": "moments_rel_l2", "nu": "moments_rel_l2",
              "update": "update_rel_l2", "bf16_update": "bf16_update_rel_l2"}
    for key, limit in limits.items():
        assert err[key] <= STEP_TOL[limit], (key, err)
        assert fault[key] > STEP_TOL[limit], ("the fault passed", key, fault)
    assert int(oc.step) == int(op.step) == int(opt.step) + 1
    return {"loss": [lc, lp], "grad_norm": [gc, gp],
            **{f"{k}_rel_l2": v for k, v in err.items()},
            "fault": {f"{k}_rel_l2" if k in limits else k: v
                      for k, v in fault.items()}}


def train_remat(dev, model, opt, batch) -> dict:
    """(d) one step in each remat mode (none, per_period, sqrt) on the same
    REMAT_BATCH sequences from the same weights and state, no
    microbatches: peak memory and ms each; losses at REMAT_TOL."""
    from repro_torch.models import model as M
    from repro_torch.train.steps import make_train_step

    part = {k: v[:REMAT_BATCH] for k, v in batch.items()}
    runs = {}
    for mode in ("none", "per_period", "sqrt"):
        m, o = _copy_state(model, opt, dev)
        M.set_remat_mode("sqrt" if mode == "sqrt" else "per_period")
        try:
            step = make_train_step(model.cfg, remat=mode != "none",
                                   lr=TRAIN_LR)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            _, _, metrics = step(m, o, part)
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated() / 2**30
        finally:
            M.set_remat_mode("per_period")
        runs[mode] = {"loss": loss, "grad_norm": gnorm, "ms": ms,
                      "peak_gib": peak}
        del m, o
    shape = tuple(part["inputs"].shape)
    print(f"remat modes, one step on {shape}: " + json.dumps(runs) +
          f" (tolerance {REMAT_TOL}, SQRT_GROUP {M.SQRT_GROUP} of "
          f"{model.cfg.num_periods} periods)", flush=True)
    base = runs["none"]
    for mode in ("per_period", "sqrt"):
        r = runs[mode]
        assert abs(r["loss"] - base["loss"]) <= \
            REMAT_TOL["loss_rtol"] * abs(base["loss"]), (mode, runs)
        assert abs(r["grad_norm"] - base["grad_norm"]) <= \
            REMAT_TOL["grad_norm_rtol"] * abs(base["grad_norm"]), (mode, runs)
    return runs


# ---------------------------------------------------------------------------
# the distributed layer: relational operators and the compressed psum over
# NCCL at world size 1 (one card; NCCL takes one rank a card)
# ---------------------------------------------------------------------------
DIST_REPS = 5   # timed calls a operator, after one warm-up; the median
# the compressed psum against the plain all-reduce, as a fraction of the
# plain result's largest magnitude (tests/test_distributed.py:101)
COMPRESS_REL_TOL = 0.02
DIST_ARCH = "mamba2-130m"  # the psum's tree: its parameters' shapes


def _median_ms(fn) -> tuple:
    """(median ms of DIST_REPS calls by CUDA events after one warm-up,
    peak bytes allocated during them, the last call's result)."""
    fn()
    torch.cuda.synchronize()
    times = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(DIST_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), torch.cuda.max_memory_allocated(), out


def _dist_profile(name: str, run) -> dict:
    """One call of ``run`` under torch.profiler: the device's busy share of
    the window, its events and the top device operations (name, ms,
    launches), as moe_profiles reports them."""
    prof = device_profile(run)
    top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1][0])
    out = {k: prof[k] for k in ("window_ms", "busy_ms", "busy_share",
                                "device_events")}
    out["top"] = [[n[:90], round(us / 1e3, 3), count]
                  for n, (us, count) in top[:4]]
    print(f"distributed {name}, one call under torch.profiler: "
          + json.dumps(out), flush=True)
    return out


def distributed_phase(card: str, rows: int, seed: int) -> dict:
    """The distributed layer's four operators on one card over NCCL (world
    size 1, mesh ("data",) of 1): SSB's columns as load_ssb draws them
    (lineorder ``rows``, date 2,556, customer 1,000, ``seed``).  (a) the
    group sum of lo_revenue by lo_orderdate against numpy (counts exact,
    sums within float32's bound for each group's count); (b) the shuffle
    join of lineorder with customer on the customer key, every row matched
    once, overflow 0, rows equal numpy's join; (c) the broadcast join with
    the dates, equal to numpy's join row for row; (d) the compressed psum
    over a float32 tree of mamba2-130m's parameter shapes, its int8
    payloads, scales and result equal to the same computation on the CPU
    (a gloo group of one), within COMPRESS_REL_TOL of the plain
    all-reduce.  Times by CUDA events; the process group is destroyed at
    the end."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group

    rdv = os.path.join(HERE, "build", "distributed_rdv")
    os.makedirs(os.path.dirname(rdv), exist_ok=True)
    if os.path.exists(rdv):
        os.remove(rdv)
    backend = init_process_group(0, 1, device="cuda",
                                 init_method=f"file://{rdv}")
    assert backend == "nccl" and dist.get_backend() == "nccl", backend
    try:
        return _distributed_ops(card, rows, seed, backend)
    finally:
        dist.destroy_process_group()


def _distributed_ops(card: str, rows: int, seed: int, backend: str) -> dict:
    import torch.distributed as dist

    from repro_torch.configs.base import get_config
    from repro_torch.distributed.compression import (
        compressed_psum, psum_with_optional_compression, quantize_int8)
    from repro_torch.distributed.relational import (
        make_broadcast_join, make_distributed_group_sum, make_shuffle_join)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.workloads.ssb import ssb_columns

    dev = torch.device("cuda")
    mesh = make_mesh((1,), ("data",), "cuda")
    cols = ssb_columns(rows, seed)
    lo, cust, date = cols["lineorder"], cols["customer"], cols["date_dim"]
    world = dist.get_world_size()
    print(f"distributed phase: {card}; world_size: {world}, backend: "
          f"{backend}, mesh {mesh.mesh_dim_names} = {tuple(mesh.shape)}; "
          f"lineorder {rows} rows, date {len(date['d_datekey'])}, customer "
          f"{len(cust['c_custkey'])}, seed {seed}", flush=True)

    def on_card(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a.astype(dtype))).to(dev)

    o_date = on_card(lo["lo_orderdate"], np.int32)
    o_cust = on_card(lo["lo_custkey"], np.int32)
    o_rev32 = lo["lo_revenue"].astype(np.float32)
    o_rev = on_card(o_rev32, np.float32)
    c_key = on_card(cust["c_custkey"], np.int32)
    # a value column of customer: its nation's number
    c_val32 = np.char.replace(cust["c_nation"].astype(str), "NATION_",
                              "").astype(np.float32)
    c_val = on_card(c_val32, np.float32)
    d_key = on_card(date["d_datekey"], np.int32)
    d_val32 = date["d_yearmonthnum"].astype(np.float32)
    d_val = on_card(d_val32, np.float32)
    n = rows
    report = {"card": card, "world_size": world, "backend": backend,
              "rows": n}

    def record(name, ms, peak, nbytes, extra):
        report[name] = {"ms": round(ms, 4), "rows_per_s": round(n / ms * 1e3),
                        "peak_gib": round(peak / 2**30, 3),
                        "input_mb": round(nbytes / 1e6, 1), **extra}
        print(f"distributed {name}: {ms:.4f} ms (median of {DIST_REPS}), "
              f"{n / ms * 1e3:,.0f} rows/s, peak {peak / 2**30:.3f} GiB, "
              f"inputs {nbytes / 1e6:.1f} MB; "
              + json.dumps(extra), flush=True)

    # (a) grouped SUM/COUNT of lo_revenue by lo_orderdate
    G = len(date["d_datekey"])
    gs = make_distributed_group_sum(mesh, G)
    ms, peak, (sums, counts) = _median_ms(lambda: gs(o_date, o_rev))
    exp_c = np.bincount(lo["lo_orderdate"], minlength=G)
    exp_s = np.bincount(lo["lo_orderdate"], weights=o_rev32.astype(np.float64),
                        minlength=G)
    got_c, got_s = counts.cpu().numpy(), sums.cpu().numpy().astype(np.float64)
    assert np.array_equal(got_c, exp_c.astype(np.float32)), "group counts"
    # float32 sums of positive terms, added in any order: within count x
    # 2^-23 of the float64 sum of the same float32 values
    rel = np.abs(got_s - exp_s) / exp_s
    bound = np.maximum(exp_c, 1) * 2.0 ** -23
    assert (rel <= bound).all(), ("group sums", float((rel / bound).max()))
    record("group_sum", ms, peak, 8 * n, {
        "profile": _dist_profile("group_sum", lambda: gs(o_date, o_rev)),
        "groups": G, "counts": "exact", "sums_max_rel_err": float(rel.max()),
        "sums_rel_bound": "count * 2^-23"})

    # (b) shuffle join lineorder x customer on the customer key
    sj = make_shuffle_join(mesh, n)
    ms, peak, (k, lv, rv, ovf) = _median_ms(
        lambda: sj(o_cust, o_rev, c_key, c_val))
    k, lv, rv = (t.cpu().numpy() for t in (k, lv, rv))
    assert int(ovf) == 0, f"overflow {int(ovf)}"
    assert (k >= 0).sum() == n, "every lineorder row matches once"
    got = np.lexsort((lv, k))
    exp = np.lexsort((o_rev32, lo["lo_custkey"]))
    assert np.array_equal(k[got], lo["lo_custkey"][exp].astype(np.int32))
    assert np.array_equal(lv[got], o_rev32[exp])
    assert np.array_equal(rv, c_val32[k]), "right values"
    record("shuffle_join", ms, peak, 8 * n + 8 * len(c_val32),
           {"matched": int((k >= 0).sum()), "overflow": int(ovf),
            "profile": _dist_profile(
                "shuffle_join", lambda: sj(o_cust, o_rev, c_key, c_val))})

    # (c) broadcast join lineorder x date on the order date
    bj = make_broadcast_join(mesh)
    ms, peak, (k, lv, rv) = _median_ms(lambda: bj(o_date, o_rev, d_key, d_val))
    k, lv, rv = (t.cpu().numpy() for t in (k, lv, rv))
    assert np.array_equal(k, lo["lo_orderdate"].astype(np.int32))
    assert np.array_equal(lv, o_rev32) and np.array_equal(rv, d_val32[k])
    record("broadcast_join", ms, peak, 8 * n + 8 * G,
           {"matched": int((k >= 0).sum()),
            "profile": _dist_profile(
                "broadcast_join", lambda: bj(o_date, o_rev, d_key, d_val))})

    # (d) the compressed psum over mamba2-130m's parameter shapes
    shapes = {name: tuple(p.shape) for name, p in
              M.LM(get_config(DIST_ARCH), device="meta").named_parameters()}
    gen = torch.Generator(device=dev).manual_seed(seed)
    tree = {name: torch.randn(s, generator=gen, device=dev)
            for name, s in shapes.items()}
    elems = sum(t.numel() for t in tree.values())
    group = mesh.get_group("data")
    ms, peak, got = _median_ms(lambda: compressed_psum(tree, group))
    plain = psum_with_optional_compression(tree, group, False)
    rel = max(float((got[k] - plain[k]).abs().max()
                    / (plain[k].abs().max() + 1e-9)) for k in tree)
    assert rel < COMPRESS_REL_TOL, ("compressed psum", rel)
    cpu_group = dist.new_group([0], backend="gloo")
    cpu = {k: t.cpu() for k, t in tree.items()}
    exp = compressed_psum(cpu, cpu_group)
    for k in tree:
        q, s = quantize_int8(tree[k])
        q_cpu, s_cpu = quantize_int8(cpu[k])
        assert torch.equal(q.cpu(), q_cpu) and torch.equal(s.cpu(), s_cpu), k
        assert torch.equal(got[k].cpu(), exp[k]), k
    dist.destroy_process_group(cpu_group)
    report["compressed_psum"] = {
        "ms": round(ms, 4), "elements": elems, "leaves": len(tree),
        "elements_per_s": round(elems / ms * 1e3),
        "peak_gib": round(peak / 2**30, 3), "rel_err_vs_plain": rel,
        "card_vs_cpu": "int8 payloads, scales and result bit-equal",
        "profile": _dist_profile("compressed_psum",
                                 lambda: compressed_psum(tree, group))}
    print(f"distributed compressed_psum: {ms:.4f} ms (median of "
          f"{DIST_REPS}), {elems:,} float32 elements in {len(tree)} leaves "
          f"({DIST_ARCH}'s shapes), {elems / ms * 1e3:,.0f} elements/s, peak "
          f"{peak / 2**30:.3f} GiB; error against the plain "
          f"all-reduce {rel:.3e} of its largest magnitude (limit "
          f"{COMPRESS_REL_TOL}); card vs CPU: int8 payloads, scales and "
          f"result bit-equal", flush=True)
    return report


def prepare(seed: int):
    """Phases 1-2: the card's line, the build and its reports.  Returns
    (card line, device, rng); None without CUDA or the port's package."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return None
    # full float32 in float32 matrix products and convolutions (the Mamba2
    # conv), as the plain versions on the CPU compute them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no port package under {SRC}", file=sys.stderr)
        return None
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
    tensor_core_report(lib, _build.build_log())
    atomics_report(lib)
    _build.library()
    return card, torch.device("cuda"), np.random.default_rng(seed)


def sql_phases(dev, rng, lm: bool = True) -> tuple:
    """Phase 3 (the LM kernels' checks too with ``lm``) and the executor
    calls at the path's shapes; returns (checked, round trips)."""
    print("kernel checks against the plain versions on the card:",
          flush=True)
    checked = check_kernels(dev, rng, lm=lm)
    print("executor calls (numpy in, numpy out) at the path's shapes:",
          flush=True)
    round_trip = host_round_trips(rng)
    print(f"host_call_ms, {THREADS} threads at once: "
          + json.dumps(round_trip[str(THREADS)]), flush=True)
    print("host_call_ms, empty kernel (the floor): " + json.dumps(
        {n: round_trip[n]["empty"] for n in ("1", str(THREADS))}),
        flush=True)
    return checked, round_trip


def sql_kernels(seed: int = 0) -> int:
    """Phases 1-3 for the six SQL kernels and their executor calls, with no
    result line: a quick run after a change to an SQL kernel's body."""
    ready = prepare(seed)
    if ready is None:
        return 2
    card, dev, rng = ready
    checked, _ = sql_phases(dev, rng, lm=False)
    print("sql kernels: " + json.dumps(checked["timed"]), flush=True)
    print(card, flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=6_000_000,
                    help="lineorder rows (default 6,000,000, SSB SF1)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    ready = prepare(args.seed)
    if ready is None:
        return 2
    card, dev, rng = ready
    checked, round_trip = sql_phases(dev, rng)

    ssd_launches = serve_lm(dev, args.seed)
    moe = serve_moe(dev, args.seed)
    lm_launches = {"ssd_scan": ssd_launches, **flash_phase(dev, rng)}
    trained = train_lm(dev, args.seed)
    distributed = distributed_phase(card, args.rows, args.seed)
    work = os.path.join(HERE, "build", "chip_smoke_wh")
    launches = {**main_path(args.rows, work, round_trip["split"]),
                **lm_launches}

    print("launches by route and path: " + json.dumps(
        {r: launches.get(r, 0) for r in ROUTES}), flush=True)
    # hash_group's calls by path and G to the next power of two
    print("hash_group launches by path and G: " + json.dumps(
        {k: v for k, v in sorted(launches.items())
         if k.startswith("hash_group.") and ".G<=" in k}), flush=True)
    print("routes: " + json.dumps({
        r: {**checked["timed"][r], "source": src}
        for r, src in ROUTE_SOURCES.items()}), flush=True)
    kernels = []
    for k in PATH_KERNELS + LM_KERNELS:
        row = checked["timed"][k]
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCES[k],
            "replaces": REPLACES[k], "launches": launches[k],
            "max_abs_err": checked["err"][k], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], "graph_ms": row.get("graph_ms"),
            "host_call_ms": round_trip["1"].get(k),
            "large": checked["timed"].get(k + "@large"),
        })
        if k == "ssd_scan":
            kernels[-1]["n64"] = [checked["timed"][r] for r in
                                  ("ssd_scan@N64", "ssd_scan@N64 large")]
    print(json.dumps({"kernels": kernels}), flush=True)
    print("train: " + json.dumps(trained), flush=True)
    print("moe: " + json.dumps(moe), flush=True)
    print("distributed: " + json.dumps(distributed), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
