"""Central session-config key registry (the REP001 invariant).

Every key a session config may carry is declared here, exactly once, with
its default, its expected type(s), and whether it participates in plan
shaping (the plan-cache key).  ``session.DEFAULT_CONFIG`` and
``pipeline._PLANNING_KEYS`` are both *derived* from this table, so the two
can no longer drift apart — a drifted ``_PLANNING_KEYS`` silently shares
optimized plans across sessions whose configs should have produced
different plans.

The invariant lint (``python -m repro_torch.analysis``, checker REP001) enforces
the other direction: every ``config.get("...")`` call site in the warehouse
code must name a key declared here.  Before this registry existed a typo'd
key fell back to its default silently; now it is a lint failure at the call
site and a :class:`SessionConfig` warning at session creation.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class ConfigKey:
    """One declared session-config knob."""

    name: str
    default: object
    types: Tuple[type, ...]          # accepted value types (None always ok)
    planning: bool = False           # part of the plan-cache key?
    doc: str = ""


def _k(name, default, types, planning=False, doc=""):
    if not isinstance(types, tuple):
        types = (types,)
    return ConfigKey(name, default, types, planning, doc)


_KEYS = (
    # ----------------------------------------------------------- optimizer (§4)
    _k("cbo", True, bool, planning=True, doc="cost-based optimization"),
    _k("pushdown", True, bool, planning=True, doc="filter/project pushdown"),
    _k("join_reorder", True, bool, planning=True, doc="cost-based join order"),
    _k("transitive_inference", True, bool, planning=True,
       doc="predicate transit across join keys"),
    _k("partition_pruning", True, bool, planning=True),
    _k("prune_columns", True, bool, planning=True),
    _k("broadcast_threshold_rows", 200_000.0, (int, float), planning=True,
       doc="build sides below this broadcast instead of shuffling"),
    _k("mv_rewriting", True, bool, planning=True,
       doc="materialized-view rewrite (§4.4)"),
    _k("semijoin_reduction", True, bool, planning=True,
       doc="dynamic semijoin reducers (§4.6)"),
    _k("shared_work", True, bool, doc="shared-subplan detection (§4.5)"),
    _k("result_cache", True, bool, doc="query result cache (§4.3)"),
    _k("reopt_mode", "reoptimize", str,
       doc="off | overlay | reoptimize (§4.2)"),
    _k("overlay", {"broadcast_threshold_rows": 0.0}, dict,
       doc="config overrides applied on §4.2 overlay re-execution"),
    # ------------------------------------------------------------- runtime (§5)
    _k("llap", True, bool, doc="run vertices on the persistent LLAP pool"),
    _k("speculative_execution", False, bool),
    _k("mapjoin_max_rows", 50_000_000, int,
       doc="broadcast build-side row budget"),
    _k("num_containers", 4, int),
    # ---------------------------------------------------------------- ACID (§3)
    _k("compaction_enabled", True, bool),
    _k("compaction_minor_threshold", 10, int),
    _k("compaction_major_ratio", 0.2, (int, float)),
    # ------------------------------------------------------------------ kernels
    _k("engine", "cuda", str,
       doc="kernel backend: cuda (the GPU kernels; alias pallas) | ref "
           "(their plain torch versions on the CPU) | auto (numpy host "
           "paths)"),
    # -------------------------------------------------------------- WLM (§5.2)
    _k("user", None, str, doc="identity for resource-plan mappings"),
    _k("application", None, str),
    # ------------------------------------------------------------ async handles
    _k("stream_batch_rows", 4096, int,
       doc="rows per batch handed to QueryHandle.fetch_stream()"),
    # -------------------------------------------- pipelined exchanges (PR 3, §5)
    _k("exchange.pipeline", True, bool,
       doc="stream vertices concurrently through exchanges"),
    _k("exchange.batch_rows", 1024, int, doc="operator morsel size"),
    _k("exchange.buffer_rows", 65536, int, doc="per-edge in-memory row budget"),
    _k("exchange.buffer_bytes", 64 << 20, int),
    _k("exchange.spill", True, bool,
       doc="spill overflow to scratch (off: MemoryPressureError -> §4.2)"),
    _k("exchange.spill_dir", None, str),
    # ------------------------------------------------ shuffle service (PR 5, §4)
    _k("shuffle.partitions", "auto", (int, str), planning=True,
       doc='lane count per SHUFFLE edge; "auto" derives from CBO rows'),
    _k("shuffle.lane_batch_rows", 8192, int,
       doc="rows the ShuffleWriter coalesces per lane morsel"),
    _k("shuffle.auto_rows_per_partition", 32_768, int, planning=True,
       doc="auto mode: one lane per this many estimated input rows for "
           "consumers that already sit behind a SHUFFLE edge"),
    _k("shuffle.auto_scan_fed_rows_per_partition", 262_144, int,
       planning=True,
       doc="auto mode lane-payoff threshold for scan-fed consumers, where "
           "fan-out adds an exchange hop the single-lane plan fuses away "
           "(the BENCH_PR5 partitioned-DISTINCT regression)"),
    # --------------------------------------------- adaptive execution (PR 8)
    _k("adaptive.enabled", True, bool,
       doc="replan a running DAG from live lane telemetry (hot-lane "
           "split, payoff-gated fan-out collapse)"),
    _k("adaptive.skew_ratio", 4.0, (int, float),
       doc="split a shuffle lane whose observed rows exceed this ratio "
           "over the live lane median"),
    _k("adaptive.split_min_rows", 65_536, int,
       doc="never split a lane before it has at least this many rows"),
    _k("adaptive.split_ways", 0, int,
       doc="sub-lanes a hot lane splits into (0 = derive from cores)"),
    _k("adaptive.elide_copartition", True, bool, planning=True,
       doc="compile-time: reuse a shuffle join's lanes for a downstream "
           "grouped aggregate whose keys cover the join keys, eliding "
           "the second shuffle hop"),
    _k("adaptive.speculation", False, bool,
       doc="clone straggler lane consumers under the pipelined scheduler "
           "and swap consumers to the first finisher (forces lane "
           "retention while on)"),
    _k("adaptive.straggler_factor", 4.0, (int, float),
       doc="speculate a lane consumer running this many times longer "
           "than the median of its finished siblings"),
    _k("adaptive.straggler_min_s", 0.2, (int, float),
       doc="never speculate before a vertex has run this long"),
    # ---------------------------------------------------------- federation (§6)
    _k("federation.push_filters", True, bool, planning=True),
    _k("federation.push_projection", True, bool, planning=True),
    _k("federation.push_aggregate", True, bool, planning=True),
    _k("federation.push_limit", True, bool, planning=True),
    _k("federation.splits", 4, int, doc="split fan-out for external reads"),
    # -------------------------------------------------- serving tier (PR 6)
    _k("serving.shared_scans", True, bool,
       doc="attach concurrent queries to in-flight identical scans"),
    _k("serving.result_cache", True, bool,
       doc="serve repeated queries from the byte-bounded cache pre-admission"),
    # ------------------------------------------------- observability (PR 10)
    _k("obs.tracing", False, bool,
       doc="per-query structured tracing: spans for every pipeline stage, "
           "WLM admission wait, DAG vertex (compute vs exchange-wait vs "
           "spill-I/O), shuffle lane, federated split read, kernel "
           "dispatch, serving and adaptive event; export Chrome trace "
           "JSON via QueryHandle.trace() / Connection.export_trace(). "
           "Off by default — hot paths then pay one attribute test and "
           "allocate no span objects (also enabled process-wide by the "
           "REPRO_OBS_TRACING env var)"),
    _k("obs.query_log_size", 128, int,
       doc="capacity of the warehouse's always-on completed-query ring "
           "buffer (Connection.query_log()); read once at warehouse "
           "creation from this declared default"),
    _k("obs.trace_store_size", 32, int,
       doc="how many completed traced queries the warehouse retains for "
           "Connection.export_trace(query_id, path); oldest evict first; "
           "read once at warehouse creation from this declared default"),
    # -------------------------------------------------------- internal/debug
    _k("keep_acid_cols", False, bool,
       doc="internal: scans keep __rowid__/__writeid__ columns (DML reads)"),
    _k("debug_vertex_delay_s", 0.0, (int, float),
       doc="test hook: sleep per DAG vertex to make concurrency observable"),
    _k("debug.validate_plans", False, bool,
       doc="run the structural DAG validator on every compiled plan "
           "(also enabled process-wide by the REPRO_VALIDATE_PLANS env var)"),
    _k("debug.check_batches", False, bool,
       doc="runtime schema sanitizer: Exchange.put asserts every morsel "
           "conforms to the edge's declared schema (also enabled "
           "process-wide by the REPRO_CHECK_BATCHES env var)"),
)

CONFIG_KEYS: Dict[str, ConfigKey] = {k.name: k for k in _KEYS}

# the dict Session/Connection defaults are built from (former
# session.DEFAULT_CONFIG literal — session re-exports this one)
DEFAULT_CONFIG: Dict[str, object] = {k.name: k.default for k in _KEYS}

# config keys that change the shape of the optimized plan; part of the
# plan-cache key so sessions with different planning configs never share
# plans (former pipeline._PLANNING_KEYS literal)
PLANNING_KEYS: Tuple[str, ...] = tuple(k.name for k in _KEYS if k.planning)


def is_declared(name: str) -> bool:
    return name in CONFIG_KEYS


def check_value(name: str, value: object) -> Optional[str]:
    """Type-check one setting; returns a complaint string or None."""
    import numbers

    key = CONFIG_KEYS.get(name)
    if key is None:
        return f"unknown session config key {name!r}"
    if value is None or key.default is None:
        return None  # nullable keys; None always accepted
    complaint = (f"config key {name!r} expects "
                 f"{'/'.join(t.__name__ for t in key.types)}, "
                 f"got {type(value).__name__}")
    # bool is an int subclass — only accept it where bool is declared
    if isinstance(value, bool):
        return None if bool in key.types else complaint
    if isinstance(value, key.types):
        return None
    # numeric knobs accept any real number (numpy scalars included)
    if (int in key.types or float in key.types) \
            and isinstance(value, numbers.Real):
        return None
    return complaint


class UnknownConfigKeyWarning(UserWarning):
    """A session was created with a key the registry does not declare."""


class SessionConfig(dict):
    """A session's resolved config: defaults overlaid with user settings.

    Unknown keys *warn* instead of raising — the synchronous ``session()``
    path historically accepted any dict, and a hard error here would turn a
    silent-typo class into a breaking change for embedders; the strict path
    (``repro_torch.api.connect``) still rejects unknown keys outright.  The
    warning names the key and the call is otherwise honored.
    """

    def __init__(self, *overlays: dict):
        merged: Dict[str, object] = {}
        for o in overlays:
            merged.update(o)
        super().__init__(merged)
        for name in merged:
            if not is_declared(name):
                warnings.warn(
                    f"unknown session config key {name!r} (typo?); declared "
                    f"keys live in repro_torch.core.config_keys",
                    UnknownConfigKeyWarning,
                    stacklevel=3,
                )


def validate_config(config: dict, type_check: bool = False) -> list:
    """Complaints for unknown (and optionally mistyped) keys in ``config``."""
    out = []
    for name, value in config.items():
        if not is_declared(name):
            out.append(f"unknown session config key {name!r}")
        elif type_check:
            c = check_value(name, value)
            if c is not None:
                out.append(c)
    return out
