"""Vectorized plan execution (paper §5, [39]).

A pipelined interpreter over `VectorBatch`es.  Every operator is vectorized:
expressions evaluate to whole numpy column vectors; joins/aggregations use
factorized key codes.  Under a kernel engine (``engine: cuda|ref``),
predicate evaluation, hash-join probes and grouped aggregation are routed
through the kernels in ``repro_torch.kernels``: the hand-written CUDA kernels
on the GPU, or their plain torch versions on the CPU.  Morsels stay host
numpy arrays; each kernel call copies its inputs to the query's device and
its result back.

The executor also:
  * records per-operator actual cardinalities (for §4.2 re-optimization),
  * honors shared-work results (§4.5) via a per-query subplan cache,
  * enforces a broadcast-join memory budget, raising ``MemoryPressureError``
    to exercise the re-optimization path (§4.2).
"""
from __future__ import annotations

import re as _re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...kernels.bloom.ops import probe_bloom_filter
from ...kernels import registry
from ...kernels.registry import engine_device, host_call, upload
from ..acid import AcidTable
from ..bloomfilter import BloomFilter
from ..metastore import Metastore, Snapshot, WriteIdList
from ..obs.trace import make_span
from ..optimizer import plan as P
from ..sql import ast as A
from ..storage import SargPredicate
from .vector import DEFAULT_BATCH_ROWS, ROWID_COL, WRITEID_COL, VectorBatch


class ExecError(Exception):
    pass


class MemoryPressureError(ExecError):
    """Simulates the runtime errors (§4.2) that trigger re-optimization."""


class ExecContext:
    def __init__(
        self,
        hms: Metastore,
        snapshot: Snapshot,
        config: Optional[dict] = None,
        io=None,
        handlers=None,
        params: Tuple = (),
        cancel_token=None,
    ):
        self.hms = hms
        self.snapshot = snapshot
        self.config = config or {}
        self.io = io
        self.handlers = handlers or {}
        self.params = tuple(params)  # qmark placeholder values, by ordinal
        self.cancel_token = cancel_token  # CancelToken of an async handle
        # serving tier: SharedScanRegistry when serving.shared_scans is on
        self.shared_scans = None
        # observability (PR 10), resolved once per query by the execute
        # stage: the query's QueryTrace (None = tracing off) and the
        # warehouse MetricsRegistry — instrumented paths pay one attribute
        # test when off
        self.trace = None
        self.metrics = None
        self.engine = self.config.get("engine", "cuda")  # cuda | ref | auto
        self.device = engine_device(self.engine)  # where the kernels run
        self.op_stats: Dict[str, int] = {}  # plan key digest -> actual rows
        self.shared_keys: set = set()  # filled by shared-work optimizer (§4.5)
        self.subplan_cache: Dict[str, VectorBatch] = {}
        self.runtime_filter_cache: Dict[str, dict] = {}
        self._widlists: Dict[str, WriteIdList] = {}

    def widlist(self, table: str) -> WriteIdList:
        if table not in self._widlists:
            self._widlists[table] = self.hms.writeid_list(table, self.snapshot)
        return self._widlists[table]

    def record(self, node: P.PlanNode, rows: int) -> None:
        self.op_stats[node.digest()] = rows

    def kernel(self, name: str):
        """Resolve a compute kernel for this query's engine selection, as a
        numpy-in/numpy-out call on the query's device."""
        if self.trace is not None:
            self.trace.kernel_dispatch(name, self.engine)
        # looked up at call time, as the JAX package's executor does, so a
        # spy on ``registry.resolve`` sees every dispatch
        return host_call(registry.resolve(name, self.engine), self.device)


# ===========================================================================
# expression evaluation
# ===========================================================================
_NULL_STR = ""


def _lookup(batch: VectorBatch, col: A.Col) -> np.ndarray:
    key = col.qualified
    if key in batch.cols:
        return batch.cols[key]
    if col.table is None:
        # unqualified: match unique suffix
        hits = [k for k in batch.cols if k == col.name or k.endswith("." + col.name)]
        if len(hits) == 1:
            return batch.cols[hits[0]]
        if len(hits) > 1:
            raise ExecError(f"ambiguous column {col.name}: {hits}")
    raise ExecError(f"column {key} not found in {list(batch.cols)[:12]}...")


def _broadcast(value, n: int) -> np.ndarray:
    if value is None:
        return np.full(n, np.nan)
    if isinstance(value, bool):
        return np.full(n, value, dtype=bool)
    if isinstance(value, int):
        return np.full(n, value, dtype=np.int64)
    if isinstance(value, float):
        return np.full(n, value, dtype=np.float64)
    return np.full(n, value, dtype=f"U{max(len(str(value)), 1)}")


def _is_null_mask(v: np.ndarray) -> np.ndarray:
    if v.dtype.kind == "f":
        return np.isnan(v)
    if v.dtype.kind in ("U", "S"):
        return v == _NULL_STR if False else np.zeros(len(v), dtype=bool)
    return np.zeros(len(v), dtype=bool)


def _like_to_regex(pattern: str) -> str:
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(_re.escape(ch))
    return "^" + "".join(out) + "$"


_SCALAR_FUNCS = {}


def scalar_fn(name):
    def deco(f):
        _SCALAR_FUNCS[name] = f
        return f
    return deco


@scalar_fn("abs")
def _f_abs(args):
    return np.abs(args[0])


@scalar_fn("floor")
def _f_floor(args):
    return np.floor(args[0])


@scalar_fn("ceil")
def _f_ceil(args):
    return np.ceil(args[0])


@scalar_fn("round")
def _f_round(args):
    d = int(args[1][0]) if len(args) > 1 else 0
    return np.round(args[0], d)


@scalar_fn("lower")
def _f_lower(args):
    return np.char.lower(args[0].astype(str))


@scalar_fn("upper")
def _f_upper(args):
    return np.char.upper(args[0].astype(str))


@scalar_fn("length")
def _f_length(args):
    return np.char.str_len(args[0].astype(str)).astype(np.int64)


@scalar_fn("substr")
def _f_substr(args):
    start = int(args[1][0]) - 1
    ln = int(args[2][0]) if len(args) > 2 else None
    s = args[0].astype(str)
    return np.array([x[start:start + ln] if ln else x[start:] for x in s])


@scalar_fn("coalesce")
def _f_coalesce(args):
    out = args[0].copy()
    for nxt in args[1:]:
        m = _is_null_mask(out) | (np.isnan(out) if out.dtype.kind == "f" else False)
        out = np.where(m, nxt, out)
    return out


@scalar_fn("extract")
def _f_extract(args):  # extract(year, datestr) simplified
    part = args[0]
    vals = args[1].astype(str)
    idx = {"year": slice(0, 4), "month": slice(5, 7), "day": slice(8, 10)}[str(part[0]).lower()]
    return np.array([int(v[idx]) if len(v) >= 10 else -1 for v in vals], dtype=np.int64)


@scalar_fn("year")
def _f_year(args):
    return np.array([int(str(v)[:4]) if len(str(v)) >= 4 else -1 for v in args[0]],
                    dtype=np.int64)


def eval_expr(e: A.Expr, batch: VectorBatch, ctx: Optional[ExecContext] = None) -> np.ndarray:
    n = batch.num_rows
    if isinstance(e, A.Col):
        return _lookup(batch, e)
    if isinstance(e, A.Lit):
        return _broadcast(e.value, n)
    if isinstance(e, A.Param):
        if ctx is None:
            raise ExecError(f"parameter ?{e.index} outside an execution context")
        if e.index >= len(ctx.params):
            raise ExecError(
                f"unbound parameter ?{e.index}: only {len(ctx.params)} "
                "parameter value(s) supplied"
            )
        return _broadcast(ctx.params[e.index], n)
    if isinstance(e, A.BinOp):
        if e.op == "AND":
            l = eval_expr(e.left, batch, ctx).astype(bool)
            if not l.any():
                return l
            r = eval_expr(e.right, batch, ctx).astype(bool)
            return l & r
        if e.op == "OR":
            l = eval_expr(e.left, batch, ctx).astype(bool)
            r = eval_expr(e.right, batch, ctx).astype(bool)
            return l | r
        l = eval_expr(e.left, batch, ctx)
        r = eval_expr(e.right, batch, ctx)
        if e.op == "LIKE":
            rx = _re.compile(_like_to_regex(str(r[0]) if len(r) else ""))
            return np.array([bool(rx.match(str(x))) for x in l])
        if e.op == "||":
            return np.char.add(l.astype(str), r.astype(str))
        if l.dtype.kind in ("U", "S") or r.dtype.kind in ("U", "S"):
            l, r = l.astype(str), r.astype(str)
        ops = {
            "+": np.add, "-": np.subtract, "*": np.multiply,
            "%": np.mod,
            "=": np.equal, "!=": np.not_equal,
            "<": np.less, "<=": np.less_equal,
            ">": np.greater, ">=": np.greater_equal,
        }
        if e.op == "/":
            with np.errstate(divide="ignore", invalid="ignore"):
                return np.divide(l.astype(np.float64), r.astype(np.float64))
        return ops[e.op](l, r)
    if isinstance(e, A.UnOp):
        v = eval_expr(e.operand, batch, ctx)
        return ~v.astype(bool) if e.op == "NOT" else -v
    if isinstance(e, A.Func):
        if e.name in _SCALAR_FUNCS:
            args = [eval_expr(a, batch, ctx) for a in e.args]
            return _SCALAR_FUNCS[e.name](args)
        raise ExecError(f"unknown scalar function {e.name}")
    if isinstance(e, A.Case):
        result = None
        assigned = np.zeros(n, dtype=bool)
        for cond, val in e.whens:
            m = eval_expr(cond, batch, ctx).astype(bool) & ~assigned
            v = eval_expr(val, batch, ctx)
            if result is None:
                result = np.zeros(n, dtype=v.dtype) if v.dtype.kind != "U" else np.full(n, "", dtype=f"U64")
                if v.dtype.kind == "f" or result.dtype.kind == "f":
                    result = result.astype(np.float64) + np.nan
            result = np.where(m, v, result)
            assigned |= m
        if e.otherwise is not None:
            v = eval_expr(e.otherwise, batch, ctx)
            result = np.where(~assigned, v, result)
        return result
    if isinstance(e, A.InList):
        v = eval_expr(e.expr, batch, ctx)
        vals = [x.value for x in e.values]  # type: ignore
        if v.dtype.kind in ("U", "S"):
            vals = [str(x) for x in vals]
        m = np.isin(v, np.array(vals))
        return ~m if e.negated else m
    if isinstance(e, A.Between):
        v = eval_expr(e.expr, batch, ctx)
        lo = eval_expr(e.low, batch, ctx)
        hi = eval_expr(e.high, batch, ctx)
        m = (v >= lo) & (v <= hi)
        return ~m if e.negated else m
    if isinstance(e, A.IsNull):
        v = eval_expr(e.expr, batch, ctx)
        m = _is_null_mask(v)
        return ~m if e.negated else m
    if isinstance(e, A.Cast):
        v = eval_expr(e.expr, batch, ctx)
        t = e.to_type.upper()
        if t.startswith(("INT", "BIGINT")):
            return v.astype(np.float64).astype(np.int64) if v.dtype.kind != "U" else np.array([int(float(x)) for x in v], dtype=np.int64)
        if t.startswith("FLOAT"):
            return v.astype(np.float32)  # Hive FLOAT is single-precision
        if t.startswith(("DOUBLE", "DECIMAL", "REAL")):
            return v.astype(np.float64)
        return v.astype(str)
    raise ExecError(f"cannot evaluate {type(e).__name__}")


# ===========================================================================
# factorized keys (shared by join/aggregate/window)
# ===========================================================================
def _factorize_pair(l: np.ndarray, r: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    if l.dtype.kind in ("U", "S") or r.dtype.kind in ("U", "S"):
        l, r = l.astype(str), r.astype(str)
    elif l.dtype != r.dtype:
        l, r = l.astype(np.float64), r.astype(np.float64)
    cat = np.concatenate([l, r])
    uniq, codes = np.unique(cat, return_inverse=True)
    return codes[: len(l)], codes[len(l):], len(uniq)


def _combine_codes(pairs: List[Tuple[np.ndarray, np.ndarray, int]]):
    lc = pairs[0][0].astype(np.int64)
    rc = pairs[0][1].astype(np.int64)
    for codes_l, codes_r, k in pairs[1:]:
        lc = lc * k + codes_l
        rc = rc * k + codes_r
    return lc, rc


def _group_codes(batch: VectorBatch, keys: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """Return (codes, first_occurrence_index) for composite group keys."""
    if not keys:
        return np.zeros(batch.num_rows, dtype=np.int64), np.array([0] if batch.num_rows else [], dtype=np.int64)
    cols = [batch.cols[k] for k in keys]
    if len(cols) == 1:
        uniq, first, codes = np.unique(cols[0], return_index=True, return_inverse=True)
        return codes.astype(np.int64), first
    rec = np.rec.fromarrays(cols)
    uniq, first, codes = np.unique(rec, return_index=True, return_inverse=True)
    return codes.astype(np.int64), first


# ===========================================================================
# operators
# ===========================================================================
# how a partial aggregate folds into the running incremental-merge state:
# partial SUMs and COUNTs add, partial MIN/MAX re-minimize/-maximize
_FOLD_FN = {"sum": "sum", "count": "sum", "min": "min", "max": "max"}


class _KernelBloomProbe:
    """Adapter routing runtime-filter bloom probes through the kernel
    registry (``bloom_probe`` under ``engine: cuda|ref``, on the query's
    device) while presenting the ``might_contain`` surface the scan I/O
    layer expects; every probe is one traced kernel dispatch.  The filter's
    bitset goes to the device once, here, and every stripe's probe reads
    it there."""

    def __init__(self, bf: BloomFilter, ctx: ExecContext):
        self._bf = bf
        self._ctx = ctx
        self._bits = upload(bf.bits.view(np.uint32), ctx.device,
                            "bloom_probe")

    def might_contain(self, values: np.ndarray) -> np.ndarray:
        ctx = self._ctx
        if ctx.trace is not None:
            ctx.trace.kernel_dispatch("bloom_probe", ctx.engine)
        return probe_bloom_filter(self._bf, values, ctx.engine, ctx.device,
                                  bits=self._bits)


class _BuildTable:
    """Build-side dictionary state for streaming hash-join probes.

    The build side's key columns are dictionary-encoded once (sorted
    uniques); every probe chunk then maps its key values into build codes —
    via the ``key_lookup`` kernel under ``engine: cuda|ref`` — so probing
    is O(chunk) instead of re-factorizing the whole build side per morsel.
    Under a kernel engine each numeric key column's dictionary is cast to
    float32 and tested once, here, and kept on the query's device for the
    kernel; a column whose dictionary float32 does not hold exactly takes
    the numpy path.
    """

    def __init__(self, rb: VectorBatch, right_keys, left_keys,
                 lproto: VectorBatch, ctx: ExecContext):
        self.ctx = ctx
        self.left_keys = list(left_keys)
        # (uniq_sorted, cast, cardinality+1, device dictionary or None) per
        # key column
        self.keys = []
        rc = None
        for rk, lk in zip(right_keys, left_keys):
            rv, lv = rb.cols[rk], lproto.cols[lk]
            if rv.dtype.kind in ("U", "S") or lv.dtype.kind in ("U", "S"):
                cast: Optional[type] = str
                rv = rv.astype(str)
            elif rv.dtype != lv.dtype:
                cast = float
                rv = rv.astype(np.float64)
            else:
                cast = None
            uniq, inv = np.unique(rv, return_inverse=True)
            k = np.int64(len(uniq) + 1)
            self.keys.append((uniq, cast, k, self._dictionary(uniq)))
            inv = inv.astype(np.int64)
            rc = inv if rc is None else rc * k + inv
        self.order = np.argsort(rc, kind="stable")
        self.rc_sorted = rc[self.order]

    def probe_codes(self, lb: VectorBatch) -> np.ndarray:
        """Combined build codes for a probe chunk; -1 marks no-match rows."""
        lc, valid = None, None
        for (uniq, cast, k, dictionary), lk in zip(self.keys, self.left_keys):
            v = lb.cols[lk]
            if cast is str:
                v = v.astype(str)
            elif cast is float:
                v = v.astype(np.float64)
            codes = self._lookup(uniq, dictionary, v)
            ok = codes >= 0
            valid = ok if valid is None else (valid & ok)
            c = np.where(ok, codes, 0)
            lc = c if lc is None else lc * k + c
        if lc is None:
            return np.full(lb.num_rows, -1, dtype=np.int64)
        return np.where(valid, lc, np.int64(-1))

    def _dictionary(self, uniq: np.ndarray):
        """The key column's dictionary as float32 on the query's device,
        for the ``key_lookup`` kernel; None under ``engine: auto``, for
        non-numeric keys, and where the cast does not round-trip (the
        kernel's contract is float32)."""
        if (self.ctx.engine == "auto" or len(uniq) == 0
                or uniq.dtype.kind not in "iuf"):
            return None
        u32 = uniq.astype(np.float32)
        if not np.array_equal(u32.astype(uniq.dtype), uniq):
            return None
        return upload(u32, self.ctx.device, "key_lookup")

    def _lookup(self, uniq: np.ndarray, dictionary,
                vals: np.ndarray) -> np.ndarray:
        if len(uniq) == 0:
            return np.full(len(vals), -1, dtype=np.int64)
        if dictionary is not None and vals.dtype.kind in "iuf":
            # the probe values' float32 cast must round-trip too
            v32 = vals.astype(np.float32)
            if np.array_equal(v32.astype(vals.dtype), vals):
                fn = self.ctx.kernel("key_lookup")
                return np.asarray(fn(dictionary, v32)).astype(np.int64)
        idx = np.minimum(np.searchsorted(uniq, vals), len(uniq) - 1)
        found = uniq[idx] == vals
        return np.where(found, idx, -1).astype(np.int64)


class Executor:
    """Pipelined interpreter: operators are generators over ``VectorBatch``
    morsels (``exchange.batch_rows``, default ``DEFAULT_BATCH_ROWS``).

    ``stream`` is the primary entry point; scans, filters, projects, limits
    and UNION ALL pipeline chunk-by-chunk, while pipeline breakers (join
    build sides, grouped aggregation, sort, window, DISTINCT union)
    accumulate incremental-merge state and then stream their output in
    morsels.  ``execute`` materializes a stream for callers that need the
    whole relation (DML, MV maintenance).  The cancel token is observed at
    every batch boundary, so kill/cancel latency is bounded by one morsel.
    """

    def __init__(self, ctx: ExecContext):
        self.ctx = ctx
        self.batch_rows = int(
            ctx.config.get("exchange.batch_rows", DEFAULT_BATCH_ROWS)
            or DEFAULT_BATCH_ROWS
        )

    def execute(self, node: P.PlanNode) -> VectorBatch:
        chunks = list(self.stream(node))
        return chunks[0] if len(chunks) == 1 else VectorBatch.concat(chunks)

    def stream(self, node: P.PlanNode):
        """Yield the node's output as a sequence of morsels.

        Every operator stream yields at least one (possibly empty) batch so
        downstream operators always see the output schema.
        """
        key = node.key()
        cached = self.ctx.subplan_cache.get(key)
        if cached is not None:  # shared-work reuse (§4.5)
            yield from self._emit(cached)
            return
        if key in self.ctx.shared_keys:
            # shared subplans materialize once, then replay per consumer
            out = VectorBatch.concat(list(self._dispatch(node)))
            self.ctx.record(node, out.num_rows)
            self.ctx.subplan_cache[key] = out
            yield from self._emit(out)
            return
        rows, first = 0, True
        for chunk in self._dispatch(node):
            self._checkpoint()
            if chunk.num_rows == 0 and not first:
                continue
            first = False
            rows += chunk.num_rows
            yield chunk
        self.ctx.record(node, rows)

    def _dispatch(self, node: P.PlanNode):
        method = getattr(self, "_stream_" + type(node).__name__.lower(), None)
        if method is None:
            raise ExecError(f"no operator for {type(node).__name__}")
        return method(node)

    def _checkpoint(self) -> None:
        """Cancellation point at every batch boundary (bounds cancel/kill
        latency — including inside speculated vertex clones — to one morsel)."""
        token = self.ctx.cancel_token
        if token is not None:
            token.check()

    def _emit(self, batch: VectorBatch):
        if batch.num_rows == 0:
            yield batch  # schema-carrying empty morsel
            return
        yield from batch.iter_chunks(self.batch_rows)

    def _collect(self, node: P.PlanNode) -> VectorBatch:
        return VectorBatch.concat(list(self.stream(node)))

    # ---- scans -------------------------------------------------------------
    def _stream_scan(self, node: P.Scan):
        desc = node.table
        tbl = AcidTable(desc, self.ctx.hms)
        wid = self.ctx.widlist(desc.name)

        # sargable predicate extraction from the pushed filter (§5.1)
        sargs = _extract_sargs(node.pushed_filter) if node.pushed_filter else []

        # dynamic semijoin reducers (§4.6): evaluate producers, build filters
        runtime_blooms: Dict[str, object] = {}
        part_value_sets: Dict[str, np.ndarray] = {}
        for rf in node.runtime_filters:
            res = self._runtime_filter_values(rf)
            if rf.kind == "partition":
                part_value_sets[rf.target_column] = res["values"]
            else:
                bloom = res["bloom"]
                if self.ctx.engine != "auto":
                    # route stripe-level probes through the kernel registry
                    bloom = _KernelBloomProbe(bloom, self.ctx)
                runtime_blooms[rf.target_column] = bloom
                sargs.append(SargPredicate(rf.target_column, ">=", res["min"]))
                sargs.append(SargPredicate(rf.target_column, "<=", res["max"]))

        pcols = desc.partition_cols

        def part_filter(pvals: tuple) -> bool:
            if node.partition_filter is not None:
                b = VectorBatch({
                    f"{node.alias}.{c}": _broadcast(v, 1)
                    for c, v in zip(pcols, pvals)
                })
                if not bool(eval_expr(node.partition_filter, b, self.ctx)[0]):
                    return False
            for col, values in part_value_sets.items():
                if col in pcols:
                    v = pvals[pcols.index(col)]
                    if v not in values:
                        return False  # dynamic partition pruning (§4.6)
            return True

        want = [c for c in node.columns]
        keep_acid = self.ctx.config.get("keep_acid_cols", False)
        qualify = lambda b: b.rename(  # noqa: E731
            {c: f"{node.alias}.{c}" for c in b.column_names
             if not c.startswith("__")}
        )
        pushed = (_qualify(node.pushed_filter, node.alias)
                  if node.pushed_filter is not None else None)
        yielded = False
        try:
            for pvals, b in tbl.scan_chunks(
                wid,
                columns=want,
                sarg_preds=[s for s in sargs if s.column not in pcols],
                runtime_blooms=runtime_blooms or None,
                partition_filter=part_filter,
                io=self.ctx.io,
                keep_acid_cols=keep_acid or node.min_writeid is not None,
            ):
                if node.min_writeid is not None:
                    # incremental MV rebuild: only rows above the build snapshot (§4.4)
                    b = b.select(b.cols[WRITEID_COL] > node.min_writeid)
                    if not keep_acid:
                        b = b.drop_acid_cols()
                b = qualify(b)
                if pushed is not None and b.num_rows:
                    b = b.select(self._filter_mask(pushed, b))
                if b.num_rows == 0:
                    if not yielded:
                        yield b
                        yielded = True
                    continue
                for chunk in b.iter_chunks(self.batch_rows):
                    yield chunk
                    yielded = True
        except OSError as exc:
            # a concurrent DROP TABLE purged the data directory out from
            # under this snapshot: fail cleanly (the exchange propagates the
            # error to every consumer) instead of surfacing a partial scan
            # as a bare file error
            if not self.ctx.hms.table_exists(desc.name):
                raise ExecError(
                    f"table {desc.name} was dropped during an in-flight "
                    f"scan; partial results discarded"
                ) from exc
            raise
        if not yielded:
            # schema-carrying empty batch; _empty_batch holds only data
            # columns, so directory-encoded partition columns are injected
            # here (chunked scans yield nothing when every stripe filters
            # out, unlike the old per-partition batches)
            from ..acid import _np_dtype

            out = tbl._empty_batch(want)
            for col in desc.partition_cols:
                if col in want and col not in out.cols:
                    out = out.with_column(
                        col, np.empty(0, dtype=_np_dtype(desc.dtype_of(col))))
            yield qualify(out)

    def _runtime_filter_values(self, rf: P.RuntimeFilterSpec) -> dict:
        ck = rf.key()
        if ck in self.ctx.runtime_filter_cache:
            return self.ctx.runtime_filter_cache[ck]
        producer_out = self.execute(rf.producer)
        vals = producer_out.cols[rf.producer_column]
        vals = np.unique(vals)
        res = {"values": vals}
        if rf.kind == "index":
            bf = BloomFilter.for_expected(len(vals))
            if len(vals):
                bf.add(vals)
            res["bloom"] = bf
            res["min"] = vals.min().item() if len(vals) else 0
            res["max"] = vals.max().item() if len(vals) else 0
        self.ctx.runtime_filter_cache[ck] = res
        return res

    def _stream_federatedscan(self, node: P.FederatedScan):
        """Split-parallel streaming reads through the DataSource API.

        The connector's :class:`ScanBuilder` is rebuilt from the negotiated
        spec; each split's reader is a generator yielding morsels, so
        external rows stream through the exchange layer (and observe the
        cancel token at every batch boundary) like native scans.  Compile-
        time split expansion pins one split per vertex; an unexpanded node
        (synchronous helpers, MV maintenance) drains every split inline.
        """
        from ..federation.datasource import apply_spec

        handler = self.ctx.handlers.get(node.table.handler)
        if handler is None:
            raise ExecError(f"no storage handler registered: {node.table.handler}")
        builder = handler.scan_builder(node.table, self.ctx.config)
        apply_spec(builder, node.spec)
        splits = [node.split] if node.split is not None \
            else (builder.to_splits() or [None])
        out_names = node.output_names()
        yielded = False
        trace = self.ctx.trace
        for i, split in enumerate(splits):
            # one span per federated split drain (tracing off: the shared
            # no-op context manager — no allocation per split)
            with make_span(trace, f"fed:{node.table.name}.split{i}",
                           "federation", pinned=node.split is not None):
                if self.ctx.metrics is not None:
                    self.ctx.metrics.inc("federation.splits_read")
                for batch in builder.read_split(split):
                    # cancel point per connector batch: a filtered-out batch
                    # yields no chunk downstream, so without this a cancelled
                    # query keeps draining the remote split to its end
                    self._checkpoint()
                    if node.spec is not None:
                        # connector outputs follow the spec's column order
                        b = batch.rename(
                            dict(zip(batch.column_names, out_names)))
                    else:
                        b = batch.rename(
                            {c: f"{node.alias}.{c}"
                             for c in batch.column_names})
                    if b.num_rows == 0:
                        if not yielded:
                            yield b
                            yielded = True
                        continue
                    for chunk in b.iter_chunks(self.batch_rows):
                        yield chunk
                        yielded = True
        if not yielded:
            empty = builder.empty_batch()
            yield empty.rename(dict(zip(empty.column_names, out_names)))

    # ---- relational ops ------------------------------------------------------
    def _stream_filter(self, node: P.Filter):
        for b in self.stream(node.input):
            if b.num_rows == 0:
                yield b
                continue
            yield b.select(self._filter_mask(node.predicate, b))

    def _filter_mask(self, predicate: A.Expr, b: VectorBatch) -> np.ndarray:
        # engine != auto routes sargable conjunctions through the registered
        # filter kernel (cuda or torch ref) instead of the numpy interpreter
        if self.ctx.engine != "auto":
            compiled = _compile_kernel_filter(predicate, b)
            if compiled is not None:
                cols, ops, lits = compiled
                fn = self.ctx.kernel("filter_eval")
                return np.asarray(fn(cols, ops, lits)).astype(bool)
        return eval_expr(predicate, b, self.ctx).astype(bool)

    def _stream_project(self, node: P.Project):
        for b in self.stream(node.input):
            yield VectorBatch({n: eval_expr(e, b, self.ctx)
                               for e, n in node.exprs})

    def _stream_valuesnode(self, node: P.ValuesNode):
        one = VectorBatch({"__dummy__": np.zeros(1)})
        cols: Dict[str, list] = {n: [] for n in node.names}
        for row in node.rows:
            for n, e in zip(node.names, row):
                cols[n].append(eval_expr(e, one, self.ctx)[0])
        yield from self._emit(VectorBatch({n: np.array(v)
                                           for n, v in cols.items()}))

    def _stream_union(self, node: P.Union):
        names = node.output_names()
        # mixed-dtype branches (int64 UNION ALL float64, ...) must emit one
        # consistent promoted dtype per column — numpy promotion, taken from
        # the inferred schema — instead of flickering per source chunk
        promote = _union_promotions(node)
        if node.all:
            # UNION ALL is streaming-safe: chunks pass through aligned
            for i in node.inputs:
                for o in self.stream(i):
                    yield _promoted(VectorBatch(dict(zip(
                        names, (o.cols[c] for c in o.column_names)))), promote)
            return
        # DISTINCT union stays a pipeline breaker (dedup needs the full set)
        aligned = [
            _promoted(VectorBatch(dict(zip(
                names, (o.cols[c] for c in o.column_names)))), promote)
            for i in node.inputs for o in self.stream(i)
        ]
        out = VectorBatch.concat(aligned)
        codes, first = _group_codes(out, names)
        yield from self._emit(out.take(np.sort(first)))

    def _stream_limit(self, node: P.Limit):
        remaining = int(node.n)
        gen = self.stream(node.input)
        first = True
        for b in gen:
            take = b if b.num_rows <= remaining else b.slice(0, remaining)
            remaining -= take.num_rows
            if first or take.num_rows:
                yield take
            first = False
            if remaining <= 0:
                # early-out: stop pulling upstream morsels.  Abandoned
                # upstream streams skip their ctx.record() on purpose — a
                # partial row count would poison §4.2 reoptimization stats
                gen.close()
                return

    def _stream_sort(self, node: P.Sort):
        # pipeline breaker: accumulate morsels, sort once, stream the output
        b = self._collect(node.input)
        yield from self._emit(
            b.sort_by([k for k, _ in node.keys], [d for _, d in node.keys])
        )

    # ---- join ----------------------------------------------------------------
    def _stream_join(self, node: P.Join):
        # build side: the pipeline breaker.  Chunks accumulate incrementally
        # and broadcast builds fail fast the moment they exceed the budget,
        # instead of after materializing the whole side.
        limit = (self.ctx.config.get("mapjoin_max_rows", 10_000_000)
                 if node.strategy == "broadcast" else None)
        build_chunks, build_rows = [], 0
        for rb_chunk in self.stream(node.right):
            build_rows += rb_chunk.num_rows
            if limit is not None and build_rows > limit:
                raise MemoryPressureError(
                    f"broadcast build side {build_rows} rows exceeds {limit}"
                )
            build_chunks.append(rb_chunk)
        rb = VectorBatch.concat(build_chunks)

        if node.kind == "cross":
            for lb in self.stream(node.left):
                li = np.repeat(np.arange(lb.num_rows), rb.num_rows)
                ri = np.tile(np.arange(rb.num_rows), lb.num_rows)
                out = _concat_sides(lb.take(li), rb.take(ri))
                if node.residual is not None and out.num_rows:
                    out = out.select(
                        eval_expr(node.residual, out, self.ctx).astype(bool))
                yield out
            return

        if node.kind in ("left", "full"):
            # the padded side pads with NaN (float64): cast its numeric
            # columns up front so matched and unmatched chunks agree on one
            # dtype instead of flickering int64/float64 per morsel
            rb = _null_extendable(rb)

        # probe side streams: each morsel joins against the build dictionary
        probe: Optional[_BuildTable] = None
        rmatched = np.zeros(rb.num_rows, dtype=bool)
        lproto: Optional[VectorBatch] = None
        for lb in self.stream(node.left):
            if node.kind == "full":
                lb = _null_extendable(lb)
            if probe is None:
                lproto = lb
                probe = _BuildTable(rb, node.right_keys, node.left_keys,
                                    lb, self.ctx)
            lc = probe.probe_codes(lb)
            lo = np.searchsorted(probe.rc_sorted, lc, side="left")
            hi = np.searchsorted(probe.rc_sorted, lc, side="right")
            counts = np.where(lc < 0, 0, hi - lo)

            if node.kind in ("semi", "anti"):
                mask = counts > 0 if node.kind == "semi" else counts == 0
                if node.residual is not None and node.kind == "semi":
                    li, ri = _expand_matches(lo, counts, probe.order)
                    joined = _concat_sides(lb.take(li), rb.take(ri))
                    ok = eval_expr(node.residual, joined, self.ctx).astype(bool)
                    good_left = np.unique(li[ok])
                    mask = np.zeros(lb.num_rows, dtype=bool)
                    mask[good_left] = True
                yield lb.select(mask)
                continue

            li, ri = _expand_matches(lo, counts, probe.order)
            joined = _concat_sides(lb.take(li), rb.take(ri))
            if node.residual is not None and joined.num_rows:
                ok = eval_expr(node.residual, joined, self.ctx).astype(bool)
                joined = joined.select(ok)
                li, ri = li[ok], ri[ok]

            if node.kind == "inner":
                yield joined
                continue
            if node.kind not in ("left", "full"):
                raise ExecError(f"join kind {node.kind} unsupported")
            matched = np.zeros(lb.num_rows, dtype=bool)
            if len(li):
                matched[li] = True
            unmatched = lb.select(~matched)
            null_right = _null_batch(rb, unmatched.num_rows)
            yield VectorBatch.concat(
                [joined, _concat_sides(unmatched, null_right)])
            if node.kind == "full" and len(ri):
                rmatched[ri] = True
        if node.kind == "full":
            runmatched = rb.select(~rmatched)
            null_left = _null_batch(lproto, runmatched.num_rows)
            yield _concat_sides(null_left, runmatched)

    # ---- aggregate -------------------------------------------------------------
    def _stream_aggregate(self, node: P.Aggregate):
        mergeable = node.grouping_sets is None and all(
            s.fn in _FOLD_FN for s in node.aggs
        )
        if not mergeable:
            yield from self._emit(self._aggregate_materialized(node))
            return
        # incremental-merge: per-morsel partial aggregates fold into a
        # running state (keys + partial columns), never one giant concat.
        # DISTINCT aggregates stream too: each spec keeps an incremental
        # per-group hash set — the unique (group keys, value) rows seen so
        # far — and the final fn (COUNT/SUM/MIN/MAX) evaluates over that
        # set, instead of materializing the whole input (under the
        # partitioned shuffle service that set is per-partition, so the
        # state a clone holds is its lane's share of the value domain).
        keys = node.group_keys
        plain = [s for s in node.aggs if not s.distinct]
        distincts = [s for s in node.aggs if s.distinct]
        state: Optional[VectorBatch] = None
        pending: List[VectorBatch] = []
        pending_rows = 0
        dstate: Dict[str, Optional[VectorBatch]] = {s.out_name: None
                                                    for s in distincts}
        dpending: Dict[str, List[VectorBatch]] = {s.out_name: []
                                                  for s in distincts}
        dpending_rows: Dict[str, int] = {s.out_name: 0 for s in distincts}
        first_chunk: Optional[VectorBatch] = None
        for chunk in self.stream(node.input):
            if first_chunk is None:
                first_chunk = chunk
            if chunk.num_rows == 0:
                continue
            part = self._aggregate_once(chunk, keys, plain)
            pending.append(part)
            pending_rows += part.num_rows
            # doubling schedule: merge once pending outgrows the running
            # state, so high-cardinality groupings pay O(n log n) total
            # merge work instead of re-folding the full state per morsel
            threshold = max(state.num_rows if state is not None else 0,
                            self.batch_rows, 4096)
            if pending_rows >= threshold:
                state = self._merge_partials(state, pending, keys, plain)
                pending, pending_rows = [], 0
            for s in distincts:
                vals = eval_expr(s.arg, chunk, self.ctx)
                d = VectorBatch({**{k: chunk.cols[k] for k in keys},
                                 "__dv__": vals})
                valid = ~_is_null_mask(vals)
                if vals.dtype.kind == "f":
                    valid &= ~np.isnan(vals)
                d = _dedupe(d.select(valid), keys + ["__dv__"])
                if d.num_rows == 0:
                    continue
                dpending[s.out_name].append(d)
                dpending_rows[s.out_name] += d.num_rows
                ds = dstate[s.out_name]
                dthresh = max(ds.num_rows if ds is not None else 0,
                              self.batch_rows, 4096)
                if dpending_rows[s.out_name] >= dthresh:
                    parts = ([ds] if ds is not None else []) \
                        + dpending[s.out_name]
                    dstate[s.out_name] = _dedupe(VectorBatch.concat(parts),
                                                 keys + ["__dv__"])
                    dpending[s.out_name] = []
                    dpending_rows[s.out_name] = 0
        if pending:
            state = self._merge_partials(state, pending, keys, plain)
        if state is None:
            # empty input: global aggregates still produce their single row
            src = first_chunk if first_chunk is not None else VectorBatch({})
            state = self._aggregate_once(src, keys, plain)
        for s in distincts:
            parts = ([dstate[s.out_name]] if dstate[s.out_name] is not None
                     else []) + dpending[s.out_name]
            dstate[s.out_name] = (_dedupe(VectorBatch.concat(parts),
                                          keys + ["__dv__"])
                                  if parts else None)
        if distincts:
            state = self._attach_distinct_counts(state, keys, distincts,
                                                 dstate)
        yield from self._emit(state.project(node.output_names()))

    def _attach_distinct_counts(self, state: VectorBatch, keys: List[str],
                                distincts, dstate) -> VectorBatch:
        """Evaluate each DISTINCT spec's fn (COUNT/SUM/MIN/MAX) over its
        per-group hash-set state, aligned to the running state's group rows
        (COUNT 0 / others NULL for groups whose every value was NULL)."""
        out = dict(state.cols)
        ng = state.num_rows if keys else 1
        for s in distincts:
            plain = P.AggSpec(s.fn, s.arg, False, s.out_name)
            d = dstate[s.out_name]
            if d is None or d.num_rows == 0 or ng == 0:
                codes = np.empty(0, dtype=np.int64)
                vals = np.empty(0)
            elif keys:
                # map each unique (keys, value) row to its state group row;
                # every distinct-state group also exists in the running
                # state (its rows flowed through the plain fold), so all
                # codes match — the guard covers NaN-keyed groups
                pairs = [_factorize_pair(state.cols[k], d.cols[k])
                         for k in keys]
                sc, dc = _combine_codes(pairs)
                order = np.argsort(sc, kind="stable")
                pos = np.searchsorted(sc[order], dc)
                rows = order[np.minimum(pos, ng - 1)]
                found = sc[rows] == dc
                codes, vals = rows[found], d.cols["__dv__"][found]
            else:
                codes = np.zeros(d.num_rows, dtype=np.int64)
                vals = d.cols["__dv__"]
            out[s.out_name] = _agg_column(plain, vals, codes, ng)
        return VectorBatch(out)

    def _merge_partials(self, state: Optional[VectorBatch],
                        partials: List[VectorBatch], keys: List[str],
                        aggs) -> VectorBatch:
        parts = ([state] if state is not None else []) + partials
        if len(parts) == 1:
            return parts[0]
        cat = VectorBatch.concat(parts)
        codes, first = _group_codes(cat, keys)
        ng = len(first) if keys else 1
        out: Dict[str, np.ndarray] = {}
        for k in keys:
            out[k] = cat.cols[k][np.sort(first)]
        order_of_first = np.argsort(first) if keys else np.array([0])
        remap = np.empty(ng, dtype=np.int64)
        remap[order_of_first] = np.arange(ng)
        codes2 = remap[codes] if cat.num_rows else codes
        for spec in aggs:
            fold = P.AggSpec(_FOLD_FN[spec.fn], None, False, spec.out_name)
            out[spec.out_name] = _agg_column(
                fold, cat.cols[spec.out_name], codes2, ng)
        return VectorBatch(out)

    def _aggregate_materialized(self, node: P.Aggregate) -> VectorBatch:
        """Non-mergeable shapes (DISTINCT aggregates, grouping sets) fall
        back to materializing the input."""
        b = self._collect(node.input)
        if node.grouping_sets is not None:
            parts = []
            for keyset in node.grouping_sets:
                sub = self._aggregate_once(b, keyset, node.aggs)
                # missing keys -> NULL columns, aligned to full output
                for k in node.group_keys:
                    if k not in keyset:
                        proto = b.cols[k]
                        sub = sub.with_column(k, _null_like(proto, sub.num_rows))
                parts.append(sub.project(node.output_names()))
            return VectorBatch.concat(parts)
        return self._aggregate_once(b, node.group_keys, node.aggs).project(
            node.output_names()
        )

    def _aggregate_once(self, b: VectorBatch, keys: List[str], aggs) -> VectorBatch:
        codes, first = _group_codes(b, keys)
        ng = len(first) if keys else (1 if True else 0)
        if not keys:
            ng = 1
        out: Dict[str, np.ndarray] = {}
        for k in keys:
            out[k] = b.cols[k][np.sort(first)]
        order_of_first = np.argsort(first) if keys else np.array([0])
        # map group code -> dense output row (groups ordered by first occurrence)
        remap = np.empty(ng, dtype=np.int64)
        remap[order_of_first] = np.arange(ng)
        codes2 = remap[codes] if b.num_rows else codes

        for spec in aggs:
            vals = eval_expr(spec.arg, b, self.ctx) if spec.arg is not None else None
            # engine != auto routes SUM/COUNT through the registered grouped-
            # aggregation kernel (cuda privatized scatter or torch ref) when the
            # float32 contract is value-preserving, mirroring the filter path
            routed = (self._kernel_agg(spec, vals, codes2, ng)
                      if self.ctx.engine != "auto" else None)
            out[spec.out_name] = (routed if routed is not None
                                  else _agg_column(spec, vals, codes2, ng))
        if not keys and b.num_rows == 0:
            # global aggregate over empty input yields a single row
            for spec in aggs:
                out[spec.out_name] = _agg_column(spec, np.empty(0), np.empty(0, np.int64), 1)
        return VectorBatch(out)

    def _kernel_agg(self, spec, vals: Optional[np.ndarray],
                    codes: np.ndarray, ng: int) -> Optional[np.ndarray]:
        """Grouped SUM/COUNT (``hash_group``) and MIN/MAX
        (``hash_group_minmax``) via the kernel registry; None when the
        aggregate is not kernel-shaped (then the numpy path runs)."""
        if spec.fn not in ("sum", "count", "min", "max") or spec.distinct \
                or vals is None:
            return None
        if ng <= 0 or vals.dtype.kind not in "iufb":
            return None
        if vals.size >= (1 << 24):
            # the kernel's float32 accumulators stop being exact integers at
            # 2^24, so COUNTs (and the row-bounded sums below) could silently
            # round; beyond that the numpy path runs
            return None
        f32 = vals.astype(np.float32)
        # the kernel accumulates in float32: only take this path when the
        # cast is value-preserving (also rejects NaN/NULL-carrying columns,
        # whose skip semantics the kernel does not implement)
        if not np.array_equal(f32.astype(vals.dtype), vals):
            return None
        if spec.fn in ("min", "max"):
            fn = self.ctx.kernel("hash_group_minmax")
            mins, maxs = fn(codes.astype(np.int32), f32, int(ng))
            out = np.asarray(mins if spec.fn == "min" else maxs,
                             dtype=np.float64)
            counts = np.bincount(codes, minlength=ng)
            out[counts == 0] = np.nan  # MIN/MAX over an empty group is NULL
            if vals.dtype.kind in "iu" and not np.isnan(out).any():
                return out.astype(np.int64)
            return out
        if spec.fn == "sum" and vals.dtype.kind in "iu" and vals.size:
            # integer sums must stay exact: every partial sum is an integer
            # bounded by sum(|v|), so < 2^24 keeps float32 accumulation exact
            if float(np.abs(vals.astype(np.int64)).sum()) >= float(1 << 24):
                return None
        fn = self.ctx.kernel("hash_group")
        sums, counts = fn(codes.astype(np.int32), f32, int(ng))
        if spec.fn == "count":
            return np.asarray(counts, dtype=np.int64)
        sums = np.asarray(sums, dtype=np.float64)
        counts = np.asarray(counts)
        sums[counts == 0] = np.nan  # SUM over an empty group is NULL
        if vals.dtype.kind in "iu" and not np.isnan(sums).any():
            return sums.astype(np.int64)
        return sums

    # ---- window functions --------------------------------------------------------
    def _stream_windowop(self, node: P.WindowOp):
        b = self._collect(node.input)  # window frames need the full input
        out = b
        for wf, name in node.funcs:
            out = out.with_column(name, _eval_window(wf, b, self.ctx))
        yield from self._emit(out)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _dedupe(batch: VectorBatch, cols: List[str]) -> VectorBatch:
    """Unique rows of ``batch`` over ``cols`` (first occurrence kept)."""
    if batch.num_rows == 0:
        return batch
    _, first = _group_codes(batch, cols)
    return batch.take(np.sort(first))


def _expand_matches(lo, counts, order):
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    li = np.repeat(np.arange(len(lo)), counts)
    offsets = np.cumsum(counts) - counts
    within = np.arange(total) - np.repeat(offsets, counts)
    ri = order[np.repeat(lo, counts) + within]
    return li, ri


def _null_extendable(b: VectorBatch) -> VectorBatch:
    """Cast an outer join's padded side to its NULL-capable dtypes:
    numeric/bool columns widen to float64 (NaN-null), strings unchanged."""
    return VectorBatch({
        k: v.astype(np.float64) if v.dtype.kind in ("i", "u", "b", "f")
        and v.dtype != np.float64 else v
        for k, v in b.cols.items()
    })


def _union_promotions(node: P.Union) -> Dict[str, np.dtype]:
    """Per-output-column promoted numpy dtype for a Union's branches, from
    the inferred schema when present (only widening casts; empty when the
    schema is unknown or branches already agree)."""
    schema = getattr(node, "schema", None)
    if schema is None:
        return {}
    out: Dict[str, np.dtype] = {}
    for name, ty in schema:
        if ty.token in ("int64", "float64", "float32", "bool"):
            out[name] = np.dtype(ty.token)
    return out


def _promoted(b: VectorBatch, promote: Dict[str, np.dtype]) -> VectorBatch:
    if not promote:
        return b
    cols = {}
    for k, v in b.cols.items():
        want = promote.get(k)
        if want is not None and v.dtype != want and v.dtype.kind in "iufb" \
                and np.promote_types(v.dtype, want) == want:
            v = v.astype(want)  # widening only; narrowing is real drift
        cols[k] = v
    return VectorBatch(cols)


def _concat_sides(lb: VectorBatch, rb: VectorBatch) -> VectorBatch:
    cols = dict(lb.cols)
    for k, v in rb.cols.items():
        if k in cols:
            k = k + "__r"
        cols[k] = v
    return VectorBatch(cols)


def _null_like(proto: np.ndarray, n: int) -> np.ndarray:
    if proto.dtype.kind in ("U", "S"):
        return np.full(n, _NULL_STR, dtype=proto.dtype if proto.dtype.itemsize else "U8")
    return np.full(n, np.nan, dtype=np.float64)


def _null_batch(proto: VectorBatch, n: int) -> VectorBatch:
    return VectorBatch({k: _null_like(v, n) for k, v in proto.cols.items()})


def _agg_column(spec, vals, codes, ng) -> np.ndarray:
    if spec.fn == "count":
        if vals is None:
            return np.bincount(codes, minlength=ng).astype(np.int64)
        valid = ~_is_null_mask(vals)
        if vals.dtype.kind == "f":
            valid &= ~np.isnan(vals)
        if spec.distinct:
            key = codes * (1 << 32)
            _, u_codes = np.unique(vals[valid], return_inverse=True)
            pairs = np.unique(codes[valid] * np.int64(1 << 32) + u_codes)
            grp = (pairs >> 32).astype(np.int64)
            return np.bincount(grp, minlength=ng).astype(np.int64)
        return np.bincount(codes[valid], minlength=ng).astype(np.int64)
    if vals is None:
        raise ExecError(f"{spec.fn} requires an argument")
    numeric = vals.dtype.kind in ("i", "u", "f", "b")
    if spec.fn == "sum":
        v = vals.astype(np.float64)
        nanmask = np.isnan(v)
        sums = np.bincount(codes[~nanmask], weights=v[~nanmask],
                           minlength=ng).astype(np.float64)
        counts = np.bincount(codes[~nanmask], minlength=ng)
        sums[counts == 0] = np.nan  # SUM over empty/NULL group is NULL
        if vals.dtype.kind in ("i", "u") and not np.isnan(sums).any():
            return sums.astype(np.int64)
        return sums
    if spec.fn in ("min", "max"):
        if numeric:
            init = np.full(ng, np.inf if spec.fn == "min" else -np.inf)
            v = vals.astype(np.float64)
            m = ~np.isnan(v)
            (np.minimum if spec.fn == "min" else np.maximum).at(init, codes[m], v[m])
            init[np.isinf(init)] = np.nan
            if vals.dtype.kind in ("i", "u") and not np.isnan(init).any():
                return init.astype(np.int64)
            if vals.dtype == np.float32:
                # MIN/MAX never create new values: a float32 input keeps its
                # dtype through partial/merge folds (the float64 round-trip
                # is value-exact, and NaN-null survives the cast)
                return init.astype(np.float32)
            return init
        out = np.full(ng, _NULL_STR, dtype=vals.dtype if vals.dtype.itemsize else "U32")
        for g in range(ng):
            sel = vals[codes == g]
            if len(sel):
                out[g] = sel.min() if spec.fn == "min" else sel.max()
        return out
    raise ExecError(f"unknown aggregate {spec.fn}")


def _eval_window(wf: A.WindowFunc, b: VectorBatch, ctx) -> np.ndarray:
    n = b.num_rows
    if n == 0:
        return np.empty(0, dtype=np.int64)
    pcols = [eval_expr(e, b, ctx) for e in wf.partition_by]
    if pcols:
        rec = np.rec.fromarrays(pcols)
        _, codes = np.unique(rec, return_inverse=True)
    else:
        codes = np.zeros(n, dtype=np.int64)
    okeys = [(eval_expr(e, b, ctx), d) for e, d in wf.order_by]

    # global order: partition first, then order keys
    sort_arrays = [codes]
    for v, d in okeys:
        if v.dtype.kind in ("U", "S"):
            _, vc = np.unique(v, return_inverse=True)
            v = vc
        sort_arrays.append(-v.astype(np.float64) if d else v.astype(np.float64))
    order = np.lexsort(tuple(reversed(sort_arrays)))
    inv = np.empty(n, dtype=np.int64)
    inv[order] = np.arange(n)
    sorted_codes = codes[order]
    starts = np.r_[0, np.flatnonzero(np.diff(sorted_codes)) + 1]
    part_start_for = np.repeat(starts, np.diff(np.r_[starts, n]))

    name = wf.func.name
    if name == "row_number":
        rn = np.arange(n) - part_start_for + 1
        return rn[inv]
    if name in ("rank", "dense_rank"):
        keyvals = np.stack([a[order].astype(np.float64) if a.dtype.kind != "U" else
                            np.unique(a, return_inverse=True)[1][order].astype(np.float64)
                            for a, _ in okeys]) if okeys else np.zeros((1, n))
        same_as_prev = np.r_[False, (np.diff(keyvals, axis=1) == 0).all(axis=0)] & \
            (np.r_[-1, sorted_codes[:-1]] == sorted_codes)
        if name == "rank":
            rn = np.arange(n) - part_start_for + 1
            out = rn.copy()
            for i in range(1, n):
                if same_as_prev[i]:
                    out[i] = out[i - 1]
            return out[inv]
        out = np.ones(n, dtype=np.int64)
        for i in range(1, n):
            if sorted_codes[i] != sorted_codes[i - 1]:
                out[i] = 1
            elif same_as_prev[i]:
                out[i] = out[i - 1]
            else:
                out[i] = out[i - 1] + 1
        return out[inv]
    if name in ("lag", "lead"):
        arg = eval_expr(wf.func.args[0], b, ctx)
        k = int(wf.func.args[1].value) if len(wf.func.args) > 1 else 1
        sa = arg[order]
        out = _null_like(arg, n)
        if name == "lag":
            out[k:] = sa[:-k]
            bad = np.arange(n) - part_start_for < k
        else:
            out[:-k] = sa[k:]
            nxt = np.r_[starts[1:], n]
            part_end_for = np.repeat(nxt, np.diff(np.r_[starts, n]))
            bad = np.arange(n) + k >= part_end_for
        out[bad] = np.nan if out.dtype.kind == "f" else out[bad]
        return out[inv]
    if name in ("sum", "count", "min", "max", "avg"):
        arg = eval_expr(wf.func.args[0], b, ctx) if wf.func.args and not isinstance(wf.func.args[0], A.Star) else None
        ng = int(codes.max()) + 1 if n else 0
        from ..optimizer.plan import AggSpec

        if name == "avg":
            s = _agg_column(AggSpec("sum", None, False, "s"), arg, codes, ng) if arg is None else _agg_column(AggSpec("sum", A.Col("x"), False, "s"), arg, codes, ng)
            c = _agg_column(AggSpec("count", A.Col("x") if arg is not None else None, False, "c"), arg, codes, ng)
            vals = s / c
        else:
            vals = _agg_column(AggSpec(name, A.Col("x") if arg is not None else None, False, "v"), arg, codes, ng)
        return vals[codes]
    raise ExecError(f"unsupported window function {name}")


_KERNEL_FILTER_OPS = {"<": 0, "<=": 1, ">": 2, ">=": 3, "=": 4, "!=": 5}


def _compile_kernel_filter(pred: A.Expr, b: VectorBatch):
    """Compile ``col <op> numeric-literal AND ...`` into the filter kernel's
    (columns, ops, lits) form; None when the predicate is not kernel-shaped."""
    from ..sql.binder import split_conjuncts

    cols, ops, lits = [], [], []
    for c in split_conjuncts(pred):
        if not (isinstance(c, A.BinOp) and c.op in _KERNEL_FILTER_OPS
                and isinstance(c.left, A.Col) and isinstance(c.right, A.Lit)):
            return None
        v = c.right.value
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            return None
        try:
            arr = _lookup(b, c.left)
        except ExecError:
            return None
        if arr.dtype.kind not in "iuf":
            return None
        # the kernel contract is float32: only take this path when the cast
        # is value-preserving, else comparisons beyond 2^24 go wrong
        f32 = arr.astype(np.float32)
        if not np.array_equal(f32.astype(arr.dtype), arr):
            return None
        if float(np.float32(v)) != float(v):
            return None
        cols.append(f32)
        ops.append(_KERNEL_FILTER_OPS[c.op])
        lits.append(float(v))
    if not cols:
        return None
    return tuple(cols), tuple(ops), tuple(lits)


def _extract_sargs(pred: A.Expr) -> List[SargPredicate]:
    out = []
    from ..sql.binder import split_conjuncts

    for c in split_conjuncts(pred):
        if isinstance(c, A.BinOp) and c.op in ("=", "<", "<=", ">", ">="):
            if isinstance(c.left, A.Col) and isinstance(c.right, A.Lit):
                out.append(SargPredicate(c.left.name, c.op, c.right.value))
            elif isinstance(c.right, A.Col) and isinstance(c.left, A.Lit):
                flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "="}
                out.append(SargPredicate(c.right.name, flip[c.op], c.left.value))
        elif isinstance(c, A.Between) and not c.negated and isinstance(c.expr, A.Col):
            if isinstance(c.low, A.Lit) and isinstance(c.high, A.Lit):
                out.append(SargPredicate(c.expr.name, ">=", c.low.value))
                out.append(SargPredicate(c.expr.name, "<=", c.high.value))
        elif isinstance(c, A.InList) and not c.negated and isinstance(c.expr, A.Col):
            vals = [v.value for v in c.values if isinstance(v, A.Lit)]
            if vals:
                out.append(SargPredicate(c.expr.name, "in", vals))
    return out


def _qualify(e: A.Expr, alias: str) -> A.Expr:
    """Qualify raw column refs in a pushed filter with the scan alias."""
    from ..sql.binder import _rebuild

    if isinstance(e, A.Col) and e.table is None:
        return A.Col(e.name, alias)
    if isinstance(e, A.Col):
        return e
    return _rebuild(e, [_qualify(c, alias) for c in e.children()])
