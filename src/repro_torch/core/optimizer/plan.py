"""Logical/physical plan algebra (paper §2 Fig. 2, §4).

One algebra serves both roles (Calcite-style): the optimizer rewrites these
nodes, then the task compiler (core/runtime/dag.py) breaks the tree into a
DAG of executable tasks at exchange boundaries.

Column naming convention: every node's ``output_names`` is a list of unique
strings; bound `Col` expressions reference them by qualified name
(``alias.column``) and projections introduce new names.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..metastore import TableDesc
from ..sql import ast as A


class PlanNode:
    inputs: List["PlanNode"] = []
    # inferred output schema (repro_torch.core.schema.Schema), attached by the
    # binder / pipeline via annotate_plan; None = not (re)inferred yet.
    # Deliberately NOT part of key()/digest(): schema is derived metadata.
    schema = None

    def output_names(self) -> List[str]:
        raise NotImplementedError

    def key(self) -> str:
        """Structural identity — drives shared-work merging and result cache."""
        raise NotImplementedError

    def digest(self) -> str:
        return hashlib.blake2b(self.key().encode(), digest_size=8).hexdigest()

    def pretty(self, indent: int = 0) -> str:
        head = " " * indent + self.describe()
        lines = [head]
        if self.schema is not None:
            lines.append(" " * indent + "  schema: " + self.schema.describe())
        return "\n".join(lines + [c.pretty(indent + 2) for c in self.inputs])

    def describe(self) -> str:
        return type(self).__name__


@dataclass
class RuntimeFilterSpec:
    """Dynamic semijoin reducer (paper §4.6) attached to a Scan.

    ``producer`` is a plan subtree emitting the filter column; at runtime the
    DAG executes it first and ships {bloom, min/max, value set} to the scan.
    """

    producer: PlanNode
    producer_column: str
    target_column: str  # raw column name in the scanned table
    kind: str  # 'partition' (dynamic partition pruning) or 'index' (bloom+minmax)

    def key(self) -> str:
        return f"rf({self.producer.key()},{self.producer_column},{self.target_column},{self.kind})"


class Scan(PlanNode):
    def __init__(
        self,
        table: TableDesc,
        alias: str,
        columns: Optional[List[str]] = None,  # raw column names to read
        pushed_filter: Optional[A.Expr] = None,  # over raw (unqualified) cols
        partition_filter: Optional[A.Expr] = None,
        runtime_filters: Optional[List[RuntimeFilterSpec]] = None,
        min_writeid: Optional[int] = None,  # incremental MV rebuild reads (§4.4)
    ):
        self.table = table
        self.alias = alias
        self.columns = columns or [c for c, _ in table.schema]
        self.pushed_filter = pushed_filter
        self.partition_filter = partition_filter
        self.runtime_filters = runtime_filters or []
        self.min_writeid = min_writeid
        self.inputs = []

    def output_names(self) -> List[str]:
        return [f"{self.alias}.{c}" for c in self.columns]

    def key(self) -> str:
        pf = self.pushed_filter.key() if self.pushed_filter else ""
        pp = self.partition_filter.key() if self.partition_filter else ""
        rf = ",".join(r.key() for r in self.runtime_filters)
        mw = f",minw={self.min_writeid}" if self.min_writeid else ""
        return f"scan({self.table.name} as {self.alias},[{','.join(self.columns)}],{pf},{pp},{rf}{mw})"

    def describe(self) -> str:
        extra = []
        if self.pushed_filter:
            extra.append(f"filter={self.pushed_filter.key()}")
        if self.partition_filter:
            extra.append(f"partitions={self.partition_filter.key()}")
        if self.runtime_filters:
            extra.append(f"runtime_filters={len(self.runtime_filters)}")
        return f"Scan[{self.table.name} as {self.alias}]" + (
            " (" + ", ".join(extra) + ")" if extra else ""
        )


class FederatedScan(PlanNode):
    """Scan against an external DataSource (paper §6.2, redesigned).

    ``spec`` is the capability-negotiated
    :class:`~repro_torch.core.federation.datasource.ScanSpec` — the filters /
    projection / (partial) aggregate / limit the connector agreed to absorb;
    whatever it declined stays above this node as ordinary plan operators,
    so ``EXPLAIN`` shows pushed-vs-residual directly.  ``split`` (set by
    compile-time split expansion) pins the node to one of the connector's
    parallel work units."""

    def __init__(self, table: TableDesc, alias: str, columns: List[str],
                 spec=None, output_cols: Optional[List[str]] = None,
                 split=None, total_splits: Optional[int] = None):
        self.table = table
        self.alias = alias
        self.columns = columns
        self.spec = spec
        self._output_cols = output_cols
        self.split = split
        self.total_splits = total_splits
        self.inputs = []

    def output_names(self) -> List[str]:
        if self._output_cols is not None:
            return list(self._output_cols)
        return [f"{self.alias}.{c}" for c in self.columns]

    @property
    def pushed_filter(self) -> Optional[A.Expr]:
        """Conjunction of pushed raw-column filters (cost estimation)."""
        if self.spec is None or not self.spec.filters:
            return None
        out = self.spec.filters[0]
        for c in self.spec.filters[1:]:
            out = A.BinOp("AND", out, c)
        return out

    def key(self) -> str:
        sp = self.spec.key() if self.spec is not None else ""
        split = f",split={self.split!r}" if self.split is not None else ""
        return f"fedscan({self.table.name} as {self.alias},{sp}{split})"

    def describe(self) -> str:
        extra = []
        if self.spec is not None:
            pushed = self.spec.summary()
            if pushed:
                extra.append("pushed=" + ",".join(
                    f"{k}:{v}" for k, v in pushed.items()))
        if self.split is not None and self.total_splits:
            extra.append(f"split={self.split!r}/{self.total_splits}")
        return f"FederatedScan[{self.table.name} via {self.table.handler}]" + (
            " (" + " ".join(extra) + ")" if extra else ""
        )


class Filter(PlanNode):
    def __init__(self, input: PlanNode, predicate: A.Expr):
        self.inputs = [input]
        self.predicate = predicate

    @property
    def input(self):
        return self.inputs[0]

    def output_names(self):
        return self.input.output_names()

    def key(self):
        return f"filter({self.predicate.key()},{self.input.key()})"

    def describe(self):
        return f"Filter[{self.predicate.key()}]"


class Project(PlanNode):
    def __init__(self, input: PlanNode, exprs: List[Tuple[A.Expr, str]]):
        self.inputs = [input]
        self.exprs = exprs  # (expr, output_name)

    @property
    def input(self):
        return self.inputs[0]

    def output_names(self):
        return [n for _, n in self.exprs]

    def key(self):
        es = ",".join(f"{e.key()} as {n}" for e, n in self.exprs)
        return f"project([{es}],{self.input.key()})"

    def describe(self):
        return f"Project[{', '.join(n for _, n in self.exprs)}]"


class Join(PlanNode):
    def __init__(
        self,
        left: PlanNode,
        right: PlanNode,
        kind: str,  # inner | left | semi | anti | cross
        left_keys: List[str],
        right_keys: List[str],
        residual: Optional[A.Expr] = None,
        strategy: Optional[str] = None,  # 'shuffle' | 'broadcast' (set by CBO)
    ):
        self.inputs = [left, right]
        self.kind = kind
        self.left_keys = left_keys
        self.right_keys = right_keys
        self.residual = residual
        self.strategy = strategy

    @property
    def left(self):
        return self.inputs[0]

    @property
    def right(self):
        return self.inputs[1]

    def output_names(self):
        if self.kind in ("semi", "anti"):
            return self.left.output_names()
        return self.left.output_names() + self.right.output_names()

    def key(self):
        r = self.residual.key() if self.residual else ""
        return (
            f"join({self.kind},{self.left_keys},{self.right_keys},{r},"
            f"{self.left.key()},{self.right.key()})"
        )

    def describe(self):
        strat = f" [{self.strategy}]" if self.strategy else ""
        return f"Join[{self.kind}{strat} {self.left_keys}={self.right_keys}" + (
            f" residual={self.residual.key()}" if self.residual else ""
        ) + "]"


@dataclass
class AggSpec:
    fn: str  # sum | count | min | max | avg
    arg: Optional[A.Expr]  # None for count(*)
    distinct: bool
    out_name: str

    def key(self) -> str:
        a = self.arg.key() if self.arg else "*"
        return f"{self.fn}({'D' if self.distinct else ''}{a})->{self.out_name}"


class Aggregate(PlanNode):
    def __init__(
        self,
        input: PlanNode,
        group_keys: List[str],  # input column names
        aggs: List[AggSpec],
        grouping_sets: Optional[List[List[str]]] = None,
    ):
        self.inputs = [input]
        self.group_keys = group_keys
        self.aggs = aggs
        self.grouping_sets = grouping_sets

    @property
    def input(self):
        return self.inputs[0]

    def output_names(self):
        return list(self.group_keys) + [a.out_name for a in self.aggs]

    def key(self):
        gs = f",{self.grouping_sets}" if self.grouping_sets else ""
        return (
            f"agg([{','.join(self.group_keys)}],"
            f"[{','.join(a.key() for a in self.aggs)}]{gs},{self.input.key()})"
        )

    def describe(self):
        return f"Aggregate[keys={self.group_keys} aggs={[a.key() for a in self.aggs]}]"


class WindowOp(PlanNode):
    def __init__(self, input: PlanNode, funcs: List[Tuple[A.WindowFunc, str]]):
        self.inputs = [input]
        self.funcs = funcs

    @property
    def input(self):
        return self.inputs[0]

    def output_names(self):
        return self.input.output_names() + [n for _, n in self.funcs]

    def key(self):
        fs = ",".join(f"{w.key()} as {n}" for w, n in self.funcs)
        return f"window([{fs}],{self.input.key()})"

    def describe(self):
        return f"Window[{', '.join(n for _, n in self.funcs)}]"


class Sort(PlanNode):
    def __init__(self, input: PlanNode, keys: List[Tuple[str, bool]]):
        self.inputs = [input]
        self.keys = keys  # (column name, descending)

    @property
    def input(self):
        return self.inputs[0]

    def output_names(self):
        return self.input.output_names()

    def key(self):
        return f"sort({self.keys},{self.input.key()})"

    def describe(self):
        return f"Sort[{self.keys}]"


class Limit(PlanNode):
    def __init__(self, input: PlanNode, n: int):
        self.inputs = [input]
        self.n = n

    @property
    def input(self):
        return self.inputs[0]

    def output_names(self):
        return self.input.output_names()

    def key(self):
        return f"limit({self.n},{self.input.key()})"

    def describe(self):
        return f"Limit[{self.n}]"


class Union(PlanNode):
    def __init__(self, inputs: List[PlanNode], all: bool = True):
        self.inputs = list(inputs)
        self.all = all

    def output_names(self):
        return self.inputs[0].output_names()

    def key(self):
        return f"union({self.all},[{','.join(i.key() for i in self.inputs)}])"

    def describe(self):
        return f"Union[{'ALL' if self.all else 'DISTINCT'}]"


class ShuffleRead(PlanNode):
    """One partition lane of a hash-partitioned SHUFFLE edge.

    Inserted at compile time by the shuffle service
    (:func:`repro_torch.core.runtime.shuffle.expand_shuffle_partitions`): the
    per-partition clones of a pipeline-breaker consumer each read one lane
    of the shared producer subtree, which executes exactly once and
    hash-partitions its output stream on ``keys``.  The task compiler lowers
    this node into a lane-aware edge placeholder — it never reaches the
    executor."""

    def __init__(self, source: PlanNode, keys: List[str], partition: int,
                 num_partitions: int, est_rows: Optional[float] = None):
        self.inputs = [source]
        self.keys = list(keys)
        self.partition = partition
        self.num_partitions = num_partitions
        # the CBO row estimate the lane count was derived from — the
        # adaptive runtime compares live producer rows against it to
        # decide whether the fan-out actually pays (payoff gate)
        self.est_rows = est_rows

    @property
    def source(self) -> PlanNode:
        return self.inputs[0]

    def output_names(self):
        return self.source.output_names()

    def key(self):
        return (f"shuffleread(p{self.partition}/{self.num_partitions},"
                f"[{','.join(self.keys)}],{self.source.key()})")

    def describe(self):
        return (f"ShuffleRead[p{self.partition}/{self.num_partitions} "
                f"keys={self.keys}]")


class ValuesNode(PlanNode):
    def __init__(self, names: List[str], rows: List[list]):
        self.names = names
        self.rows = rows
        self.inputs = []

    def output_names(self):
        return list(self.names)

    def key(self):
        return f"values({self.names},{self.rows})"

    def describe(self):
        return f"Values[{len(self.rows)} rows]"


# ---------------------------------------------------------------------------
# tree utilities
# ---------------------------------------------------------------------------

def walk_plan(node: PlanNode):
    yield node
    for i in node.inputs:
        yield from walk_plan(i)
    if isinstance(node, Scan):
        for rf in node.runtime_filters:
            yield from walk_plan(rf.producer)


def find_scans(node: PlanNode) -> List[Scan]:
    return [n for n in walk_plan(node) if isinstance(n, Scan)]


def replace_child(parent: PlanNode, old: PlanNode, new: PlanNode) -> None:
    parent.inputs = [new if c is old else c for c in parent.inputs]
