"""SQL abstract syntax tree (paper §3.1).

Expression nodes double as *bound* expression nodes in logical plans: after
binding, every ``Col`` carries a fully qualified name (``alias.column``) that
uniquely identifies a column in its input batch.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple, Union

# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------


class Expr:
    def children(self) -> Sequence["Expr"]:
        out = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, Expr):
                out.append(v)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    if isinstance(x, Expr):
                        out.append(x)
                    elif isinstance(x, tuple):  # Case.whens / WindowFunc.order_by
                        out.extend(y for y in x if isinstance(y, Expr))
        return out

    def key(self) -> str:
        """Canonical string form — used for cache keys, CSE, MV matching."""
        raise NotImplementedError


@dataclass(frozen=True)
class Col(Expr):
    name: str
    table: Optional[str] = None  # alias qualifier; filled by the binder

    @property
    def qualified(self) -> str:
        return f"{self.table}.{self.name}" if self.table else self.name

    def key(self) -> str:
        return self.qualified


@dataclass(frozen=True)
class Lit(Expr):
    value: object

    def key(self) -> str:
        return repr(self.value)


@dataclass(frozen=True)
class BinOp(Expr):
    op: str  # + - * / % = != < <= > >= AND OR LIKE
    left: Expr
    right: Expr

    def key(self) -> str:
        l, r = self.left.key(), self.right.key()
        if self.op in ("+", "*", "=", "!=", "AND", "OR") and r < l:
            l, r = r, l  # commutative normalization
        return f"({l} {self.op} {r})"


@dataclass(frozen=True)
class UnOp(Expr):
    op: str  # NOT, -
    operand: Expr

    def key(self) -> str:
        return f"({self.op} {self.operand.key()})"


@dataclass(frozen=True)
class Func(Expr):
    name: str  # scalar or aggregate function name, lowercase
    args: Tuple[Expr, ...] = ()
    distinct: bool = False

    def key(self) -> str:
        d = "DISTINCT " if self.distinct else ""
        return f"{self.name}({d}{', '.join(a.key() for a in self.args)})"


@dataclass(frozen=True)
class Case(Expr):
    whens: Tuple[Tuple[Expr, Expr], ...]
    otherwise: Optional[Expr] = None

    def key(self) -> str:
        ws = " ".join(f"WHEN {c.key()} THEN {v.key()}" for c, v in self.whens)
        e = f" ELSE {self.otherwise.key()}" if self.otherwise else ""
        return f"CASE {ws}{e} END"


@dataclass(frozen=True)
class InList(Expr):
    expr: Expr
    values: Tuple[Expr, ...]
    negated: bool = False

    def key(self) -> str:
        n = "NOT " if self.negated else ""
        return f"({self.expr.key()} {n}IN ({', '.join(v.key() for v in self.values)}))"


@dataclass(frozen=True)
class Between(Expr):
    expr: Expr
    low: Expr
    high: Expr
    negated: bool = False

    def key(self) -> str:
        n = "NOT " if self.negated else ""
        return f"({self.expr.key()} {n}BETWEEN {self.low.key()} AND {self.high.key()})"


@dataclass(frozen=True)
class IsNull(Expr):
    expr: Expr
    negated: bool = False

    def key(self) -> str:
        n = "NOT " if self.negated else ""
        return f"({self.expr.key()} IS {n}NULL)"


@dataclass(frozen=True)
class Cast(Expr):
    expr: Expr
    to_type: str

    def key(self) -> str:
        return f"CAST({self.expr.key()} AS {self.to_type})"


@dataclass(frozen=True)
class Param(Expr):
    """``?`` placeholder (DB-API qmark style), bound at execution time.

    ``key()`` is the ordinal, not the value, so a prepared statement's plan
    is parameter-independent and can be cached across executions.
    """

    index: int  # 0-based ordinal of the placeholder in the statement

    def key(self) -> str:
        return f"?{self.index}"


@dataclass(frozen=True)
class Star(Expr):
    table: Optional[str] = None

    def key(self) -> str:
        return f"{self.table or ''}.*"


@dataclass(frozen=True)
class SubqueryExpr(Expr):
    """IN / EXISTS / scalar subquery; decorrelated by the optimizer (§3.1)."""

    query: "Select"
    kind: str  # 'scalar' | 'in' | 'exists'
    expr: Optional[Expr] = None  # the LHS for IN
    negated: bool = False

    def key(self) -> str:
        return f"({self.kind} {id(self.query)})"


@dataclass(frozen=True)
class WindowFunc(Expr):
    """OLAP window function (paper §3.1 'advanced OLAP operations')."""

    func: Func
    partition_by: Tuple[Expr, ...] = ()
    order_by: Tuple[Tuple[Expr, bool], ...] = ()  # (expr, descending)

    def key(self) -> str:
        p = ", ".join(e.key() for e in self.partition_by)
        o = ", ".join(f"{e.key()} {'DESC' if d else 'ASC'}" for e, d in self.order_by)
        return f"{self.func.key()} OVER (PARTITION BY {p} ORDER BY {o})"


AGG_FUNCS = {"sum", "count", "min", "max", "avg"}
WINDOW_ONLY_FUNCS = {"row_number", "rank", "dense_rank", "lag", "lead"}
NON_DETERMINISTIC_FUNCS = {"rand", "random", "uuid"}
RUNTIME_CONSTANT_FUNCS = {"current_date", "current_timestamp", "now"}


def walk(expr: Expr):
    yield expr
    for c in expr.children():
        yield from walk(c)


def contains_aggregate(expr: Expr) -> bool:
    return any(
        isinstance(e, Func) and e.name in AGG_FUNCS and not isinstance(e, WindowFunc)
        for e in walk(expr)
    )


# ---------------------------------------------------------------------------
# Relations / statements
# ---------------------------------------------------------------------------


@dataclass
class TableRef:
    name: str
    alias: Optional[str] = None
    catalog: Optional[str] = None  # federated catalog qualifier (paper §6)
    schema: Optional[str] = None   # schema within the catalog


@dataclass
class SubqueryRef:
    query: "Select"
    alias: str


@dataclass
class JoinRef:
    left: object  # TableRef | SubqueryRef | JoinRef
    right: object
    kind: str  # inner | left | right | full | cross
    condition: Optional[Expr] = None


@dataclass
class Select:
    projections: List[Tuple[Expr, Optional[str]]]  # (expr, alias)
    from_: object = None  # TableRef | SubqueryRef | JoinRef | None
    where: Optional[Expr] = None
    group_by: List[Expr] = field(default_factory=list)
    grouping_sets: Optional[List[List[Expr]]] = None
    having: Optional[Expr] = None
    order_by: List[Tuple[Expr, bool]] = field(default_factory=list)
    limit: Optional[int] = None
    distinct: bool = False


@dataclass
class SetOp:
    kind: str  # union | intersect | except
    all: bool
    left: object  # Select | SetOp
    right: object
    order_by: List[Tuple[Expr, bool]] = field(default_factory=list)
    limit: Optional[int] = None


@dataclass
class Values:
    rows: List[List[Expr]]


@dataclass
class Insert:
    table: str
    columns: Optional[List[str]]
    source: object  # Select | Values
    # Hive multi-insert: several (table, columns) targets share one source.
    extra_targets: List[Tuple[str, Optional[List[str]]]] = field(default_factory=list)


@dataclass
class Update:
    table: str
    assignments: List[Tuple[str, Expr]]
    where: Optional[Expr] = None


@dataclass
class Delete:
    table: str
    where: Optional[Expr] = None


@dataclass
class MergeAction:
    kind: str  # update | delete | insert
    assignments: List[Tuple[str, Expr]] = field(default_factory=list)
    columns: Optional[List[str]] = None
    values: List[Expr] = field(default_factory=list)
    condition: Optional[Expr] = None


@dataclass
class Merge:
    target: TableRef
    source: object  # TableRef | SubqueryRef
    on: Expr
    matched: List[MergeAction] = field(default_factory=list)
    not_matched: List[MergeAction] = field(default_factory=list)


@dataclass
class ColumnDef:
    name: str
    type: str
    constraints: List[str] = field(default_factory=list)  # PRIMARY KEY / NOT NULL / UNIQUE


@dataclass
class CreateTable:
    name: str
    columns: List[ColumnDef]
    partition_by: List[ColumnDef] = field(default_factory=list)
    props: dict = field(default_factory=dict)
    stored_by: Optional[str] = None  # storage-handler class (§6.1)
    external: bool = False
    foreign_keys: List[Tuple[str, str, str]] = field(default_factory=list)


@dataclass
class CreateMaterializedView:
    name: str
    query: Select
    props: dict = field(default_factory=dict)
    stored_by: Optional[str] = None


@dataclass
class DropTable:
    name: str
    if_exists: bool = False


# federated catalogs (paper §6): mount a whole external system at once
@dataclass
class CreateCatalog:
    name: str
    connector: str  # registered connector name (jdbc | druid | memtable | ...)
    props: dict = field(default_factory=dict)


@dataclass
class DropCatalog:
    name: str
    if_exists: bool = False


@dataclass
class RebuildMaterializedView:
    name: str


@dataclass
class Explain:
    stmt: object
    analyze: bool = False


# workload management DDL (paper §5.2)
@dataclass
class CreateResourcePlan:
    name: str


@dataclass
class CreatePool:
    plan: str
    pool: str
    alloc_fraction: float
    query_parallelism: int


@dataclass
class CreateWMRule:
    plan: str
    rule: str
    metric: str
    threshold: float
    action: str  # MOVE <pool> | KILL
    target_pool: Optional[str] = None


@dataclass
class AddWMRuleToPool:
    plan: str
    rule: str
    pool: str


@dataclass
class CreateWMMapping:
    plan: str
    kind: str  # application | user | group
    entity: str
    pool: str


@dataclass
class AlterResourcePlan:
    plan: str
    default_pool: Optional[str] = None
    enable_activate: bool = False


Statement = Union[
    Select, SetOp, Insert, Update, Delete, Merge, CreateTable,
    CreateMaterializedView, DropTable, RebuildMaterializedView, Explain,
    CreateResourcePlan, CreatePool, CreateWMRule, AddWMRuleToPool,
    CreateWMMapping, AlterResourcePlan, CreateCatalog, DropCatalog,
]


# ---------------------------------------------------------------------------
# parameter binding helpers (DB-API qmark placeholders)
# ---------------------------------------------------------------------------
def _walk_any(obj):
    """Yield every Expr reachable from an AST node / statement dataclass."""
    if isinstance(obj, Expr):
        for e in walk(obj):
            yield e
            if isinstance(e, SubqueryExpr):
                yield from _walk_any(e.query)
        return
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _walk_any(getattr(obj, f.name))
        return
    if isinstance(obj, (list, tuple)):
        for x in obj:
            yield from _walk_any(x)


def count_params(stmt) -> int:
    """Number of distinct ``?`` placeholders in a statement."""
    return len({e.index for e in _walk_any(stmt) if isinstance(e, Param)})


def substitute_params(obj, params: Sequence[object]):
    """Return a copy of the statement with every ``Param`` replaced by a
    ``Lit`` of the corresponding value (used by the DML execution path)."""
    if isinstance(obj, Param):
        if obj.index >= len(params):
            raise ValueError(
                f"statement references parameter ?{obj.index} but only "
                f"{len(params)} parameter(s) were supplied"
            )
        return Lit(params[obj.index])
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return type(obj)(**{
            f.name: substitute_params(getattr(obj, f.name), params)
            for f in dataclasses.fields(obj)
        })
    if isinstance(obj, list):
        return [substitute_params(x, params) for x in obj]
    if isinstance(obj, tuple):
        return tuple(substitute_params(x, params) for x in obj)
    if isinstance(obj, dict):
        return {k: substitute_params(v, params) for k, v in obj.items()}
    return obj
