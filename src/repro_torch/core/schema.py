"""Typed schema contract for the vectorized runtime (paper §5).

``VectorBatch`` is an untyped dict of numpy arrays; this module is the
contract that says what those dicts *must* look like at every plan edge:

  * :class:`ColumnType` — a numpy dtype family plus nullability.  Types are
    compared by canonical token (``int64``/``float64``/``float32``/``bool``/
    ``str``/``any``); string columns compare by kind so ``U8`` vs ``U64``
    itemsize differences never count as drift.
  * :class:`Schema` — an ordered ``name -> ColumnType`` map with the
    relational-algebra operations the planner needs (project, concat with
    join-collision renaming, positional rename, union promotion).
  * :func:`infer_expr` — mirrors ``runtime/exec.py``'s ``eval_expr`` dtype
    semantics (``/`` is always float64, comparisons are bool, ``||`` is
    string concat, CAST FLOAT is float32, ...).
  * :func:`infer_node` / :func:`annotate_plan` — per-node inference rules
    (Scan/FederatedScan from catalog metadata, then Project/Filter/Join/
    Aggregate/WindowOp/Sort/Limit/Union/ShuffleRead/Values) that the binder
    and pipeline attach to every ``PlanNode`` as ``node.schema``; compile
    propagates them onto DAG vertices and exchange edge declarations.

The static flow checker (``repro_torch.analysis.schema_check``) and the runtime
batch sanitizer (``Exchange.put`` under ``REPRO_CHECK_BATCHES=1``) both
consume these types; inference failures here raise
:class:`SchemaInferenceError` subclasses that the checker maps to SCHnnn
rule codes.

Unknowns degrade to the ``any`` type, which conforms to everything — the
checker only flags *definite* contradictions (an unresolvable column, a
string key hashed against a numeric one), never incomplete knowledge.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .sql import ast as A


class SchemaMismatchError(Exception):
    """Two schemas that must agree don't.  ``context`` names the plan edge
    or exchange tag where the disagreement was observed."""

    def __init__(self, message: str, context: Optional[str] = None):
        self.context = context
        super().__init__(f"{message}" + (f" [at {context}]" if context else ""))


class SchemaInferenceError(SchemaMismatchError):
    """Static inference hit a contradiction (not merely an unknown)."""


class UnresolvedColumnError(SchemaInferenceError):
    """A column reference does not resolve against its input schema."""

    def __init__(self, name: str, available: Sequence[str],
                 context: Optional[str] = None):
        self.name = name
        self.available = list(available)
        super().__init__(
            f"column {name!r} does not resolve against {self.available[:12]}",
            context)


# ---------------------------------------------------------------------------
# ColumnType
# ---------------------------------------------------------------------------
_STR_KINDS = ("U", "S")


def _token_of_dtype(dt: np.dtype) -> str:
    dt = np.dtype(dt)
    if dt.kind in _STR_KINDS:
        return "str"
    if dt.kind == "b":
        return "bool"
    return dt.name  # int64, float64, float32, ...


class ColumnType:
    """A column's dtype family + nullability.

    ``token`` is a canonical name: a numpy numeric dtype name, ``bool``,
    ``str`` (any unicode/bytes itemsize), or ``any`` (statically unknown —
    conforms to everything).  ``nullable`` is informational: NULLs travel as
    NaN in float columns and as the empty string in string columns, so an
    int64 column that *may* hold NULL is physically float64 at runtime;
    :meth:`accepts` knows that representation.
    """

    __slots__ = ("token", "nullable")

    def __init__(self, token, nullable: bool = False):
        if not isinstance(token, str):
            token = _token_of_dtype(token)
        self.token = token
        self.nullable = bool(nullable)

    # -- constructors -------------------------------------------------------
    @classmethod
    def of_array(cls, arr: np.ndarray, nullable: bool = False) -> "ColumnType":
        return cls(_token_of_dtype(arr.dtype), nullable)

    @classmethod
    def of_sql(cls, sql_type: str, nullable: bool = False) -> "ColumnType":
        from .acid import _np_dtype

        try:
            return cls(_token_of_dtype(_np_dtype(sql_type)), nullable)
        except ValueError:
            return ANY

    # -- predicates ---------------------------------------------------------
    @property
    def family(self) -> str:
        if self.token == "any":
            return "any"
        if self.token == "str":
            return "str"
        if self.token == "bool":
            return "bool"
        return "numeric"

    def np_dtype(self) -> np.dtype:
        if self.token == "str":
            return np.dtype("U64")
        if self.token == "any":
            return np.dtype(np.float64)
        return np.dtype(self.token)

    def promote(self, other: "ColumnType",
                context: Optional[str] = None) -> "ColumnType":
        """UNION-branch promotion; raises when no common type exists."""
        nullable = self.nullable or other.nullable
        if self.token == "any" or other.token == "any":
            t = other.token if self.token == "any" else self.token
            return ColumnType(t, nullable)
        if self.token == other.token:
            return ColumnType(self.token, nullable)
        fams = {self.family, other.family}
        if fams <= {"numeric", "bool"}:
            promoted = np.promote_types(
                np.dtype(self.token) if self.token != "bool" else np.bool_,
                np.dtype(other.token) if other.token != "bool" else np.bool_)
            return ColumnType(_token_of_dtype(promoted), nullable)
        raise SchemaInferenceError(
            f"no common type for {self.render()} and {other.render()}",
            context)

    def accepts(self, actual: np.dtype) -> bool:
        """Runtime conformance: may an array of ``actual`` dtype flow through
        an edge declared with this type?"""
        actual = np.dtype(actual)
        if self.token == "any":
            return True
        if self.token == "str":
            return actual.kind in _STR_KINDS
        if actual.name == self.token:
            return True
        # NULLs have no integer/bool representation: a nullable int64/bool
        # column is physically float64 (NaN-null) the moment a NULL appears
        # (outer-join padding, empty-group aggregates), and COALESCE-style
        # merges may round-trip through float64 either way.
        if self.token in ("int64", "bool") and actual.name == "float64":
            return True
        return False

    def render(self) -> str:
        return self.token + ("?" if self.nullable else "")

    def __eq__(self, other):
        return (isinstance(other, ColumnType) and self.token == other.token
                and self.nullable == other.nullable)

    def __hash__(self):
        return hash((self.token, self.nullable))

    def __repr__(self):
        return f"ColumnType({self.render()})"


ANY = ColumnType("any")
BOOL = ColumnType("bool")
INT64 = ColumnType("int64")
FLOAT64 = ColumnType("float64")
STR = ColumnType("str")


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------
class Schema:
    """Ordered ``column name -> ColumnType`` map for one plan edge."""

    __slots__ = ("cols",)

    def __init__(self, cols: Iterable[Tuple[str, ColumnType]]):
        self.cols: Dict[str, ColumnType] = dict(cols)

    # -- constructors -------------------------------------------------------
    @classmethod
    def of_batch(cls, batch) -> "Schema":
        return cls((name, ColumnType.of_array(arr))
                   for name, arr in batch.cols.items())

    @classmethod
    def of_table(cls, table, alias: Optional[str] = None,
                 columns: Optional[Sequence[str]] = None) -> "Schema":
        """From catalog metadata (a ``TableDesc``)."""
        want = list(columns) if columns is not None \
            else [c for c, _ in table.schema]
        prefix = f"{alias}." if alias else ""
        return cls((prefix + c, ColumnType.of_sql(table.dtype_of(c)))
                   for c in want)

    @classmethod
    def any_of(cls, names: Sequence[str]) -> "Schema":
        return cls((n, ANY) for n in names)

    # -- basic access -------------------------------------------------------
    def names(self) -> List[str]:
        return list(self.cols)

    def get(self, name: str) -> Optional[ColumnType]:
        return self.cols.get(name)

    def __len__(self):
        return len(self.cols)

    def __contains__(self, name):
        return name in self.cols

    def __iter__(self):
        return iter(self.cols.items())

    def __eq__(self, other):
        return isinstance(other, Schema) and self.cols == other.cols

    def resolve(self, name: str, table: Optional[str] = None) -> ColumnType:
        """Resolve a (possibly qualified) column reference the way
        ``exec._lookup`` does: exact key first, then unique suffix for
        unqualified names.  Raises :class:`UnresolvedColumnError`."""
        key = f"{table}.{name}" if table else name
        if key in self.cols:
            return self.cols[key]
        if table is None:
            hits = [k for k in self.cols
                    if k == name or k.endswith("." + name)]
            if hits:
                # ambiguity is an execution-time concern; statically, agree
                # when every candidate agrees and degrade to ANY otherwise
                tys = {self.cols[h].token for h in hits}
                return self.cols[hits[0]] if len(tys) == 1 else ANY
        raise UnresolvedColumnError(key, self.names())

    # -- relational operations ---------------------------------------------
    def project(self, names: Sequence[str]) -> "Schema":
        out = []
        for n in names:
            ty = self.cols.get(n)
            if ty is None:
                raise UnresolvedColumnError(n, self.names())
            out.append((n, ty))
        return Schema(out)

    def rename_to(self, names: Sequence[str],
                  context: Optional[str] = None) -> "Schema":
        """Positional rename (UNION branches, federated output naming)."""
        if len(names) != len(self.cols):
            raise SchemaMismatchError(
                f"arity mismatch: {len(names)} names for "
                f"{len(self.cols)} columns", context)
        return Schema(zip(names, self.cols.values()))

    def concat(self, other: "Schema") -> "Schema":
        """Join-output concatenation; collisions on the right side get the
        ``__r`` suffix exactly like ``exec._concat_sides``."""
        cols = dict(self.cols)
        for k, v in other.cols.items():
            if k in cols:
                k = k + "__r"
            cols[k] = v
        return Schema(cols.items())

    def promote(self, other: "Schema",
                context: Optional[str] = None) -> "Schema":
        """Positional UNION promotion: same arity, pairwise common types,
        left side's names win."""
        if len(self.cols) != len(other.cols):
            raise SchemaMismatchError(
                f"union branch arity mismatch: {self.names()} vs "
                f"{other.names()}", context)
        out = []
        for (ln, lt), (_, rt) in zip(self.cols.items(), other.cols.items()):
            out.append((ln, lt.promote(rt, context)))
        return Schema(out)

    def nullable(self) -> "Schema":
        """All columns marked nullable (outer-join padding side)."""
        return Schema((n, ColumnType(t.token, True)) for n, t in self)

    def to_pairs(self) -> List[Tuple[str, np.dtype]]:
        """(name, numpy dtype) pairs — feeds ``VectorBatch.empty``."""
        return [(n, t.np_dtype()) for n, t in self]

    def describe(self) -> str:
        return ", ".join(f"{n}:{t.render()}" for n, t in self)

    def __repr__(self):
        return f"Schema({self.describe()})"

    # -- runtime conformance ------------------------------------------------
    def check_batch(self, batch, context: Optional[str] = None) -> None:
        """Assert a morsel conforms: declared names all present with
        conforming dtypes, no undeclared columns (hidden ``__``-prefixed
        bookkeeping columns like ACID's rowid travel freely)."""
        for name, ty in self.cols.items():
            arr = batch.cols.get(name)
            if arr is None:
                raise SchemaMismatchError(
                    f"declared column {name!r} missing from batch "
                    f"{list(batch.cols)[:12]}", context)
            if not ty.accepts(arr.dtype):
                raise SchemaMismatchError(
                    f"column {name!r} declared {ty.render()} but batch "
                    f"carries {arr.dtype.name}", context)
        for name in batch.cols:
            if name not in self.cols and not name.startswith("__"):
                raise SchemaMismatchError(
                    f"undeclared column {name!r} in batch (declared: "
                    f"{self.names()[:12]})", context)


# ---------------------------------------------------------------------------
# expression type inference — mirrors exec.eval_expr dtype semantics
# ---------------------------------------------------------------------------
_BOOL_OPS = {"AND", "OR", "=", "!=", "<", "<=", ">", ">=", "LIKE"}
_STR_FUNCS = {"lower", "upper", "substr"}
_INT_FUNCS = {"length", "extract", "year"}


def _lit_type(value) -> ColumnType:
    # mirrors exec._broadcast
    if value is None:
        return ColumnType("float64", True)
    if isinstance(value, bool):
        return BOOL
    if isinstance(value, int):
        return INT64
    if isinstance(value, float):
        return FLOAT64
    return STR


def infer_expr(e: A.Expr, schema: Schema) -> ColumnType:
    """Static dtype of ``eval_expr(e, batch)`` for a batch of ``schema``."""
    if isinstance(e, A.Col):
        return schema.resolve(e.name, e.table)
    if isinstance(e, A.Lit):
        return _lit_type(e.value)
    if isinstance(e, A.Param):
        return ANY  # bound at execute(); value type unknown statically
    if isinstance(e, A.BinOp):
        lt = infer_expr(e.left, schema)
        rt = infer_expr(e.right, schema)
        if e.op in _BOOL_OPS:
            return BOOL
        if e.op == "||":
            return STR
        if e.op == "/":
            return FLOAT64  # eval_expr divides in float64 unconditionally
        if lt.family == "str" or rt.family == "str":
            return STR  # arithmetic coerces to str when either side is
        return lt.promote(rt)
    if isinstance(e, A.UnOp):
        if e.op.upper() == "NOT":
            return BOOL
        return infer_expr(e.operand, schema)  # unary minus keeps dtype
    if isinstance(e, (A.InList, A.Between, A.IsNull)):
        return BOOL
    if isinstance(e, A.Cast):
        infer_expr(e.expr, schema)  # still verify the operand resolves
        t = e.to_type.upper()
        if t.startswith(("INT", "BIGINT")):
            return INT64
        if t.startswith("FLOAT"):
            return ColumnType("float32")
        if t.startswith(("DOUBLE", "DECIMAL", "REAL")):
            return FLOAT64
        return STR
    if isinstance(e, A.Case):
        out: Optional[ColumnType] = None
        for when, then in e.whens:
            infer_expr(when, schema)
            ty = infer_expr(then, schema)
            out = ty if out is None else out.promote(ty)
        if e.otherwise is not None:
            ty = infer_expr(e.otherwise, schema)
            out = ty if out is None else out.promote(ty)
        else:
            out = ColumnType(out.token, True) if out is not None else ANY
        return out or ANY
    if isinstance(e, A.Func):
        for a in e.args:
            infer_expr(a, schema)
        name = e.name.lower()
        if name in _STR_FUNCS:
            return STR
        if name in _INT_FUNCS:
            return INT64
        if name == "abs":
            return infer_expr(e.args[0], schema)
        if name in ("floor", "ceil"):
            # np.floor/ceil promote ints to float64, keep float32
            ty = infer_expr(e.args[0], schema)
            return ty if ty.token in ("float32", "float64") else FLOAT64
        if name == "round":
            ty = infer_expr(e.args[0], schema)
            return ty if ty.family == "numeric" else ty
        if name == "coalesce":
            out = infer_expr(e.args[0], schema)
            for a in e.args[1:]:
                out = out.promote(infer_expr(a, schema))
            return out
        return ANY  # unknown scalar — let execution decide
    if isinstance(e, A.SubqueryExpr):
        return BOOL if e.kind in ("in", "exists") else ANY
    return ANY  # Star / WindowFunc / anything new


def agg_result_type(fn: str, arg_type: ColumnType) -> ColumnType:
    """Output type of one aggregate spec — mirrors ``exec._agg_column``:
    COUNT is int64; SUM/MIN/MAX of int stay int64 (physically float64-NaN
    when a group comes up empty, which ``accepts`` allows); float32 MIN/MAX
    preserve float32; SUM widens float32 to float64 accumulation."""
    fn = fn.lower()
    if fn == "count":
        return INT64
    if fn == "avg":
        return ColumnType("float64", True)
    if arg_type.token == "any":
        return ANY
    if fn == "sum":
        if arg_type.family == "str":
            raise SchemaInferenceError(f"sum() over string column")
        if arg_type.token in ("int64", "bool"):
            return ColumnType("int64", True)
        return ColumnType("float64", True)
    if fn in ("min", "max"):
        if arg_type.family == "str":
            return ColumnType("str", True)
        if arg_type.token == "float32":
            return ColumnType("float32", True)
        if arg_type.token in ("int64", "bool"):
            return ColumnType("int64", True)
        return ColumnType("float64", True)
    return ANY


def _window_type(wf: A.WindowFunc, schema: Schema) -> ColumnType:
    fn = wf.func.name.lower()
    if fn in ("row_number", "rank", "dense_rank", "count"):
        return INT64
    if fn in ("lag", "lead"):
        # exec seeds lag/lead output from _null_like(arg): numeric -> float64
        ty = infer_expr(wf.func.args[0], schema) if wf.func.args else ANY
        if ty.family == "str":
            return ColumnType("str", True)
        if ty.token == "any":
            return ANY
        return ColumnType("float64", True)
    if fn in ("sum", "min", "max", "avg"):
        arg = infer_expr(wf.func.args[0], schema) if wf.func.args else ANY
        return agg_result_type(fn, arg)
    return ANY


# ---------------------------------------------------------------------------
# plan-node schema inference
# ---------------------------------------------------------------------------
def infer_node(node, input_schemas: List[Schema]) -> Schema:
    """Output schema of one plan node given its inputs' schemas.

    Raises :class:`SchemaInferenceError` (or subclasses) on definite
    contradictions; unknowable types come back as ``any``.
    """
    from .optimizer import plan as P
    from .runtime.dag import MaterializedNode

    if isinstance(node, P.Scan):
        return Schema.of_table(node.table, node.alias, node.columns)
    if isinstance(node, P.FederatedScan):
        return _federated_schema(node)
    if isinstance(node, MaterializedNode):
        if getattr(node, "schema", None) is not None:
            return node.schema
        return Schema.any_of(node.names)
    if isinstance(node, (P.Filter, P.Sort, P.Limit)):
        src = input_schemas[0]
        if isinstance(node, P.Filter):
            infer_expr(node.predicate, src)
        if isinstance(node, P.Sort):
            for k, _ in node.keys:
                src.resolve(k)
        return src
    if isinstance(node, P.Project):
        src = input_schemas[0]
        return Schema((name, infer_expr(expr, src))
                      for expr, name in node.exprs)
    if isinstance(node, P.Join):
        left, right = input_schemas
        for lk, rk in zip(node.left_keys, node.right_keys):
            lt, rt = left.resolve(lk), right.resolve(rk)
            if "any" not in (lt.family, rt.family) and lt.family != rt.family:
                raise SchemaInferenceError(
                    f"join key dtype family mismatch: {lk}:{lt.render()} vs "
                    f"{rk}:{rt.render()} (bitcast hash partitions them "
                    f"differently)")
        if node.kind in ("semi", "anti"):
            return left
        if node.kind == "left":
            right = _null_extended(right)
        elif node.kind == "full":
            left, right = _null_extended(left), _null_extended(right)
        out = left.concat(right)
        if node.residual is not None:
            infer_expr(node.residual, out)
        return out
    if isinstance(node, P.Aggregate):
        src = input_schemas[0]
        out: List[Tuple[str, ColumnType]] = []
        for k in node.group_keys:
            out.append((k, src.resolve(k)))
        for spec in node.aggs:
            arg = infer_expr(spec.arg, src) if spec.arg is not None else ANY
            out.append((spec.out_name, agg_result_type(spec.fn, arg)))
        if node.grouping_sets is not None:
            # keys absent from a grouping set are NULL-padded in its rows
            out = [(n, ColumnType(t.token, True) if n in node.group_keys
                    else t) for n, t in out]
        return Schema(out)
    if isinstance(node, P.WindowOp):
        src = input_schemas[0]
        cols = list(src)
        for wf, name in node.funcs:
            cols.append((name, _window_type(wf, src)))
        return Schema(cols)
    if isinstance(node, P.Union):
        out = input_schemas[0]
        names = out.names()
        for i, branch in enumerate(input_schemas[1:], start=1):
            out = out.promote(branch.rename_to(names, f"union branch {i}"),
                              f"union branch {i}")
        return out
    if isinstance(node, P.ShuffleRead):
        src = input_schemas[0]
        for k in node.keys:
            src.resolve(k)
        return src
    if isinstance(node, P.ValuesNode):
        # cells are expressions evaluated against a dummy one-row batch
        empty = Schema(())
        cols: List[Tuple[str, ColumnType]] = []
        for i, name in enumerate(node.names):
            ty: Optional[ColumnType] = None
            for row in node.rows:
                try:
                    vt = infer_expr(row[i], empty) if i < len(row) else ANY
                except SchemaMismatchError:
                    vt = ANY
                ty = vt if ty is None else ty.promote(vt)
            cols.append((name, ty or ANY))
        return Schema(cols)
    # unknown node kind — stay permissive
    return Schema.any_of(node.output_names())


def _null_extended(schema: Schema) -> Schema:
    """The padded side of an outer join: every column becomes nullable, and
    numeric columns widen to float64 (``_null_like`` pads with NaN)."""
    out = []
    for n, t in schema:
        if t.family == "numeric":
            out.append((n, ColumnType("float64", True)))
        elif t.family == "bool":
            out.append((n, ColumnType("float64", True)))
        else:
            out.append((n, ColumnType(t.token, True)))
    return Schema(out)


def _federated_schema(node) -> Schema:
    """FederatedScan output: ``output_names()`` order, typed from catalog
    metadata through the negotiated spec (projection narrows, pushed
    aggregates type as group keys + agg results)."""
    table = node.table
    spec = node.spec

    def raw_type(col: Optional[str]) -> ColumnType:
        if col is None:
            return ANY
        try:
            return ColumnType.of_sql(table.dtype_of(col))
        except (KeyError, ValueError):
            return ANY

    if spec is not None and spec.agg is not None:
        raw = [(k, raw_type(k)) for k in spec.agg.group_keys]
        raw += [(out, agg_result_type(fn, raw_type(arg)))
                for fn, arg, out in spec.agg.aggs]
    elif spec is not None and spec.projection is not None:
        raw = [(c, raw_type(c)) for c in spec.projection]
    else:
        raw = [(c, raw_type(c)) for c, _ in table.schema]
    names = node.output_names()
    if len(names) != len(raw):
        # connector/plan disagreement is SCH005 territory; stay permissive
        # here and let the checker compare against output_columns()
        return Schema.any_of(names)
    return Schema((n, t) for n, (_, t) in zip(names, raw))


def infer_plan(node, memo: Optional[Dict[int, Schema]] = None) -> Schema:
    """Recursive inference over a plan tree (raises on contradiction)."""
    if memo is None:
        memo = {}
    got = memo.get(id(node))
    if got is not None:
        return got
    ins = [infer_plan(i, memo) for i in node.inputs]
    out = infer_node(node, ins)
    memo[id(node)] = out
    return out


def annotate_plan(node, memo: Optional[Dict[int, Optional[Schema]]] = None):
    """Attach ``node.schema`` bottom-up, tolerantly: a subtree whose schema
    cannot be inferred gets ``schema = None`` (EXPLAIN omits the line, the
    runtime sanitizer skips the edge) instead of failing the query — the
    strict path is the checker, not annotation."""
    if memo is None:
        memo = {}
    if id(node) in memo:
        return memo[id(node)]
    ins = [annotate_plan(i, memo) for i in node.inputs]
    try:
        if any(s is None for s in ins):
            out: Optional[Schema] = None
        else:
            out = infer_node(node, ins)
    except SchemaMismatchError:
        out = None
    node.schema = out
    memo[id(node)] = out
    return out
