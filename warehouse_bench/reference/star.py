"""A plain NumPy evaluator of star queries over the generated columns.

It reads a query template's structured spec (``queries/<name>.json``:
``dims``, ``where``, ``group``, ``select``), not its SQL, and knows nothing
of the program: every fact row whose foreign keys find their dimension rows
and pass every predicate is grouped by the group columns, and each
aggregate is taken over its group.  Sums are NumPy's pairwise sums in
``dtype`` (float64 for the DOUBLE columns the configuration states; the
control passes float32), integer expressions stay int64 and exact.  An
aggregate over no rows follows SQL: no groups when grouped, else one row
with COUNT 0 and NULL (None) for the rest.
"""
from __future__ import annotations

import numpy as np

from .ssbgen import FOREIGN_KEYS

FACT = "lineorder"
BINARY = {"*": np.multiply, "-": np.subtract, "+": np.add}


def _owner(data: dict, column: str) -> str:
    for table, cols in data.items():
        if column in cols:
            return table
    raise KeyError(f"no table has a column {column!r}")


def _typed(values: np.ndarray, text: str):
    """A formatted literal as the column's type."""
    if values.dtype.kind in "iu":
        return int(text)
    if values.dtype.kind == "f":
        return float(text)
    return str(text)


def _predicate(values: np.ndarray, op: str, args: list) -> np.ndarray:
    args = [_typed(values, a) for a in args]
    if op == "=":
        return values == args[0]
    if op == "<":
        return values < args[0]
    if op == "<=":
        return values <= args[0]
    if op == ">":
        return values > args[0]
    if op == ">=":
        return values >= args[0]
    if op == "between":
        return (values >= args[0]) & (values <= args[1])
    if op == "in":
        return np.isin(values, np.array(args, dtype=values.dtype))
    raise ValueError(f"unknown predicate {op!r}")


def _measure(expr, column, dtype) -> np.ndarray:
    """An aggregate's argument over the selected rows; DOUBLE columns in
    ``dtype``, integers as int64."""
    if isinstance(expr, str):
        v = column(expr)
        return v.astype(dtype) if v.dtype.kind == "f" else v.astype(np.int64)
    op, left, right = expr
    return BINARY[op](_measure(left, column, dtype),
                      _measure(right, column, dtype))


def _fold(fn: str, values: np.ndarray, starts: np.ndarray,
          ends: np.ndarray) -> list:
    if fn == "count":
        return [int(e - s) for s, e in zip(starts, ends)]
    out = []
    for s, e in zip(starts, ends):
        if s == e:
            out.append(None)
            continue
        part = values[s:e]
        v = {"sum": np.sum, "min": np.min, "max": np.max}[fn](part)
        out.append(int(v) if part.dtype.kind in "iu" else float(v))
    return out


def join(data: dict, dim: str) -> tuple:
    """(fact rows that find their ``dim`` row, the ``dim`` row of each)."""
    fact = data[FACT]
    fk = next(k for k, (t, _) in FOREIGN_KEYS.items() if t == dim)
    pk = data[dim][FOREIGN_KEYS[fk][1]]
    order = np.argsort(pk, kind="stable")
    pos = np.minimum(np.searchsorted(pk[order], fact[fk]), pk.size - 1)
    return pk[order][pos] == fact[fk], order[pos]


def evaluate(data: dict, spec: dict, params: dict,
             dtype=np.float64, joins: dict | None = None) -> list:
    """The rows of one query: ``spec`` is a template's spec, ``params`` its
    substitution parameters (the ``where`` values are format strings over
    them).  Rows are tuples in the ``select`` order, in no set order.
    ``joins``, where given, keeps each dimension's ``join`` for later
    queries over the same ``data``."""
    fact = data[FACT]
    n = len(next(iter(fact.values())))
    keep = np.ones(n, dtype=bool)
    joins = {} if joins is None else joins
    at = {}
    for dim in spec["dims"]:
        if dim not in joins:
            joins[dim] = join(data, dim)
        found, at[dim] = joins[dim]
        keep &= found
    for column, op, *args in spec["where"]:
        table = _owner(data, column)
        hit = _predicate(data[table][column], op,
                         [a.format(**params) for a in args])
        keep &= hit if table == FACT else hit[at[table]]
    rows = np.flatnonzero(keep)

    def column(name: str) -> np.ndarray:
        table = _owner(data, name)
        values = data[table][name]
        return values[rows] if table == FACT else values[at[table][rows]]

    group = spec["group"]
    if group and not rows.size:
        return []
    if group:
        codes = np.stack([np.unique(column(g), return_inverse=True)[1]
                          for g in group])
        _, inverse = np.unique(codes, axis=1, return_inverse=True)
        order = np.argsort(inverse.ravel(), kind="stable")
        bounds = np.flatnonzero(np.diff(inverse.ravel()[order])) + 1
        starts = np.concatenate([[0], bounds])
        ends = np.concatenate([bounds, [rows.size]])
        keys = {g: column(g)[order][starts] for g in group}
    else:
        order = np.arange(rows.size)
        starts, ends, keys = np.array([0]), np.array([rows.size]), {}
    cols = []
    for item in spec["select"]:
        if isinstance(item, str):
            cols.append([v.item() if hasattr(v, "item") else v
                         for v in keys[item]])
        else:
            values = _measure(item["expr"], column, dtype)[order]
            cols.append(_fold(item["agg"], values, starts, ends))
    return list(zip(*cols))


def ordered(rows: list, spec: dict) -> list:
    """``rows`` in the spec's ORDER BY order ([column name or select index,
    "asc" | "desc"], ...), NULLs first."""
    select = spec["select"]
    out = list(rows)
    for column, direction in reversed(spec["order"]):
        i = select.index(column) if isinstance(column, str) else column
        out.sort(key=lambda r: (r[i] is not None, r[i] if r[i] is not None
                                else 0), reverse=direction == "desc")
    return out
