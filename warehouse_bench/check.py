"""The comparison that decides ``correct``: every query the window completed
against the plain reference (``reference/star.py``) over the same columns.

Three numbers, each with its limit in the configuration's ``limits``:

- ``max_rel_gap``: the widest gap of a non-integer aggregate, |program -
  reference| / max(|reference|, 1), over every such value of every query;
- ``wrong_answers``: queries whose answer is wrong beyond rounding: another
  set of groups, an integer aggregate (COUNT, MIN, MAX, a SUM of integers)
  that differs, a NULL against a value, or rows out of the ORDER BY's
  order;
- ``unanswered``: queries that failed or never returned.

A result-cache hit is judged like any other answer.  The reference runs
once per distinct statement.
"""
from __future__ import annotations

import math

import numpy as np

from .reference import star


def _null(v):
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return None
    return v.item() if hasattr(v, "item") else v


def in_order(rows: list, order: list, select: list) -> bool:
    """True when ``rows`` follow ``order`` ([column name or select index,
    "asc" | "desc"], ...); ties and NULLs pass."""
    keys = [(select.index(c) if isinstance(c, str) else c, d == "desc")
            for c, d in order]
    for a, b in zip(rows, rows[1:]):
        for i, desc in keys:
            x, y = _null(a[i]), _null(b[i])
            if x is None or y is None:
                break
            if x != y:
                if (x > y) != desc:
                    return False
                break
    return True


def compare(got: list, ref: list, spec: dict) -> tuple:
    """(right beyond rounding, widest relative gap) of one answer."""
    select = spec["select"]
    keys = [i for i, s in enumerate(select) if isinstance(s, str)]
    aggs = [i for i, s in enumerate(select) if not isinstance(s, str)]
    if len(got) != len(ref) or any(len(r) != len(select) for r in got) \
            or not in_order(got, spec["order"], select):
        return False, 0.0
    expect = {tuple(_null(r[i]) for i in keys): r for r in ref}
    gap, matched = 0.0, set()
    for row in got:
        key = tuple(_null(row[i]) for i in keys)
        r = expect.get(key)
        if r is None or key in matched:
            return False, gap
        matched.add(key)
        for i in aggs:
            g, e = _null(row[i]), _null(r[i])
            if g is None or e is None:
                if g is not e:
                    return False, gap
            elif isinstance(e, int):
                if g != e:
                    return False, gap
            else:
                gap = max(gap, abs(g - e) / max(abs(e), 1.0))
    return True, gap


def judge(data: dict, templates: dict, records: list,
          dtype=np.float64) -> dict:
    """The three numbers over ``records`` (generator.Record); the reference
    computes in ``dtype``."""
    refs, joins = {}, {}
    out = {"max_rel_gap": 0.0, "wrong_answers": 0, "unanswered": 0}
    for rec in records:
        if rec.error is not None or rec.rows is None:
            out["unanswered"] += 1
            continue
        st = rec.statement
        spec = templates[st.template]["spec"]
        if st.sql not in refs:
            refs[st.sql] = star.evaluate(data, spec, st.params, dtype,
                                         joins)
        right, gap = compare(rec.rows, refs[st.sql], spec)
        out["wrong_answers"] += not right
        out["max_rel_gap"] = max(out["max_rel_gap"], gap)
    return out


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number within its
    limit."""
    shown = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return all(v["value"] <= v["limit"] for v in shown.values()), shown
