"""SQL lexer + recursive-descent parser (paper §3.1 SQL surface).

Covers the warehouse subset exercised in the paper: SELECT with joins,
correlated/uncorrelated subqueries (IN / EXISTS / scalar), window functions,
grouping sets, set operations, DML (INSERT/UPDATE/DELETE/MERGE), DDL with
``PARTITIONED BY`` and ``STORED BY`` (storage handlers), materialized views,
and the workload-management DDL of §5.2.
"""
from __future__ import annotations

import re
from typing import List, Optional, Tuple

from . import ast as A

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|--[^\n]*)
  | (?P<num>\d+\.\d+|\d+|\.\d+)
  | (?P<str>'(?:[^']|'')*')
  | (?P<ident>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<op><>|!=|>=|<=|=|<|>|\|\||[+\-*/%(),.;?])
    """,
    re.VERBOSE,
)

KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "as", "and", "or", "not", "in", "exists", "between", "like", "is",
    "null", "case", "when", "then", "else", "end", "cast", "distinct",
    "join", "inner", "left", "right", "full", "outer", "cross", "on",
    "union", "intersect", "except", "all", "asc", "desc", "insert", "into",
    "values", "update", "set", "delete", "merge", "using", "matched",
    "create", "table", "external", "partitioned", "stored", "tblproperties",
    "materialized", "view", "drop", "if", "rebuild", "alter", "explain",
    "analyze", "primary", "key", "unique", "foreign", "references", "over",
    "partition", "rows", "grouping", "sets", "resource", "plan", "pool",
    "with", "rule", "move", "kill", "add", "to", "mapping", "application",
    "user", "default", "enable", "activate", "true", "false", "by",
    "catalog",
}


class Token:
    __slots__ = ("kind", "value", "pos")

    def __init__(self, kind: str, value: str, pos: int):
        self.kind = kind  # num | str | ident | kw | op | eof
        self.value = value
        self.pos = pos

    def __repr__(self):
        return f"Token({self.kind},{self.value!r})"


def tokenize(sql: str) -> List[Token]:
    out, pos = [], 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise SyntaxError(f"cannot tokenize at {sql[pos:pos+20]!r}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        text = m.group()
        if m.lastgroup == "ident":
            low = text.lower()
            out.append(Token("kw" if low in KEYWORDS else "ident", low if low in KEYWORDS else text, m.start()))
        elif m.lastgroup == "str":
            out.append(Token("str", text[1:-1].replace("''", "'"), m.start()))
        else:
            out.append(Token(m.lastgroup, text, m.start()))
    out.append(Token("eof", "", len(sql)))
    return out


class Parser:
    def __init__(self, sql: str):
        self.toks = tokenize(sql)
        self.i = 0
        self._next_param = 0  # ordinal for '?' placeholders (qmark style)

    # -- token helpers --------------------------------------------------------
    def peek(self, offset: int = 0) -> Token:
        return self.toks[min(self.i + offset, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "kw" and t.value in kws

    def accept_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        if not self.accept_kw(kw):
            raise SyntaxError(f"expected {kw.upper()} at {self.peek()!r}")

    def accept_op(self, op: str) -> bool:
        t = self.peek()
        if t.kind == "op" and t.value == op:
            self.next()
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            raise SyntaxError(f"expected {op!r} at {self.peek()!r}")

    def ident(self) -> str:
        t = self.next()
        if t.kind not in ("ident", "kw"):
            raise SyntaxError(f"expected identifier at {t!r}")
        return t.value

    # ==========================================================================
    # statements
    # ==========================================================================
    def parse(self) -> A.Statement:
        stmt = self._statement()
        self.accept_op(";")
        if self.peek().kind != "eof":
            raise SyntaxError(f"trailing tokens at {self.peek()!r}")
        return stmt

    def _statement(self) -> A.Statement:
        if self.at_kw("explain"):
            self.next()
            analyze = self.accept_kw("analyze")
            return A.Explain(self._statement(), analyze)
        if self.at_kw("select") or (self.peek().kind == "op" and self.peek().value == "("):
            return self._select_with_setops()
        if self.at_kw("insert"):
            return self._insert()
        if self.at_kw("update"):
            return self._update()
        if self.at_kw("delete"):
            return self._delete()
        if self.at_kw("merge"):
            return self._merge()
        if self.at_kw("create"):
            return self._create()
        if self.at_kw("drop"):
            self.next()
            if self.accept_kw("catalog"):
                if_exists = False
                if self.accept_kw("if"):
                    self.expect_kw("exists")
                    if_exists = True
                return A.DropCatalog(self.ident(), if_exists)
            self.expect_kw("table")
            if_exists = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            return A.DropTable(self.ident(), if_exists)
        if self.at_kw("alter"):
            return self._alter()
        if self.at_kw("add"):
            self.next()
            self.expect_kw("rule")
            rule = self.ident()
            self.expect_kw("to")
            pool = self.ident()
            return A.AddWMRuleToPool(plan=None, rule=rule, pool=pool)
        raise SyntaxError(f"unsupported statement start {self.peek()!r}")

    # -- SELECT / set ops -----------------------------------------------------
    def _select_with_setops(self):
        left = self._select_core()
        while self.at_kw("union", "intersect", "except"):
            kind = self.next().value
            all_ = self.accept_kw("all")
            right = self._select_core()
            left = A.SetOp(kind, all_, left, right)
        # trailing ORDER BY / LIMIT bind to the set-op result
        if isinstance(left, A.SetOp):
            if self.accept_kw("order"):
                self.expect_kw("by")
                left.order_by = self._order_list()
            if self.accept_kw("limit"):
                left.limit = int(self.next().value)
        return left

    def _select_core(self) -> A.Select:
        if self.accept_op("("):
            s = self._select_with_setops()
            self.expect_op(")")
            return s
        self.expect_kw("select")
        distinct = self.accept_kw("distinct")
        projections = []
        while True:
            e = self._expr()
            alias = None
            if self.accept_kw("as"):
                alias = self.ident()
            elif self.peek().kind == "ident":
                alias = self.ident()
            projections.append((e, alias))
            if not self.accept_op(","):
                break
        sel = A.Select(projections=projections, distinct=distinct)
        if self.accept_kw("from"):
            sel.from_ = self._from_clause()
        if self.accept_kw("where"):
            sel.where = self._expr()
        if self.accept_kw("group"):
            self.expect_kw("by")
            if self.accept_kw("grouping"):
                self.expect_kw("sets")
                self.expect_op("(")
                sets = []
                while True:
                    self.expect_op("(")
                    exprs = []
                    if not self.accept_op(")"):
                        while True:
                            exprs.append(self._expr())
                            if not self.accept_op(","):
                                break
                        self.expect_op(")")
                    sets.append(exprs)
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
                sel.grouping_sets = sets
                keys, seen = [], set()
                for s in sets:
                    for e in s:
                        if e.key() not in seen:
                            seen.add(e.key())
                            keys.append(e)
                sel.group_by = keys
            else:
                while True:
                    sel.group_by.append(self._expr())
                    if not self.accept_op(","):
                        break
        if self.accept_kw("having"):
            sel.having = self._expr()
        if self.accept_kw("order"):
            self.expect_kw("by")
            sel.order_by = self._order_list()
        if self.accept_kw("limit"):
            sel.limit = int(self.next().value)
        return sel

    def _order_list(self) -> List[Tuple[A.Expr, bool]]:
        out = []
        while True:
            e = self._expr()
            desc = False
            if self.accept_kw("desc"):
                desc = True
            else:
                self.accept_kw("asc")
            out.append((e, desc))
            if not self.accept_op(","):
                break
        return out

    def _from_clause(self):
        left = self._table_factor()
        while True:
            if self.accept_op(","):
                right = self._table_factor()
                left = A.JoinRef(left, right, "cross", None)
            elif self.at_kw("join", "inner", "left", "right", "full", "cross"):
                kind = "inner"
                if self.accept_kw("inner"):
                    pass
                elif self.accept_kw("left"):
                    kind = "left"
                    self.accept_kw("outer")
                elif self.accept_kw("right"):
                    kind = "right"
                    self.accept_kw("outer")
                elif self.accept_kw("full"):
                    kind = "full"
                    self.accept_kw("outer")
                elif self.accept_kw("cross"):
                    kind = "cross"
                self.expect_kw("join")
                right = self._table_factor()
                cond = None
                if kind != "cross":
                    self.expect_kw("on")
                    cond = self._expr()
                left = A.JoinRef(left, right, kind, cond)
            else:
                return left

    def _table_factor(self):
        if self.accept_op("("):
            q = self._select_with_setops()
            self.expect_op(")")
            self.accept_kw("as")
            alias = self.ident()
            return A.SubqueryRef(q, alias)
        # one-, two-, or three-part names: table | catalog.table |
        # catalog.schema.table (federated catalogs, paper §6)
        parts = [self.ident()]
        while len(parts) < 3 and self.peek().kind == "op" \
                and self.peek().value == ".":
            self.next()
            parts.append(self.ident())
        alias = None
        if self.accept_kw("as"):
            alias = self.ident()
        elif self.peek().kind == "ident":
            alias = self.ident()
        if len(parts) == 1:
            return A.TableRef(parts[0], alias)
        if len(parts) == 2:
            return A.TableRef(parts[1], alias, catalog=parts[0])
        return A.TableRef(parts[2], alias, catalog=parts[0], schema=parts[1])

    # -- DML --------------------------------------------------------------
    def _insert(self) -> A.Insert:
        self.expect_kw("insert")
        self.expect_kw("into")
        table = self.ident()
        columns = None
        if self.peek().kind == "op" and self.peek().value == "(" and (
            self.peek(1).kind in ("ident",) or
            (self.peek(1).kind == "kw" and self.peek(2).kind == "op")
        ):
            self.expect_op("(")
            columns = []
            while True:
                columns.append(self.ident())
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        if self.accept_kw("values"):
            rows = []
            while True:
                self.expect_op("(")
                row = []
                while True:
                    row.append(self._expr())
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
                rows.append(row)
                if not self.accept_op(","):
                    break
            return A.Insert(table, columns, A.Values(rows))
        return A.Insert(table, columns, self._select_with_setops())

    def _update(self) -> A.Update:
        self.expect_kw("update")
        table = self.ident()
        self.expect_kw("set")
        assigns = []
        while True:
            col = self.ident()
            self.expect_op("=")
            assigns.append((col, self._expr()))
            if not self.accept_op(","):
                break
        where = self._expr() if self.accept_kw("where") else None
        return A.Update(table, assigns, where)

    def _delete(self) -> A.Delete:
        self.expect_kw("delete")
        self.expect_kw("from")
        table = self.ident()
        where = self._expr() if self.accept_kw("where") else None
        return A.Delete(table, where)

    def _merge(self) -> A.Merge:
        self.expect_kw("merge")
        self.expect_kw("into")
        target = self._table_factor()
        self.expect_kw("using")
        source = self._table_factor()
        self.expect_kw("on")
        on = self._expr()
        matched, not_matched = [], []
        while self.at_kw("when"):
            self.next()
            negated = self.accept_kw("not")
            self.expect_kw("matched")
            cond = self._expr() if self.accept_kw("and") else None
            self.expect_kw("then")
            if self.accept_kw("update"):
                self.expect_kw("set")
                assigns = []
                while True:
                    col = self.ident()
                    self.expect_op("=")
                    assigns.append((col, self._expr()))
                    if not self.accept_op(","):
                        break
                matched.append(A.MergeAction("update", assignments=assigns, condition=cond))
            elif self.accept_kw("delete"):
                matched.append(A.MergeAction("delete", condition=cond))
            elif self.accept_kw("insert"):
                cols = None
                if self.accept_op("("):
                    cols = []
                    while True:
                        cols.append(self.ident())
                        if not self.accept_op(","):
                            break
                    self.expect_op(")")
                self.expect_kw("values")
                self.expect_op("(")
                vals = []
                while True:
                    vals.append(self._expr())
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
                (not_matched if negated else matched).append(
                    A.MergeAction("insert", columns=cols, values=vals, condition=cond)
                )
        assert isinstance(target, A.TableRef)
        return A.Merge(target, source, on, matched, not_matched)

    # -- DDL ---------------------------------------------------------------
    def _create(self):
        self.expect_kw("create")
        if self.accept_kw("catalog"):
            # CREATE CATALOG name USING connector [WITH (k = v, ...)]
            name = self.ident()
            self.expect_kw("using")
            connector = self.next().value  # ident or quoted string
            props = {}
            if self.accept_kw("with"):
                props = self._props()
            return A.CreateCatalog(name, connector, props)
        if self.accept_kw("materialized"):
            self.expect_kw("view")
            name = self.ident()
            props, stored_by = {}, None
            while True:
                if self.accept_kw("stored"):
                    self.expect_kw("by")
                    stored_by = self.next().value
                elif self.accept_kw("tblproperties"):
                    props.update(self._props())
                else:
                    break
            self.expect_kw("as")
            q = self._select_with_setops()
            return A.CreateMaterializedView(name, q, props, stored_by)
        if self.accept_kw("resource"):
            self.expect_kw("plan")
            return A.CreateResourcePlan(self.ident())
        if self.accept_kw("pool"):
            plan = self.ident()
            self.expect_op(".")
            pool = self.ident()
            self.expect_kw("with")
            kv = {}
            while True:
                k = self.ident()
                self.expect_op("=")
                kv[k] = float(self.next().value)
                if not self.accept_op(","):
                    break
            return A.CreatePool(plan, pool, kv.get("alloc_fraction", 1.0),
                                int(kv.get("query_parallelism", 1)))
        if self.accept_kw("rule"):
            rule = self.ident()
            self.expect_kw("in")
            plan = self.ident()
            self.expect_kw("when")
            metric = self.ident()
            op = self.next().value  # > / >= etc
            threshold = float(self.next().value)
            self.expect_kw("then")
            if self.accept_kw("move"):
                return A.CreateWMRule(plan, rule, metric, threshold, "move", self.ident())
            self.expect_kw("kill")
            return A.CreateWMRule(plan, rule, metric, threshold, "kill")
        if self.accept_kw("application") or self.accept_kw("user"):
            kind = self.toks[self.i - 1].value
            self.expect_kw("mapping")
            entity = self.next().value  # ident or string
            self.expect_kw("in")
            plan = self.ident()
            self.expect_kw("to")
            return A.CreateWMMapping(plan, kind, entity, self.ident())
        external = self.accept_kw("external")
        self.expect_kw("table")
        name = self.ident()
        columns, fks = [], []
        if self.accept_op("("):
            while True:
                col = self.ident()
                ctype = self._type_name()
                cons = []
                while True:
                    if self.accept_kw("primary"):
                        self.expect_kw("key")
                        cons.append("primary key")
                    elif self.accept_kw("not"):
                        self.expect_kw("null")
                        cons.append("not null")
                    elif self.accept_kw("unique"):
                        cons.append("unique")
                    elif self.accept_kw("references"):
                        ref_t = self.ident()
                        self.expect_op("(")
                        ref_c = self.ident()
                        self.expect_op(")")
                        fks.append((col, ref_t, ref_c))
                    else:
                        break
                columns.append(A.ColumnDef(col, ctype, cons))
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        part, props, stored_by = [], {}, None
        while True:
            if self.accept_kw("partitioned"):
                self.expect_kw("by")
                self.expect_op("(")
                while True:
                    pc = self.ident()
                    pt = self._type_name()
                    part.append(A.ColumnDef(pc, pt))
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
            elif self.accept_kw("stored"):
                self.expect_kw("by")
                stored_by = self.next().value
            elif self.accept_kw("tblproperties"):
                props.update(self._props())
            else:
                break
        return A.CreateTable(name, columns, part, props, stored_by, external, fks)

    def _alter(self):
        self.expect_kw("alter")
        if self.accept_kw("materialized"):
            self.expect_kw("view")
            name = self.ident()
            self.expect_kw("rebuild")
            return A.RebuildMaterializedView(name)
        if self.accept_kw("resource"):
            self.expect_kw("plan")
            plan = self.ident()
            self.expect_kw("enable")
            self.expect_kw("activate")
            return A.AlterResourcePlan(plan, enable_activate=True)
        self.expect_kw("plan")
        plan = self.ident()
        self.expect_kw("set")
        self.expect_kw("default")
        self.expect_kw("pool")
        self.expect_op("=")
        return A.AlterResourcePlan(plan, default_pool=self.ident())

    def _props(self) -> dict:
        self.expect_op("(")
        out = {}
        while True:
            k = self.next().value
            self.expect_op("=")
            out[k] = self.next().value
            if not self.accept_op(","):
                break
        self.expect_op(")")
        return out

    def _type_name(self) -> str:
        base = self.ident().upper()
        if self.accept_op("("):
            args = [self.next().value]
            while self.accept_op(","):
                args.append(self.next().value)
            self.expect_op(")")
            base += f"({','.join(args)})"
        return base

    # ==========================================================================
    # expressions (precedence climbing)
    # ==========================================================================
    def _expr(self) -> A.Expr:
        return self._or_expr()

    def _or_expr(self) -> A.Expr:
        left = self._and_expr()
        while self.accept_kw("or"):
            left = A.BinOp("OR", left, self._and_expr())
        return left

    def _and_expr(self) -> A.Expr:
        left = self._not_expr()
        while self.accept_kw("and"):
            left = A.BinOp("AND", left, self._not_expr())
        return left

    def _not_expr(self) -> A.Expr:
        if self.accept_kw("not"):
            return A.UnOp("NOT", self._not_expr())
        return self._comparison()

    def _comparison(self) -> A.Expr:
        if self.at_kw("exists"):
            self.next()
            self.expect_op("(")
            q = self._select_with_setops()
            self.expect_op(")")
            return A.SubqueryExpr(q, "exists")
        left = self._additive()
        while True:
            negated = False
            save = self.i
            if self.accept_kw("not"):
                negated = True
            if self.accept_kw("in"):
                self.expect_op("(")
                if self.at_kw("select"):
                    q = self._select_with_setops()
                    self.expect_op(")")
                    left = A.SubqueryExpr(q, "in", expr=left, negated=negated)
                else:
                    vals = []
                    while True:
                        vals.append(self._expr())
                        if not self.accept_op(","):
                            break
                    self.expect_op(")")
                    left = A.InList(left, tuple(vals), negated)
                continue
            if self.accept_kw("between"):
                low = self._additive()
                self.expect_kw("and")
                high = self._additive()
                left = A.Between(left, low, high, negated)
                continue
            if self.accept_kw("like"):
                left = A.BinOp("LIKE", left, self._additive())
                if negated:
                    left = A.UnOp("NOT", left)
                continue
            if negated:
                self.i = save  # NOT belongs to a boolean factor, rewind
                break
            if self.accept_kw("is"):
                neg = self.accept_kw("not")
                self.expect_kw("null")
                left = A.IsNull(left, neg)
                continue
            t = self.peek()
            if t.kind == "op" and t.value in ("=", "!=", "<>", "<", "<=", ">", ">="):
                self.next()
                op = "!=" if t.value == "<>" else t.value
                right = self._additive()
                left = A.BinOp(op, left, right)
                continue
            break
        return left

    def _additive(self) -> A.Expr:
        left = self._multiplicative()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("+", "-", "||"):
                self.next()
                left = A.BinOp(t.value, left, self._multiplicative())
            else:
                return left

    def _multiplicative(self) -> A.Expr:
        left = self._unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/", "%"):
                self.next()
                left = A.BinOp(t.value, left, self._unary())
            else:
                return left

    def _unary(self) -> A.Expr:
        if self.accept_op("-"):
            return A.UnOp("-", self._unary())
        self.accept_op("+")
        return self._primary()

    def _primary(self) -> A.Expr:
        t = self.peek()
        if t.kind == "num":
            self.next()
            return A.Lit(float(t.value) if "." in t.value else int(t.value))
        if t.kind == "str":
            self.next()
            return A.Lit(t.value)
        if self.at_kw("true"):
            self.next()
            return A.Lit(True)
        if self.at_kw("false"):
            self.next()
            return A.Lit(False)
        if self.at_kw("null"):
            self.next()
            return A.Lit(None)
        if self.at_kw("case"):
            return self._case()
        if self.at_kw("cast"):
            self.next()
            self.expect_op("(")
            e = self._expr()
            self.expect_kw("as")
            ty = self._type_name()
            self.expect_op(")")
            return A.Cast(e, ty)
        if t.kind == "op" and t.value == "(":
            self.next()
            if self.at_kw("select"):
                q = self._select_with_setops()
                self.expect_op(")")
                return A.SubqueryExpr(q, "scalar")
            e = self._expr()
            self.expect_op(")")
            return e
        if t.kind == "op" and t.value == "*":
            self.next()
            return A.Star()
        if t.kind == "op" and t.value == "?":
            self.next()
            p = A.Param(self._next_param)
            self._next_param += 1
            return p
        # identifier: column, qualified column, star, or function call
        name = self.ident()
        if self.accept_op("("):
            distinct = self.accept_kw("distinct")
            args: List[A.Expr] = []
            if not self.accept_op(")"):
                if self.accept_op("*"):
                    args = [A.Star()]
                else:
                    while True:
                        args.append(self._expr())
                        if not self.accept_op(","):
                            break
                self.expect_op(")")
            func = A.Func(name.lower(), tuple(args), distinct)
            if self.accept_kw("over"):
                self.expect_op("(")
                pby: List[A.Expr] = []
                oby: List[Tuple[A.Expr, bool]] = []
                if self.accept_kw("partition"):
                    self.expect_kw("by")
                    while True:
                        pby.append(self._expr())
                        if not self.accept_op(","):
                            break
                if self.accept_kw("order"):
                    self.expect_kw("by")
                    oby = self._order_list()
                self.expect_op(")")
                return A.WindowFunc(func, tuple(pby), tuple(oby))
            return func
        if self.accept_op("."):
            if self.accept_op("*"):
                return A.Star(table=name)
            return A.Col(self.ident(), table=name)
        return A.Col(name)

    def _case(self) -> A.Expr:
        self.expect_kw("case")
        whens = []
        operand = None
        if not self.at_kw("when"):
            operand = self._expr()
        while self.accept_kw("when"):
            cond = self._expr()
            if operand is not None:
                cond = A.BinOp("=", operand, cond)
            self.expect_kw("then")
            whens.append((cond, self._expr()))
        otherwise = self._expr() if self.accept_kw("else") else None
        self.expect_kw("end")
        return A.Case(tuple(whens), otherwise)


def parse(sql: str) -> A.Statement:
    return Parser(sql).parse()


def parse_many(sql: str) -> List[A.Statement]:
    """Split on top-level semicolons and parse each statement."""
    stmts, depth, start, in_str = [], 0, 0, False
    i = 0
    while i < len(sql):
        ch = sql[i]
        if in_str:
            if ch == "'":
                in_str = False
        elif ch == "'":
            in_str = True
        elif ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif ch == ";" and depth == 0:
            text = sql[start:i].strip()
            if text:
                stmts.append(parse(text))
            start = i + 1
        i += 1
    tail = sql[start:].strip()
    if tail:
        stmts.append(parse(tail))
    return stmts
