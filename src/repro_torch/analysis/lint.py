"""Repo-specific invariant lint (AST-based).

Five checkers encode invariants the warehouse runtime depends on but the
language cannot express.  Each has bitten (or nearly bitten) this codebase:

REP001  every ``config.get("key")`` call site must name a key declared in
        ``repro_torch.core.config_keys`` — an undeclared key silently reads its
        hard-coded fallback forever (``keep_acid_cols`` shipped that way).
REP002  operator *generator* loops that drain an exchange/shuffle/split
        reader must observe the cancel token at batch boundaries
        (``.check()`` / ``._checkpoint()``) — a missed check turns query
        cancellation into "runs to completion anyway" on that edge.
REP003  no new ``_collect`` (full materialization) call sites: spilling
        exchanges exist so operators stream; the three legacy sites
        (sort/window/global-aggregate) are allowlisted until their
        streaming rewrites land.
REP004  lock hygiene: a bare ``lock.acquire()`` statement must be
        immediately followed by ``try/finally: release`` (else an
        exception leaks a held lock), and ``cond.wait()`` must sit inside
        a predicate loop (``while``) — a bare wait misses wakeups and
        deadlocks on spurious ones.
REP005  a running query's DAG (``vertices`` / ``deps`` / ``edge_types``)
        may only be mutated by ``compile_dag``'s construction (dag.py) or
        inside the ``apply``/``undo`` closures the adaptive layer hands to
        its validating adopt-helper (``AdaptiveManager._adopt`` re-checks
        the whole DAG with ``check_dag`` and rolls back on violation) —
        any other mid-query structural edit bypasses validation and can
        wedge the pipelined scheduler.
REP006  streaming operators (generator functions) must derive output
        columns from the input batch or the node's declared schema, never
        from a hard-coded ``VectorBatch({...})`` dict literal — literal
        column names drift silently when the schema contract
        (``repro_torch.core.schema``) evolves, and the static checker
        (SCH001-006) cannot see them.  Hidden ``__``-prefixed columns
        (ACID bookkeeping, dummy evaluation rows) are exempt.
REP007  traced subsystems (``core/runtime``, ``core/serving``,
        ``core/federation``) must not read ``time.monotonic()`` /
        ``time.perf_counter()`` directly — timing goes through
        ``repro_torch.core.obs.clock`` (or a trace span), so every duration a
        trace, metric, or EXPLAIN ANALYZE reports comes off one clock.
        Raw reads drift out of trace timelines silently (the tracer
        timestamps spans on the obs clock).  The obs package itself and
        two wait-timing sites (WLM admission deadlines, the exchange
        stall detector) are allowlisted.

Findings can be suppressed per line with ``# repro-lint: REPnnn`` (comma
separated, or ``all``).  The CLI (``python -m repro_torch.analysis``) exits
nonzero iff any unsuppressed finding remains.
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

CODES = {
    "REP001": "undeclared session-config key",
    "REP002": "reader loop misses cancel check",
    "REP003": "full materialization outside allowlist",
    "REP004": "lock/condition misuse",
    "REP005": "live-DAG mutation outside validated adoption",
    "REP006": "operator builds VectorBatch from a dict literal",
    "REP007": "raw clock read in a traced subsystem (use obs clock)",
}

# REP001 only polices the warehouse runtime; the modeling/training side of
# the repo has its own config conventions.
EXCLUDE_DIRS = {"models", "train", "configs", "distributed", "launch",
                "kernels", "__pycache__"}

# receivers whose .get() is a session-config read
_CONFIG_RECEIVERS = {"config", "cfg", "session_config"}

# reader-producing calls whose drain loops must be cancellable (REP002)
_READER_CALLS = {"reader", "lane_reader", "read_split"}

# cancel-observation calls that satisfy REP002
_CANCEL_CALLS = {"check", "_checkpoint"}

# DAG structural state (REP005): attributes whose mutation rewires a
# running query's DAG
_DAG_STRUCT_ATTRS = {"vertices", "deps", "edge_types"}

# container methods that mutate in place (REP005)
_MUTATING_METHODS = {"pop", "update", "clear", "append", "extend",
                     "insert", "remove", "setdefault", "popitem"}

# where DAG structure may legitimately change: dag.py builds the DAG
# before the scheduler adopts it; in adaptive.py only the apply/undo
# closures executed by the validating adopt-helper may rewrite it
_DAG_MUTATION_FILES = {"dag.py"}
_DAG_MUTATION_FUNCS = {"apply", "undo"}

# (file basename, enclosing function) pairs allowed to _collect (REP003):
# the sort / global-aggregate / window operators still materialize their
# input; each carries a TODO for the streaming rewrite.
COLLECT_ALLOWLIST: Set[Tuple[str, str]] = {
    ("exec.py", "_stream_sort"),
    ("exec.py", "_aggregate_materialized"),
    ("exec.py", "_stream_windowop"),
}

# raw time.* attributes REP007 polices in traced subsystems
_RAW_CLOCK_ATTRS = {"monotonic", "perf_counter"}

# REP007 subtree gate: which path segments put a file in a traced subsystem
_REP007_SUBSYSTEMS = {"runtime", "serving", "federation"}

# (file basename, enclosing function) pairs allowed to read raw clocks
# (REP007): these sites time *waiting*, not traced work — WLM admission
# deadline math and the exchange stall detector — and must not perturb
# the obs clock's span timeline semantics.
REP007_ALLOWLIST: Set[Tuple[str, str]] = {
    ("wlm.py", "wait_admit"),
    ("scheduler.py", "_put"),
}


def _rep007_applies(path: str) -> bool:
    """REP007 scope: inside the repro_torch package only ``core/runtime``,
    ``core/serving`` and ``core/federation`` (never the obs layer itself,
    which aliases the raw clocks); outside the package (the lint fixture)
    the check always applies."""
    parts = path.replace(os.sep, "/").split("/")
    if "obs" in parts:
        return False
    if "repro_torch" in parts:
        return "core" in parts and bool(_REP007_SUBSYSTEMS & set(parts))
    return True

_SUPPRESS_RE = re.compile(r"#\s*repro-lint:\s*([A-Za-z0-9_,\s]+)")


@dataclass(frozen=True)
class Finding:
    path: str
    line: int
    code: str
    message: str

    def __str__(self):
        return f"{self.path}:{self.line}: {self.code} {self.message}"


def _suppressions(source: str) -> Dict[int, Set[str]]:
    """line number -> set of suppressed codes (or {'all'})."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if m:
            codes = {c.strip().upper() for c in m.group(1).split(",")
                     if c.strip()}
            out[i] = {"ALL"} if "ALL" in codes else codes
    return out


def _terminal_name(node: ast.AST) -> Optional[str]:
    """The last name segment of a Name / Attribute chain."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _is_call_to(node: ast.AST, names: Set[str]) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in names)


class _Checker(ast.NodeVisitor):
    def __init__(self, path: str, declared_keys: Optional[Set[str]]):
        self.path = path
        self.base = os.path.basename(path)
        self.declared = declared_keys
        self.findings: List[Finding] = []
        self._func_stack: List[ast.AST] = []   # enclosing function nodes
        self._gen_stack: List[bool] = []       # is that function a generator?
        self._while_depth = 0
        self.check_config = True               # REP001 scope gate
        self.check_clock = _rep007_applies(path)  # REP007 scope gate

    # ------------------------------------------------------------- helpers
    def _emit(self, code: str, line: int, message: str) -> None:
        self.findings.append(Finding(self.path, line, code, message))

    def _current_func_name(self) -> Optional[str]:
        return self._func_stack[-1].name if self._func_stack else None

    def _in_generator(self) -> bool:
        return bool(self._gen_stack) and self._gen_stack[-1]

    @staticmethod
    def _is_generator(fn: ast.AST) -> bool:
        # manual walk that skips nested function bodies
        stack = list(ast.iter_child_nodes(fn))
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            if isinstance(node, (ast.Yield, ast.YieldFrom)):
                return True
            stack.extend(ast.iter_child_nodes(node))
        return False

    # ----------------------------------------------------------- traversal
    def visit_FunctionDef(self, node):
        self._func_stack.append(node)
        self._gen_stack.append(self._is_generator(node))
        self._check_body_statements(node.body)
        self.generic_visit(node)
        self._func_stack.pop()
        self._gen_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_While(self, node):
        self._while_depth += 1
        self.generic_visit(node)
        self._while_depth -= 1

    def visit_Module(self, node):
        self._check_body_statements(node.body)
        self.generic_visit(node)

    def visit_If(self, node):
        self._check_body_statements(node.body)
        self._check_body_statements(node.orelse)
        self.generic_visit(node)

    def visit_With(self, node):
        self._check_body_statements(node.body)
        self.generic_visit(node)

    def visit_Try(self, node):
        self._check_body_statements(node.body)
        self._check_body_statements(node.finalbody)
        self._check_body_statements(node.orelse)
        for handler in node.handlers:
            self._check_body_statements(handler.body)
        self.generic_visit(node)

    # --------------------------------------------------------------- REP001
    def visit_Call(self, node):
        if (self.check_config and self.declared is not None
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "get" and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            recv = _terminal_name(node.func.value)
            if recv in _CONFIG_RECEIVERS:
                key = node.args[0].value
                if key not in self.declared:
                    self._emit(
                        "REP001", node.lineno,
                        f"config key {key!r} is not declared in "
                        f"repro_torch.core.config_keys",
                    )
        # REP003: _collect call sites
        callee = None
        if isinstance(node.func, ast.Attribute):
            callee = node.func.attr
        elif isinstance(node.func, ast.Name):
            callee = node.func.id
        if callee == "_collect":
            fn = self._current_func_name() or "<module>"
            if ((self.base, fn) not in COLLECT_ALLOWLIST
                    and fn != "_collect"):
                self._emit(
                    "REP003", node.lineno,
                    f"_collect (full materialization) in {fn}() is not "
                    f"allowlisted — stream through the exchange instead",
                )
        # REP005: in-place mutation via container methods
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _MUTATING_METHODS):
            attr = self._dag_struct_attr(node.func.value)
            if attr is not None:
                self._check_dag_mutation(node, attr,
                                         f".{node.func.attr}()")
        # REP007: raw time.monotonic()/time.perf_counter() in a traced
        # subsystem — timing there must come off the obs clock
        if (self.check_clock
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _RAW_CLOCK_ATTRS
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "time"):
            fn = self._current_func_name() or "<module>"
            if (self.base, fn) not in REP007_ALLOWLIST:
                self._emit(
                    "REP007", node.lineno,
                    f"raw time.{node.func.attr}() in {fn}() — traced "
                    f"subsystems time through repro_torch.core.obs.clock (or a "
                    f"span) so traces, metrics, and EXPLAIN ANALYZE share "
                    f"one clock",
                )
        # REP006: VectorBatch({...}) dict literal inside an operator
        if (self._in_generator()
                and _terminal_name(node.func) == "VectorBatch"
                and node.args and isinstance(node.args[0], ast.Dict)):
            literal_names = [
                k.value for k in node.args[0].keys
                if isinstance(k, ast.Constant) and isinstance(k.value, str)
                and not k.value.startswith("__")
            ]
            if literal_names:
                self._emit(
                    "REP006", node.lineno,
                    f"operator hard-codes output column(s) "
                    f"{literal_names[:4]} in a VectorBatch dict literal — "
                    f"derive names from the input batch or the node's "
                    f"declared schema so the schema contract can check "
                    f"them",
                )
        self.generic_visit(node)

    # --------------------------------------------------------------- REP002
    def visit_For(self, node):
        if self._in_generator() and _is_call_to(node.iter, _READER_CALLS):
            observed = any(
                _is_call_to(inner, _CANCEL_CALLS)
                for stmt in node.body
                for inner in ast.walk(stmt)
            )
            if not observed:
                src = node.iter.func.attr  # type: ignore[union-attr]
                self._emit(
                    "REP002", node.lineno,
                    f"generator loop over .{src}() never observes the "
                    f"cancel token (call .check() or self._checkpoint() "
                    f"once per batch)",
                )
        self.generic_visit(node)

    # --------------------------------------------------------------- REP005
    def _dag_struct_attr(self, node: ast.AST) -> Optional[str]:
        """``vertices``/``deps``/``edge_types`` if ``node`` is an attribute
        access on one of them (``dag.vertices``, ``merge.deps``, ...)."""
        if (isinstance(node, ast.Attribute)
                and node.attr in _DAG_STRUCT_ATTRS):
            return node.attr
        return None

    def _dag_mutation_allowed(self) -> bool:
        if self.base in _DAG_MUTATION_FILES:
            return True
        if self.base == "adaptive.py":
            return self._current_func_name() in _DAG_MUTATION_FUNCS
        return False

    def _check_dag_mutation(self, node: ast.AST, attr: str,
                            what: str) -> None:
        if self._dag_mutation_allowed():
            return
        self._emit(
            "REP005", node.lineno,
            f"{what} of .{attr} mutates a live DAG outside the validating "
            f"adopt-helper — route the rewrite through an apply/undo pair "
            f"given to AdaptiveManager._adopt (it re-runs check_dag and "
            f"rolls back on violation)",
        )

    def _check_mutation_targets(self, targets: Iterable[ast.AST],
                                stmt: ast.AST, what: str) -> None:
        for tgt in targets:
            attr = None
            if isinstance(tgt, ast.Subscript):
                attr = self._dag_struct_attr(tgt.value)
            else:
                attr = self._dag_struct_attr(tgt)
            if attr is not None:
                self._check_dag_mutation(stmt, attr, what)

    def visit_Assign(self, node):
        self._check_mutation_targets(node.targets, node, "assignment")
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        self._check_mutation_targets([node.target], node, "assignment")
        self.generic_visit(node)

    def visit_Delete(self, node):
        self._check_mutation_targets(node.targets, node, "deletion")
        self.generic_visit(node)

    # --------------------------------------------------------------- REP004
    def _check_body_statements(self, body: Sequence[ast.stmt]) -> None:
        """Bare ``x.acquire()`` must be immediately followed by a
        try/finally that releases."""
        for i, stmt in enumerate(body):
            if not (isinstance(stmt, ast.Expr)
                    and _is_call_to(stmt.value, {"acquire"})):
                continue
            nxt = body[i + 1] if i + 1 < len(body) else None
            ok = (isinstance(nxt, ast.Try) and any(
                _is_call_to(inner, {"release"})
                for fstmt in nxt.finalbody
                for inner in ast.walk(fstmt)
            ))
            if not ok:
                recv = _terminal_name(stmt.value.func.value) or "lock"
                self._emit(
                    "REP004", stmt.lineno,
                    f"bare {recv}.acquire() without an immediate "
                    f"try/finally release — an exception here leaks a "
                    f"held lock (prefer `with {recv}:`)",
                )

    def visit_Expr(self, node):
        # cond.wait() outside a predicate loop
        call = node.value
        if (isinstance(call, ast.Call)
                and isinstance(call.func, ast.Attribute)
                and call.func.attr == "wait"):
            recv = _terminal_name(call.func.value) or ""
            if "cond" in recv.lower() and self._while_depth == 0:
                self._emit(
                    "REP004", node.lineno,
                    f"{recv}.wait() outside a `while <predicate>` loop — "
                    f"spurious/missed wakeups require re-checking the "
                    f"predicate (or use wait_for)",
                )
        self.generic_visit(node)


def _declared_keys() -> Optional[Set[str]]:
    try:
        from repro_torch.core.config_keys import CONFIG_KEYS
        return set(CONFIG_KEYS)
    except Exception:  # registry import failure: skip REP001, lint the rest
        return None


def lint_source(source: str, path: str = "<string>",
                declared_keys: Optional[Set[str]] = None) -> List[Finding]:
    """Lint one source blob; returns unsuppressed findings."""
    tree = ast.parse(source, filename=path)
    checker = _Checker(path, declared_keys if declared_keys is not None
                       else _declared_keys())
    # REP001 scope: warehouse code only
    parts = set(path.replace(os.sep, "/").split("/"))
    if parts & EXCLUDE_DIRS:
        checker.check_config = False
    checker.visit(tree)
    suppress = _suppressions(source)
    out = []
    for f in sorted(checker.findings, key=lambda f: (f.line, f.code)):
        codes = suppress.get(f.line, ())
        if "ALL" in codes or f.code in codes:
            continue
        out.append(f)
    return out


def lint_file(path: str,
              declared_keys: Optional[Set[str]] = None) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as fh:
        return lint_source(fh.read(), path, declared_keys)


def iter_python_files(root: str) -> Iterable[str]:
    if os.path.isfile(root):
        yield root
        return
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in sorted(filenames):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def lint_paths(paths: Sequence[str]) -> List[Finding]:
    declared = _declared_keys()
    findings: List[Finding] = []
    for root in paths:
        for path in iter_python_files(root):
            findings.extend(lint_file(path, declared))
    return findings
