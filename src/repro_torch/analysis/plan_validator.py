"""Structural validator for compiled task DAGs.

``compile_dag`` destructively rewrites the optimized plan (operator inputs
are replaced with :class:`MaterializedNode` placeholders, ``ShuffleRead``
lanes are bound to producer vids), and the pipelined scheduler derives all
of its wiring — exchange fan-out, shuffle lane arrays, retention refcounts,
scratch-dir lifetime — from the compiled structure.  A malformed DAG does
not fail at compile time; it deadlocks a reader on an exchange nobody
writes, leaks spill files, or silently corrupts the plan cache.  This
module makes those failure modes loud at compile time:

  * every placeholder tag and dependency resolves to a vertex, and each
    vertex's ``deps`` list agrees with the placeholders actually reachable
    in its subtree (the scheduler trusts ``deps`` for topo order and the
    placeholders for wiring — disagreement means a vertex can start before
    its input exchange exists);
  * every vertex is reachable from the root, and every non-root vertex has
    at least one consumer (an orphan vertex's exchange retains every chunk
    until query end — an unbounded leak on large scans);
  * partitioned (shuffle) edges: lane indices are in range, agreeing specs
    cover every lane exactly, and the root never carries a lane array (the
    scheduler reads the root with ``read_all`` — nothing consumes lanes);
  * no leftover ``P.ShuffleRead`` nodes (compile must lower them all);
  * the DAG shares no plan-node objects with any plan-cache entry —
    compiling a cached plan in place (instead of the deep copy the cache
    probe hands out) would corrupt the cached "pristine" plan for every
    later session.

Validation runs on every compiled DAG when the session sets
``debug.validate_plans`` or the ``REPRO_VALIDATE_PLANS`` env var is set
(the test suite turns it on for the whole tier-1 run via an autouse
fixture); it is a no-op otherwise.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

ENV_FLAG = "REPRO_VALIDATE_PLANS"


class PlanValidationError(AssertionError):
    """A compiled DAG violates a structural invariant."""

    def __init__(self, violations: List[str]):
        self.violations = list(violations)
        super().__init__(
            "compiled DAG failed structural validation:\n  - "
            + "\n  - ".join(self.violations)
        )


def _plan_node_ids(plan) -> set:
    """ids of every node in a plan tree (placeholders are leaves)."""
    from ..core.runtime.dag import MaterializedNode

    seen, stack = set(), [plan]
    while stack:
        node = stack.pop()
        if id(node) in seen or node is None:
            continue
        seen.add(id(node))
        if isinstance(node, MaterializedNode):
            continue
        stack.extend(getattr(node, "inputs", ()))
        for rf in getattr(node, "runtime_filters", ()):
            stack.append(rf.producer)
    return seen


def validate_dag(dag, plan_cache=None, staged=None) -> List[str]:
    """All structural violations in ``dag`` (empty list = valid).

    ``staged`` names speculation clones the adaptive layer has added but
    not yet wired to a consumer: they are exempt from the orphan checks
    (their adoption — the consumer swap — is itself validated later), but
    their placeholders, deps, and lane indices are checked like any other
    vertex."""
    from ..core.optimizer import plan as P
    from ..core.runtime.dag import _walk_materialized, partitioned_edges

    v: List[str] = []
    vertices = dag.vertices

    if dag.root not in vertices:
        return [f"root vertex {dag.root!r} is not in the DAG"]

    # --- per-vertex: placeholders, deps, leftover ShuffleReads ------------
    readers: Dict[str, int] = {vid: 0 for vid in vertices}
    lane_readers: Dict[str, Dict[int, int]] = {}
    fed_by: Dict[str, set] = {vid: set() for vid in vertices}
    for vid, vert in vertices.items():
        tags = set()
        for mn in _walk_materialized(vert.plan):
            tags.add(mn.tag)
            if mn.tag not in vertices:
                v.append(f"{vid}: placeholder reads unknown vertex "
                         f"{mn.tag!r}")
                continue
            readers[mn.tag] += 1
            if mn.partition is not None:
                n = mn.num_partitions or 0
                if not (0 <= mn.partition < n):
                    v.append(f"{vid}: lane {mn.partition} of edge "
                             f"{mn.tag!r} out of range [0, {n})")
                lane_readers.setdefault(mn.tag, {})
                lane_readers[mn.tag][mn.partition] = \
                    lane_readers[mn.tag].get(mn.partition, 0) + 1
        expected = tags | set(vert.feeds)
        declared = set(vert.deps)
        for dep in declared - set(vertices):
            v.append(f"{vid}: declared dep {dep!r} is not in the DAG")
        if declared != expected:
            missing = expected - declared
            extra = declared - expected - (declared - set(vertices))
            if missing:
                v.append(f"{vid}: deps missing placeholder edges "
                         f"{sorted(missing)} — the scheduler may start "
                         f"this vertex before its inputs exist")
            if extra:
                v.append(f"{vid}: deps declare edges {sorted(extra)} with "
                         f"no placeholder or feed reading them")
        for dep in declared & set(vertices):
            fed_by[dep].add(vid)
        for node in _plan_node_ids_nodes(vert.plan):
            if isinstance(node, P.ShuffleRead):
                v.append(f"{vid}: leftover ShuffleRead (compile_dag must "
                         f"lower every lane read to a placeholder)")

    # --- reachability / orphan consumers ----------------------------------
    seen, stack = set(), [dag.root]
    while stack:
        cur = stack.pop()
        if cur in seen or cur not in vertices:
            continue
        seen.add(cur)
        stack.extend(vertices[cur].deps)
    staged = staged or ()
    for vid in sorted(set(vertices) - seen):
        if vid in staged:
            continue
        v.append(f"{vid}: unreachable from root {dag.root!r} (orphan "
                 f"vertex — its exchange would retain forever)")
    for vid in sorted(vertices):
        if vid == dag.root or vid in staged:
            continue
        if readers[vid] == 0 and not fed_by[vid]:
            v.append(f"{vid}: no consumer reads this vertex's exchange")

    # --- partitioned-edge lane coverage -----------------------------------
    specs = partitioned_edges(dag)
    if dag.root in specs:
        v.append(f"root {dag.root!r} carries a partitioned lane spec but "
                 f"is read via read_all — lanes would never drain")
    for tag, (n, _keys) in specs.items():
        if tag == dag.root:
            continue
        lanes = lane_readers.get(tag, {})
        uncovered = [i for i in range(n) if lanes.get(i, 0) == 0]
        if uncovered:
            v.append(f"edge {tag!r}: lanes {uncovered} of {n} have no "
                     f"reader — the ShuffleWriter would retain them "
                     f"until query end")

    # --- plan-cache aliasing ----------------------------------------------
    if plan_cache is not None:
        cached = _cached_plans(plan_cache)
        if cached:
            dag_ids = set()
            for vert in vertices.values():
                dag_ids |= _plan_node_ids(vert.plan)
            for key, ids in cached:
                shared = dag_ids & ids
                if shared:
                    v.append(
                        f"DAG shares {len(shared)} plan node(s) with "
                        f"cached plan {key[:60]!r}... — compile mutates "
                        f"node inputs in place, so the cached pristine "
                        f"plan is being corrupted (deepcopy on probe?)")
    return v


def _plan_node_ids_nodes(plan):
    """Every node object in a plan tree (excluding placeholder subtrees)."""
    from ..core.runtime.dag import MaterializedNode

    seen, stack, out = set(), [plan], []
    while stack:
        node = stack.pop()
        if node is None or id(node) in seen:
            continue
        seen.add(id(node))
        out.append(node)
        if isinstance(node, MaterializedNode):
            continue
        stack.extend(getattr(node, "inputs", ()))
        for rf in getattr(node, "runtime_filters", ()):
            stack.append(rf.producer)
    return out


def _cached_plans(plan_cache):
    """(key, node-id set) per live plan-cache entry."""
    lock = getattr(plan_cache, "_lock", None)
    entries = getattr(plan_cache, "_entries", None)
    if entries is None:
        return []
    if lock is not None:
        with lock:
            items = list(entries.items())
    else:
        items = list(entries.items())
    return [(key, _plan_node_ids(e.plan)) for key, e in items]


def check_dag(dag, plan_cache=None, staged=None) -> None:
    """Raise :class:`PlanValidationError` if ``dag`` is malformed.

    Runs the structural pass first, then (only on structurally sound DAGs,
    so findings never cascade) the schema-flow pass from
    :mod:`repro_torch.analysis.schema_check` — every caller of this chokepoint
    (the pipeline's compile/re-optimize hook, the adaptive ``_adopt``
    helper) therefore gets the typed schema contract checked as well."""
    violations = validate_dag(dag, plan_cache, staged=staged)
    if not violations:
        from .schema_check import validate_dag_schemas

        violations = validate_dag_schemas(dag)
    if violations:
        raise PlanValidationError(violations)


def validation_enabled(config: Optional[dict] = None) -> bool:
    if os.environ.get(ENV_FLAG):
        return True
    return bool(config and config.get("debug.validate_plans"))


def maybe_validate_dag(dag, config: Optional[dict] = None,
                       plan_cache=None) -> None:
    """The pipeline's hook: validate iff the debug config or env asks."""
    if validation_enabled(config):
        check_dag(dag, plan_cache)
