"""Shared work optimization (paper §4.5).

Rather than searching for semantically equivalent subexpressions, Hive's
shared-work optimizer *merges equal parts of the plan* right before
execution: identical scans first, then identical operator prefixes above
them.  We implement the same reuse-based idea structurally: every subtree is
identified by its canonical key; keys that occur more than once are marked as
shared, and the executor computes them once and reuses the result (the
"shared edge" decision is left to the runtime, as the paper leaves it to
Tez).
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Set, Tuple

from . import plan as P


def find_shared_subplans(plan: P.PlanNode, min_occurrences: int = 2) -> Set[str]:
    """Return canonical keys of subtrees that appear multiple times.

    Only maximal shared subtrees are returned: if an entire join appears
    twice, its scans are not separately marked (reusing the larger result
    subsumes the smaller).
    """
    counts: Counter = Counter()
    nodes_by_key: Dict[str, P.PlanNode] = {}

    def visit(node: P.PlanNode):
        key = node.key()
        counts[key] += 1
        nodes_by_key[key] = node
        for c in node.inputs:
            visit(c)
        if isinstance(node, P.Scan):
            for rf in node.runtime_filters:
                visit(rf.producer)

    visit(plan)
    shared = {k for k, c in counts.items() if c >= min_occurrences}

    # keep only maximal shared subtrees
    maximal = set(shared)
    for k in shared:
        node = nodes_by_key[k]
        for child in _descendants(node):
            ck = child.key()
            if ck in maximal and counts[ck] == counts[k]:
                maximal.discard(ck)
    return maximal


def _descendants(node: P.PlanNode):
    for c in node.inputs:
        yield c
        yield from _descendants(c)


def shared_work_summary(plan: P.PlanNode) -> List[Tuple[str, int]]:
    counts: Counter = Counter()

    def visit(node):
        counts[node.describe()] += 1
        for c in node.inputs:
            visit(c)

    visit(plan)
    return [(k, v) for k, v in counts.items() if v > 1]
