"""Capacity scaling for the overflow -> rerun ladder.

The port's counterpart of presto_tpu/plan/stats.py::scale_capacities
and its ceilings. The reference multiplies every static capacity of a
plan when a run overflows one of them; the port's runner keeps one
factor per capacity node (group table or join output) and raises only
the factors of the nodes that overflowed, so that a join's overflow
does not also move a small aggregation off its small-table path.

The reference also scales the `max_groups` of its DistinctNode and
MarkDistinctNode, whose hash-slot tables can overflow. The port finds
distinct keys by a sort (ops/misc.py), which has no table and cannot
overflow, so those nodes are not capacity nodes here; the rows are the
same either way. A two-stage plan's PARTIAL and FINAL aggregations are
two capacity nodes, each with its own factor; exchange slot capacities
are not scaled, as in the reference (and on one device an exchange is
the identity).
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping

from . import nodes as N

__all__ = ["capacity_nodes", "scale_capacities"]

_MAX_GROUPS_CEILING = 1 << 23
_CAPACITY_CEILING = 1 << 24


def capacity_nodes(root: N.PlanNode) -> List[N.PlanNode]:
    """The plan's aggregation and join nodes in preorder, a shared
    subtree's once: the nodes a capacity factor applies to."""
    out: List[N.PlanNode] = []
    seen = set()

    def walk(n: N.PlanNode):
        if n.id in seen:
            return
        seen.add(n.id)
        if isinstance(n, (N.AggregationNode, N.JoinNode)):
            out.append(n)
        for s in n.sources:
            walk(s)

    walk(root)
    return out


def scale_capacities(root: N.PlanNode, factors: Mapping[str, int],
                     default_join_capacity: int) -> N.PlanNode:
    """Rebuild the plan with each capacity node's static capacity
    multiplied by its factor in `factors` (by node id, 1 where absent):
    group tables, and join out-capacities, a join without one starting
    at `default_join_capacity`. Node ids and shared subtrees are kept."""
    memo: dict = {}

    def walk(n: N.PlanNode) -> N.PlanNode:
        if id(n) in memo:
            return memo[id(n)]
        changes = {}
        for f in dataclasses.fields(n):
            v = getattr(n, f.name)
            if isinstance(v, N.PlanNode):
                w = walk(v)
                if w is not v:
                    changes[f.name] = w
            elif isinstance(v, list) and v and isinstance(v[0], N.PlanNode):
                w = [walk(x) for x in v]  # a UnionNode's inputs
                if any(a is not b for a, b in zip(w, v)):
                    changes[f.name] = w
        k = factors.get(n.id, 1)
        if isinstance(n, N.AggregationNode) and k > 1:
            changes["max_groups"] = min(n.max_groups * k,
                                        _MAX_GROUPS_CEILING)
        if isinstance(n, N.JoinNode):
            if n.out_capacity is None:
                changes["out_capacity"] = default_join_capacity * k
            elif k > 1:
                changes["out_capacity"] = min(n.out_capacity * k,
                                              _CAPACITY_CEILING)
        out = dataclasses.replace(n, **changes) if changes else n
        memo[id(n)] = out
        return out

    return walk(root)
