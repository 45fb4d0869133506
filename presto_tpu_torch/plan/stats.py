"""Capacity scaling for the overflow -> rerun ladder.

The port's own copy of presto_tpu/plan/stats.py::scale_capacities and
its ceilings. The runner multiplies every static capacity of a plan
(group tables, join out-capacities) when a run overflows one of them.
"""

from __future__ import annotations

import dataclasses

from . import nodes as N

__all__ = ["scale_capacities"]

_MAX_GROUPS_CEILING = 1 << 23
_CAPACITY_CEILING = 1 << 24


def scale_capacities(root: N.PlanNode, factor: int) -> N.PlanNode:
    """Rebuild the plan with every static capacity multiplied by
    `factor` (group tables, join out-capacities that are set),
    preserving shared subtrees."""
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
        if isinstance(n, N.AggregationNode):
            changes["max_groups"] = min(n.max_groups * factor,
                                        _MAX_GROUPS_CEILING)
        if isinstance(n, N.JoinNode) and n.out_capacity is not None:
            changes["out_capacity"] = min(n.out_capacity * factor,
                                          _CAPACITY_CEILING)
        out = dataclasses.replace(n, **changes) if changes else n
        memo[id(n)] = out
        return out

    return walk(root)
