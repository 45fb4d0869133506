"""Capacity scaling for the overflow -> rerun ladder, and the
connectors' distinct-count statistics traced through a plan.

The port's counterpart of presto_tpu/plan/stats.py::scale_capacities
and its ceilings. The reference multiplies every static capacity of a
plan when a run overflows one of them; the port's runner keeps one
factor per capacity node (group table, join output or unnest output)
and raises only
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

`estimate_distinct` is the reference's (presto_tpu/plan/stats.py): an
output channel traced to its base-table column takes the connector's
`column_distinct_count`, and a GroupId's
appended id column has one value per grouping set.
`estimate_group_bound` multiplies those bounds over a key tuple, and
`estimate_rows` is the reference's heuristic row estimate (a filter
keeps `_FILTER_SELECTIVITY` of its input, an equi-join the larger
side). Dynamic filtering (exec/dynfilter.py) reads `estimate_rows` at
run time to decide which build sides are small enough to run first;
the numbers are the reference's, so the same joins qualify.
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional, Tuple

from ..expr import ir as E
from . import nodes as N

__all__ = ["capacity_nodes", "scale_capacities", "column_source",
           "estimate_distinct", "estimate_group_bound", "estimate_rows",
           "refine_capacities"]

# guessed fraction of rows surviving one filter (the reference's value)
_FILTER_SELECTIVITY = 0.33

_MAX_GROUPS_CEILING = 1 << 23
# The reference stops a join's out_capacity at 1 << 24 rows, sized for
# a TPU chip's HBM. One H100 holds 80 GB, and TPC-DS q47/q57 at SF1
# (a three-way self-join on four keys, its rank conditions a filter
# above it, as the reference plans them) need more than 16.8M rows, so
# the port's ceiling is 1 << 26: the ladder's next step, x4.
_CAPACITY_CEILING = 1 << 26


def capacity_nodes(root: N.PlanNode) -> List[N.PlanNode]:
    """The plan's aggregation, join and unnest nodes in preorder, a
    shared subtree's once: the nodes a capacity factor applies to."""
    out: List[N.PlanNode] = []
    seen = set()

    def walk(n: N.PlanNode):
        if n.id in seen:
            return
        seen.add(n.id)
        if isinstance(n, (N.AggregationNode, N.JoinNode, N.UnnestNode)):
            out.append(n)
        for s in n.sources:
            walk(s)

    walk(root)
    return out


def scale_capacities(root: N.PlanNode, factors: Mapping[str, int],
                     default_join_capacity: int) -> N.PlanNode:
    """Rebuild the plan with each capacity node's static capacity
    multiplied by its factor in `factors` (by node id, 1 where absent):
    group tables, join out-capacities, a join without one starting at
    `default_join_capacity`, and unnest out-capacities, an unnest
    without one carrying the factor to the planner's default. Node ids
    and shared subtrees are kept."""
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
        if isinstance(n, N.UnnestNode) and k > 1:
            if n.out_capacity is None:  # the planner's default, times k
                changes["capacity_factor"] = k
            else:
                changes["out_capacity"] = min(n.out_capacity * k,
                                              _CAPACITY_CEILING)
        out = dataclasses.replace(n, **changes) if changes else n
        memo[id(n)] = out
        return out

    return walk(root)


def column_source(node: N.PlanNode, channel: int
                  ) -> Optional[Tuple[str, str, str]]:
    """Trace an output channel to its base-table column: (connector,
    table, column), or None when the channel is computed (expressions,
    aggregates, appended columns)."""
    if isinstance(node, N.TableScanNode):
        if 0 <= channel < len(node.columns):
            return (node.connector, node.table, node.columns[channel])
        return None
    if isinstance(node, N.ProjectNode):
        e = node.expressions[channel] \
            if 0 <= channel < len(node.expressions) else None
        if isinstance(e, E.InputReference):
            return column_source(node.source, e.channel)
        return None
    if isinstance(node, (N.FilterNode, N.SortNode, N.TopNNode, N.LimitNode,
                         N.DistinctNode, N.SampleNode, N.ExchangeNode,
                         N.OutputNode)):
        return column_source(node.sources[0], channel)
    if isinstance(node, N.JoinNode):
        nleft = len(node.left.output_types())
        if channel < nleft:
            return column_source(node.left, channel)
        rch = channel - nleft
        out = node.right_output_channels
        if out is not None:
            if not 0 <= rch < len(out):
                return None
            rch = out[rch]
        return column_source(node.right, rch)
    if isinstance(node, N.AggregationNode):
        # group keys pass the source column through; states do not
        if 0 <= channel < len(node.group_channels):
            return column_source(node.source, node.group_channels[channel])
        return None
    if isinstance(node, (N.SemiJoinNode, N.WindowNode, N.RowNumberNode,
                         N.MarkDistinctNode, N.AssignUniqueIdNode,
                         N.GroupIdNode)):
        # the source's channels pass through; appended ones are computed
        if channel < len(node.sources[0].output_types()):
            return column_source(node.sources[0], channel)
        return None
    return None


def estimate_distinct(node: N.PlanNode, channel: int,
                      sf: float) -> Optional[int]:
    """Distinct-count upper bound of one output channel from the
    originating connector's statistics; None where there is none."""
    if isinstance(node, N.GroupIdNode) and \
            channel == len(node.source.output_types()):
        return len(node.grouping_sets)  # the appended group id
    src = column_source(node, channel)
    if src is None:
        return None
    connector, table, column = src
    from ..connectors import catalog
    fn = getattr(catalog(connector), "column_distinct_count", None)
    if fn is None:
        return None
    try:
        return fn(table, column, sf)
    except KeyError:
        return None


def estimate_group_bound(node: N.PlanNode, channels, sf: float,
                         nullable_slack: int = 1) -> Optional[int]:
    """Upper bound on the distinct key tuples over `channels`: the
    product of the channels' bounds, each plus `nullable_slack` for a
    NULL group; None when a channel has no bound or the product passes
    2^30."""
    bound = 1
    for ch in channels:
        ndv = estimate_distinct(node, ch, sf)
        if ndv is None:
            return None
        bound *= ndv + nullable_slack
        if bound > 1 << 30:
            return None
    return bound


def refine_capacities(node: N.PlanNode, sf: float, _memo=None) -> N.PlanNode:
    """Capacity pass of prepare_plan (sf known): shrink group-table
    capacities to the distinct-count bound the connector proves, which
    puts a group-by with few groups on the small-table path
    (ops/aggregation.py, the `fused_limb_sums` kernel). Bounds are upper
    bounds, so shrinking cannot overflow; a capacity never grows.
    Memoized by identity, so a shared subtree stays one node."""
    _dc = dataclasses

    if _memo is None:
        _memo = {}
    if id(node) in _memo:
        return _memo[id(node)]
    orig_key = id(node)

    replaced = {}
    for f in _dc.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, N.PlanNode):
            nv = refine_capacities(v, sf, _memo)
            if nv is not v:
                replaced[f.name] = nv
        elif isinstance(v, list) and v and isinstance(v[0], N.PlanNode):
            nl = [refine_capacities(s, sf, _memo) for s in v]
            if any(a is not b for a, b in zip(nl, v)):
                replaced[f.name] = nl
    if replaced:
        node = _dc.replace(node, **replaced)

    if isinstance(node, N.AggregationNode) and node.group_channels:
        bound = estimate_group_bound(node.source, node.group_channels, sf)
        if bound is not None:
            cap = max(-(-bound // 8) * 8, 8)
            if cap < node.max_groups:
                node = _dc.replace(node, max_groups=cap)
    elif isinstance(node, N.DistinctNode) and node.key_channels is not None:
        bound = estimate_group_bound(node.source, node.key_channels, sf)
        if bound is not None:
            cap = max(-(-bound // 8) * 8, 8)
            if cap < node.max_groups:
                node = _dc.replace(node, max_groups=cap)
    _memo[orig_key] = node
    return node


def estimate_rows(node: N.PlanNode, sf: float) -> Optional[float]:
    """Heuristic output-row estimate, for relative cost choices only;
    None where a leaf has no row count."""
    if isinstance(node, N.TableScanNode):
        from ..connectors import catalog
        try:
            return float(catalog(node.connector)
                         .table_row_count(node.table, sf))
        except KeyError:  # an unknown connector or table
            return None
    if isinstance(node, N.ValuesNode):
        return float(len(node.rows))
    if isinstance(node, N.FilterNode):
        r = estimate_rows(node.source, sf)
        return None if r is None else r * _FILTER_SELECTIVITY
    if isinstance(node, N.SemiJoinNode):
        return estimate_rows(node.source, sf)
    if isinstance(node, N.JoinNode):
        left = estimate_rows(node.left, sf)
        right = estimate_rows(node.right, sf)
        if left is None or right is None:
            return None
        return max(left, right)  # the PK-FK case: the larger side
    if isinstance(node, N.AggregationNode):
        r = estimate_rows(node.source, sf)
        bound = estimate_group_bound(node.source, node.group_channels, sf)
        if not node.group_channels:
            return 1.0
        if bound is not None and r is not None:
            return float(min(r, bound))
        return r
    if isinstance(node, N.DistinctNode):
        return estimate_rows(node.source, sf)
    if isinstance(node, (N.TopNNode, N.LimitNode)):
        r = estimate_rows(node.sources[0], sf)
        cnt = float(node.count)
        return cnt if r is None else min(r, cnt)
    if isinstance(node, N.UnionNode):
        parts = [estimate_rows(s, sf) for s in node.inputs]
        if any(p is None for p in parts):
            return None
        return sum(parts)
    if isinstance(node, N.UnnestNode):
        r = estimate_rows(node.source, sf)
        return None if r is None else r * 4.0
    if isinstance(node, N.SampleNode):
        r = estimate_rows(node.source, sf)
        return None if r is None else r * node.ratio
    if isinstance(node, N.GroupIdNode):
        r = estimate_rows(node.source, sf)
        return None if r is None else r * len(node.grouping_sets)
    if node.sources:
        return estimate_rows(node.sources[0], sf)
    return None
