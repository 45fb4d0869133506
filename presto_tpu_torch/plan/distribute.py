"""AddExchanges: make a single-node plan correct on a mesh of workers.

Counterpart of presto_tpu/plan/distribute.py (`add_exchanges`,
`split_single_agg`), rule for rule, so that the port distributes a plan
exactly as the reference does (AddExchanges.java:183: decide each
operator's distribution and insert the REMOTE exchanges that give it
the rows it needs). Without it a SINGLE aggregation lowered on a mesh
would aggregate each worker's rows apart and emit per-worker partials
as final rows.

Distribution rules:
  * Aggregation(SINGLE, keys)   -> PARTIAL -> REPARTITION(keys) -> FINAL
  * Aggregation(SINGLE, global) -> PARTIAL -> GATHER -> FINAL
    (count(DISTINCT) and approx_percentile, whose partials do not
    merge, move raw rows instead: REPARTITION(keys) or GATHER, then
    the one step)
  * Distinct                    -> REPARTITION(keys) -> Distinct
  * Sort (order observable at root)
                                -> MERGE exchange over a local Sort (on
                                   the mesh: a sampled range
                                   repartition and a sort per worker)
  * Sort (order consumed above) -> GATHER -> Sort
  * TopN / Limit                -> partial per worker -> GATHER -> final
  * Window / RowNumber with PARTITION BY
                                -> REPARTITION(partition keys) -> local
  * Window / RowNumber unpartitioned
                                -> GATHER -> op
  * MarkDistinct                -> REPARTITION(keys) -> MarkDistinct
  * Join                        -> "broadcast": a REMOTE REPLICATE
                                   exchange over the build side;
                                   "partitioned": both sides
                                   REPARTITIONed by the join keys (always
                                   for RIGHT and FULL joins);
                                   "automatic": partitioned where
                                   plan/stats.py::estimate_rows puts the
                                   build above 2^20 rows
  * SemiJoin                    -> filtering side REPLICATEd
"""

from __future__ import annotations

import dataclasses as _dc
from . import nodes as N

__all__ = ["add_exchanges", "split_single_agg"]


def split_single_agg(agg: "N.AggregationNode",
                     exchange_kind: str = None) -> "N.PlanNode":
    """The one home of the SINGLE -> PARTIAL -> exchange -> FINAL rewrite
    (layout-sensitive: FINAL's group channels are 0..nkeys-1 of the
    exchanged partial table). exchange_kind defaults to REPARTITION by
    keys (GATHER when global); plan/fragment.py::distribute_simple_agg
    passes GATHER explicitly."""
    partial = N.AggregationNode(agg.source, agg.group_channels,
                                agg.aggregates, step="PARTIAL",
                                max_groups=agg.max_groups)
    nkeys = len(agg.group_channels)
    kind = exchange_kind or ("REPARTITION" if nkeys else "GATHER")
    if kind == "REPARTITION":
        ex = N.ExchangeNode(partial, kind="REPARTITION", scope="REMOTE",
                            partition_channels=list(range(nkeys)),
                            slot_capacity=agg.max_groups)
    else:
        ex = N.ExchangeNode(partial, kind="GATHER", scope="REMOTE")
    return N.AggregationNode(ex, list(range(nkeys)), agg.aggregates,
                             step="FINAL", max_groups=agg.max_groups)


def _is_repartition_on(node: N.PlanNode, keys) -> bool:
    return (isinstance(node, N.ExchangeNode)
            and node.kind == "REPARTITION"
            and list(node.partition_channels) == list(keys))


def _is_remote_exchange(node: N.PlanNode, *kinds: str) -> bool:
    """True when `node` is a REMOTE exchange of one of `kinds` (any kind
    when none given). Idempotency guards must name the kinds THIS pass
    inserts below the operator in question -- treating any remote
    exchange as already-distributed would skip e.g. a Sort above a
    pre-existing REPARTITION, leaving per-worker order only."""
    return (isinstance(node, N.ExchangeNode) and node.scope == "REMOTE"
            and (not kinds or node.kind in kinds))


def _is_merge_on(node: N.PlanNode, keys) -> bool:
    return (_is_remote_exchange(node, "MERGE")
            and list(node.sort_keys) == list(keys))


# node kinds through which output ordering survives to the root (the
# runner materializes distributed output in worker-then-row order, so a
# globally range-sorted distributed batch concatenates correctly)
_ORDER_TRANSPARENT = (N.ProjectNode, N.OutputNode)


# AUTOMATIC: build sides estimated at or below this many rows broadcast;
# larger builds repartition both sides (the reference's
# join-max-broadcast-table-size knob, expressed in rows because the
# engine's capacities are row-static)
_BROADCAST_ROW_LIMIT = 1 << 20


def add_exchanges(node: N.PlanNode,
                  join_strategy: str = "broadcast",
                  sf: float = None) -> N.PlanNode:
    """join_strategy: "broadcast" replicates every build side (the safe
    default); "partitioned" repartitions BOTH join sides by the join
    keys (DetermineJoinDistributionType's PARTITIONED choice -- right
    for large builds); "automatic" decides per join from connector
    statistics (DetermineJoinDistributionType.java's AUTOMATIC with a
    row-count cost model) and needs `sf` for the row estimates --
    without it, unknown-size builds fall back to broadcast."""
    return _visit(node, join_strategy, order_root=True, under=None, sf=sf,
                  memo={})


def _visit(node: N.PlanNode, join_strategy: str, order_root: bool,
           under, sf=None, memo=None) -> N.PlanNode:
    """`order_root`: this node's output order is observable at the plan
    root (only Project/Output ancestors). `under`: the exchange kind
    directly above, so already-distributed partials (the local Sort of a
    MERGE, the partial TopN/Limit of a GATHER) are not rewritten again
    on idempotent re-application. `memo` keys on (node identity,
    context) so a shared subtree (one object under several parents)
    stays shared through the rewrite, while equal copies (distinct
    objects with one id, as the plan passes leave them before
    prepare_plan's relabelling) are rewritten apart, as in the
    reference."""
    if memo is None:
        memo = {}
    memo_key = (id(node), order_root, under)
    if memo_key in memo:
        return memo[memo_key]
    child_order = order_root and isinstance(node, _ORDER_TRANSPARENT)
    # rebuild children first
    replaced = {}
    for f in _dc.fields(node):
        v = getattr(node, f.name)
        child_under = node.kind if isinstance(node, N.ExchangeNode) \
            and node.scope == "REMOTE" else None
        if isinstance(v, N.PlanNode):
            nv = _visit(v, join_strategy, child_order, child_under, sf, memo)
            if nv is not v:
                replaced[f.name] = nv
        elif isinstance(v, list) and v and isinstance(v[0], N.PlanNode):
            nl = [_visit(s, join_strategy, child_order, child_under, sf, memo)
                  for s in v]
            if any(a is not b for a, b in zip(nl, v)):
                replaced[f.name] = nl
    if replaced:
        node = _dc.replace(node, **replaced)
    memo[memo_key] = _rewrite(node, join_strategy, order_root, sf, under)
    return memo[memo_key]


def _rewrite(node: N.PlanNode, join_strategy: str, order_root: bool,
             sf, under) -> N.PlanNode:

    if isinstance(node, N.AggregationNode) and node.step == "SINGLE":
        if any(a.canonical in ("count_distinct", "approx_percentile")
               for a in node.aggregates):
            # non-mergeable partials: move RAW ROWS so every group is
            # wholly local, then aggregate in one step
            nkeys = len(node.group_channels)
            if nkeys:
                ex = N.ExchangeNode(node.source, kind="REPARTITION",
                                    scope="REMOTE",
                                    partition_channels=list(node.group_channels))
            else:
                ex = N.ExchangeNode(node.source, kind="GATHER", scope="REMOTE")
            return _dc.replace(node, source=ex)
        return split_single_agg(node)

    if isinstance(node, N.DistinctNode):
        keys = node.key_channels
        if keys is None:
            keys = list(range(len(node.source.output_types())))
        if _is_repartition_on(node.source, keys):
            return node
        ex = N.ExchangeNode(node.source, kind="REPARTITION", scope="REMOTE",
                            partition_channels=keys,
                            slot_capacity=node.max_groups)
        return _dc.replace(node, source=ex)

    if isinstance(node, N.SortNode):
        if under == "MERGE" or _is_remote_exchange(node.source, "GATHER") \
                or _is_merge_on(node.source, node.keys):
            return node  # the local sort of a MERGE / already gathered
        if order_root:
            local = N.SortNode(node.source, node.keys)
            return N.ExchangeNode(local, kind="MERGE", scope="REMOTE",
                                  sort_keys=list(node.keys))
        ex = N.ExchangeNode(node.source, kind="GATHER", scope="REMOTE")
        return _dc.replace(node, source=ex)

    if isinstance(node, (N.TopNNode, N.LimitNode)):
        if under == "GATHER" or _is_remote_exchange(node.source, "GATHER") \
                or (isinstance(node, N.TopNNode)
                    and _is_merge_on(node.source, node.keys)):
            return node  # the partial below / the final above the gather
        if isinstance(node, N.TopNNode):
            partial = N.TopNNode(node.source, node.keys, node.count)
        else:
            partial = N.LimitNode(node.source, node.count)
        ex = N.ExchangeNode(partial, kind="GATHER", scope="REMOTE")
        return _dc.replace(node, source=ex)

    if isinstance(node, (N.WindowNode, N.RowNumberNode)):
        keys = list(node.partition_channels)
        if keys:
            if _is_repartition_on(node.source, keys):
                return node
            # every PARTITION BY group lands wholly on one worker; the
            # window then runs partition-local with no gather
            ex = N.ExchangeNode(node.source, kind="REPARTITION",
                                scope="REMOTE", partition_channels=keys)
        else:
            if _is_remote_exchange(node.source, "GATHER"):
                return node
            ex = N.ExchangeNode(node.source, kind="GATHER", scope="REMOTE")
        return _dc.replace(node, source=ex)

    if isinstance(node, N.MarkDistinctNode):
        if _is_repartition_on(node.source, node.key_channels):
            return node
        ex = N.ExchangeNode(node.source, kind="REPARTITION", scope="REMOTE",
                            partition_channels=list(node.key_channels))
        return _dc.replace(node, source=ex)

    if isinstance(node, N.JoinNode):
        strategy = join_strategy
        if node.join_type in ("right", "full"):
            # outer-build emission requires each build row to live on
            # exactly ONE worker (a replicated build would emit its
            # unmatched rows once per worker) -- PARTITIONED always,
            # like the reference's mustPartition join-type check in
            # DetermineJoinDistributionType
            strategy = "partitioned"
        if strategy == "automatic":
            # cost model: broadcast only when the build side is provably
            # small (its replicated copy must fit every worker); unknown
            # sizes (or no sf to cost with) default to broadcast
            strategy = "broadcast"
            if sf is not None:
                from .stats import estimate_rows
                build = estimate_rows(node.right, sf)
                if build is not None and build > _BROADCAST_ROW_LIMIT:
                    strategy = "partitioned"
        if strategy == "partitioned":
            # repartition BOTH sides by the join keys: consumers then see
            # co-partitioned inputs and join locally (the large-build
            # PARTITIONED distribution). An existing exchange is reused
            # ONLY when it already repartitions on exactly these keys;
            # anything else (e.g. a GATHER under an ORDER BY subquery)
            # gets re-exchanged, else fanned-out consumers would probe a
            # side that lives wholly on task 0.
            left, right = node.left, node.right
            if not _is_repartition_on(left, node.left_keys):
                left = N.ExchangeNode(left, kind="REPARTITION",
                                      scope="REMOTE",
                                      partition_channels=list(node.left_keys))
            if not _is_repartition_on(right, node.right_keys):
                right = N.ExchangeNode(right, kind="REPARTITION",
                                       scope="REMOTE",
                                       partition_channels=list(node.right_keys))
            return _dc.replace(node, left=left, right=right,
                               distribution="partitioned")
        # broadcast: replicate the build side via an explicit REMOTE
        # REPLICATE exchange (the mesh lowers it to broadcast_build; a
        # fragment cut there has one buffer that all consumers read).
        right = node.right
        if not (isinstance(right, N.ExchangeNode)
                and right.kind == "REPLICATE"):
            right = N.ExchangeNode(right, kind="REPLICATE", scope="REMOTE")
        return _dc.replace(node, right=right, distribution="broadcast")

    if isinstance(node, N.SemiJoinNode):
        filt = node.filtering_source
        if not (isinstance(filt, N.ExchangeNode)
                and filt.kind == "REPLICATE"):
            filt = N.ExchangeNode(filt, kind="REPLICATE", scope="REMOTE")
        return _dc.replace(node, filtering_source=filt)

    return node
