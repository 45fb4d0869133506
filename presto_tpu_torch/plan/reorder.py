"""ReorderJoins: statistics-driven left-deep join ordering.

The port's copy of presto_tpu/plan/reorder.py. Every join is a build +
probe over static capacities, so the goal is to keep the largest
relation as the streaming probe side and to join the smallest builds
first, so that intermediate capacities stay small. A greedy left-deep
heuristic over the connectivity graph, driven by the connector row
estimates of plan/stats.py:

  1. FLATTEN a maximal chain of INNER equi-joins (looking through pure
     input-reference projections) into leaves + equality edges.
  2. Pick the largest-estimate leaf as the probe base; repeatedly join
     the smallest-estimate leaf connected to the joined set.
  3. Rebuild the left-deep JoinNode chain and restore the original
     output channel order with one projection.

The pass bails (returns the node unchanged) whenever anything makes
reordering unsafe or unjudgeable: non-inner joins in the chain, missing
row estimates, cross-join components, shared (CTE DAG) subtrees, or a
chain the heuristic would leave alone anyway.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..expr import ir as E
from . import nodes as N
from .stats import estimate_rows

__all__ = ["reorder_joins"]


@dataclasses.dataclass
class _Flat:
    """A flattened inner-equi-join chain."""
    leaves: List[N.PlanNode]
    # equality edges as ((leaf_a, chan_a), (leaf_b, chan_b))
    edges: List[Tuple[Tuple[int, int], Tuple[int, int]]]
    # the original root's output channels, as (leaf, leaf_channel)
    outputs: List[Tuple[int, int]]
    # largest explicit out_capacity among the chain's original joins
    # (user join_capacity hints must survive the rebuild)
    out_capacity: Optional[int] = None


def _shared_ids(root: N.PlanNode) -> set:
    """ids of nodes referenced from more than one parent (CTE DAGs)."""
    seen: set = set()
    shared: set = set()

    def walk(n: N.PlanNode):
        if id(n) in seen:
            shared.add(id(n))
            return
        seen.add(id(n))
        for s in n.sources:
            walk(s)

    walk(root)
    return shared


def _passthrough_map(node: N.PlanNode) -> Optional[Tuple[N.PlanNode,
                                                         List[int]]]:
    """If `node` is a projection of pure input references, return
    (source, [source_channel per output]); else None."""
    if not isinstance(node, N.ProjectNode):
        return None
    chans = []
    for e in node.expressions:
        if isinstance(e, E.InputReference):
            chans.append(e.channel)
        else:
            return None
    return node.source, chans


def _flatten(node: N.PlanNode, shared: set) -> Optional[_Flat]:
    """Flatten `node` (a JoinNode) into leaves/edges/outputs, or None
    when the chain is not a reorderable shape."""
    if not isinstance(node, N.JoinNode) or node.join_type != "inner" \
            or not node.left_keys:
        return None

    leaves: List[N.PlanNode] = []
    edges: List[Tuple[Tuple[int, int], Tuple[int, int]]] = []
    caps: List[int] = []

    def go(n: N.PlanNode) -> Optional[List[Tuple[int, int]]]:
        """Returns the (leaf, chan) identity of each output channel of
        `n`, flattening joins and pass-through projections; None to
        treat `n` as a single leaf."""
        if id(n) in shared:
            return None
        pm = _passthrough_map(n)
        if pm is not None:
            src, chans = pm
            inner = go(src)
            if inner is None:
                return None
            return [inner[c] for c in chans]
        if isinstance(n, N.JoinNode) and n.join_type == "inner" \
                and n.left_keys:
            if n.out_capacity is not None:
                caps.append(n.out_capacity)
            lmap = go(n.left)
            if lmap is None:
                lmap = _leaf(n.left)
            rmap = go(n.right)
            if rmap is None:
                rmap = _leaf(n.right)
            for lk, rk in zip(n.left_keys, n.right_keys):
                edges.append((lmap[lk], rmap[rk]))
            out = n.right_output_channels
            if out is None:
                out = list(range(len(rmap)))
            return lmap + [rmap[c] for c in out]
        return None

    def _leaf(n: N.PlanNode) -> List[Tuple[int, int]]:
        idx = len(leaves)
        leaves.append(n)
        return [(idx, c) for c in range(len(n.output_types()))]

    outputs = go(node)
    if outputs is None or len(leaves) < 3:
        # 2-way joins: distribution choice alone decides; nothing to
        # reorder
        return None
    return _Flat(leaves, edges, outputs, max(caps) if caps else None)


def _greedy_order(flat: _Flat, sf: float) -> Optional[List[int]]:
    """Leaf join order: largest first (probe base), then smallest
    connected build. None when estimates are missing or the graph
    disconnects (cross join somewhere)."""
    ests = []
    for leaf in flat.leaves:
        r = estimate_rows(leaf, sf)
        if r is None:
            return None
        ests.append(r)
    k = len(flat.leaves)
    adj: Dict[int, set] = {i: set() for i in range(k)}
    for (la, _), (lb, _) in flat.edges:
        adj[la].add(lb)
        adj[lb].add(la)
    order = [max(range(k), key=lambda i: ests[i])]
    joined = set(order)
    while len(order) < k:
        cands = [i for i in range(k) if i not in joined
                 and adj[i] & joined]
        if not cands:
            return None  # cross-join component: leave alone
        nxt = min(cands, key=lambda i: ests[i])
        order.append(nxt)
        joined.add(nxt)
    return order


def _rebuild(flat: _Flat, order: List[int]) -> N.PlanNode:
    """Left-deep chain in `order`, then a projection restoring the
    original output channels."""
    # position of each (leaf, chan) in the growing concatenation
    pos: Dict[Tuple[int, int], int] = {}
    width = 0

    def admit(leaf: int):
        nonlocal width
        for c in range(len(flat.leaves[leaf].output_types())):
            pos[(leaf, c)] = width + c
        width += len(flat.leaves[leaf].output_types())

    cur = flat.leaves[order[0]]
    admit(order[0])
    joined = {order[0]}
    for leaf in order[1:]:
        lk, rk = [], []
        for (a, ca), (b, cb) in flat.edges:
            if a == leaf and b in joined:
                lk.append(pos[(b, cb)])
                rk.append(ca)
            elif b == leaf and a in joined:
                lk.append(pos[(a, ca)])
                rk.append(cb)
        assert lk, "greedy order admitted an unconnected leaf"
        cur = N.JoinNode(cur, flat.leaves[leaf], lk, rk,
                         join_type="inner", out_capacity=flat.out_capacity)
        admit(leaf)
        joined.add(leaf)

    types = cur.output_types()
    exprs = [E.input_ref(pos[(leaf, c)], types[pos[(leaf, c)]])
             for leaf, c in flat.outputs]
    return N.ProjectNode(cur, exprs)


def reorder_joins(root: N.PlanNode, sf: float) -> N.PlanNode:
    """Rewrite every maximal inner-equi-join chain in cost order.
    Identity-memoized; shared (CTE) subtrees are left untouched."""
    shared = _shared_ids(root)
    memo: Dict[int, N.PlanNode] = {}

    def walk(n: N.PlanNode) -> N.PlanNode:
        if id(n) in memo:
            return memo[id(n)]
        orig = n
        flat = _flatten(n, shared) if isinstance(n, N.JoinNode) else None
        if flat is not None:
            order = _greedy_order(flat, sf)
            if order is not None and order != list(range(len(flat.leaves))):
                # recurse into the leaves (they may hold further chains
                # below non-join operators), then rebuild
                flat = _Flat([walk(l) for l in flat.leaves], flat.edges,
                             flat.outputs, flat.out_capacity)
                out = _rebuild(flat, order)
                memo[id(orig)] = out
                return out
        changes = {}
        for f in dataclasses.fields(n):
            v = getattr(n, f.name)
            if isinstance(v, N.PlanNode):
                w = walk(v)
                if w is not v:
                    changes[f.name] = w
            elif isinstance(v, list) and v and isinstance(v[0], N.PlanNode):
                w = [walk(x) for x in v]
                if any(a is not b for a, b in zip(w, v)):
                    changes[f.name] = w
        out = dataclasses.replace(n, **changes) if changes else n
        memo[id(orig)] = out
        return out

    return walk(root)
