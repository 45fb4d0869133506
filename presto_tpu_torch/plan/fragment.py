"""Plan fragmentation: stage boundaries at REMOTE exchanges.

Counterpart of presto_tpu/plan/fragment.py (`PlanFragment`,
`fragment_plan`, `distribute_simple_agg`; PlanFragmenter.java:48):
the optimized plan split at its REMOTE ExchangeNodes into
PlanFragments, each the unit a stage of tasks runs. The mesh does not
need them: it lowers the whole distributed plan as one program, its
exchanges moving rows between the workers (exec/planner.py). The
coordinator (server/coordinator.py::Coordinator.execute) cuts a plan
with `fragment_plan` and runs each fragment as a stage of tasks on the
HTTP workers; `distribute_simple_agg` makes the two-fragment plan of a
single aggregation. The fragments are kept equal to the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from .nodes import ExchangeNode, PlanNode, to_json

__all__ = ["PlanFragment", "fragment_plan", "distribute_simple_agg"]


def distribute_simple_agg(root: PlanNode) -> PlanNode:
    """The AddExchanges rule for the common shape: rewrite
    Output(Aggregation(SINGLE, pipeline)) into
    Output(FINAL-agg(REMOTE GATHER exchange(PARTIAL-agg(pipeline)))) so
    the scheduler can run the scan+partial stage on every worker and
    merge downstream (PushPartialAggregationThroughExchange analog)."""
    from .nodes import AggregationNode, ExchangeNode, OutputNode

    assert isinstance(root, OutputNode), "expected OutputNode root"
    node = root.source
    post = []
    while not isinstance(node, AggregationNode):
        # allow post-aggregation wrappers (project/sort/limit) to ride on top
        post.append(node)
        assert node.sources and len(node.sources) == 1, \
            "distribute_simple_agg expects a linear post-agg chain"
        node = node.sources[0]
    agg = node
    assert agg.step == "SINGLE", "aggregation already distributed"
    from .distribute import split_single_agg
    rebuilt = split_single_agg(agg, exchange_kind="GATHER")
    import dataclasses as _dc
    for wrapper in reversed(post):
        rebuilt = _dc.replace(wrapper, source=rebuilt)
    return OutputNode(rebuilt, root.names)


@dataclasses.dataclass
class PlanFragment:
    id: int
    root: PlanNode
    # partitioning of this fragment's OUTPUT (SINGLE for gathered,
    # HASH for repartitioned, BROADCAST for replicated, SORTED for a
    # locally sorted fragment whose consumer must k-way merge its tasks'
    # streams by `sort_keys` -- the MergeOperator edge)
    partitioning: str
    # ids of fragments feeding this one through remote exchanges
    remote_sources: List[int]
    # output-partitioning channels when partitioning == HASH
    partition_channels: List[int] = dataclasses.field(default_factory=list)
    # (channel, descending, nulls_last) when partitioning == SORTED
    sort_keys: List[tuple] = dataclasses.field(default_factory=list)

    def to_json(self) -> dict:
        return {"id": self.id, "partitioning": self.partitioning,
                "remoteSources": self.remote_sources,
                "partitionChannels": self.partition_channels,
                "sortKeys": [list(k) for k in self.sort_keys],
                "root": to_json(self.root)}


def fragment_plan(root: PlanNode) -> List[PlanFragment]:
    """Walk the tree, cutting at REMOTE exchanges: the child side becomes
    a new fragment and the consumer side is spliced with a
    RemoteSourceNode naming it -- the shape the scheduler ships to
    workers (each fragment is self-contained). Returns fragments
    root-last, ids in creation order. The input tree is not mutated;
    consumer-side nodes above a cut are shallow-copied.

    DAG-aware (CTE planned once): identical cuts -- same shared child
    subtree by identity, same output partitioning -- reuse ONE producer
    fragment; every reference gets its own RemoteSourceNode naming it
    (buffer pulls are non-destructive, so multiple consumers can read
    one producer -- the CteProducer/CteConsumer analog realized through
    buffer fan-out). Shared subtrees cut under DIFFERENT partitionings
    still duplicate (true CTE materialization + re-shuffle is a
    scheduler-depth item)."""
    import dataclasses as _dc

    from .nodes import RemoteSourceNode

    fragments: List[PlanFragment] = []
    memo = {}       # id(original node) -> (rebuilt node, feeds)
    cut_memo = {}   # (id(child), partitioning signature) -> fragment id

    def walk(node: PlanNode) -> Tuple[PlanNode, List[int]]:
        hit = memo.get(id(node))
        if hit is not None:
            return hit
        out = _walk(node)
        memo[id(node)] = out
        return out

    def _walk(node: PlanNode) -> Tuple[PlanNode, List[int]]:
        if isinstance(node, ExchangeNode) and node.scope == "REMOTE":
            part = ("HASH" if node.kind == "REPARTITION" else
                    "BROADCAST" if node.kind == "REPLICATE" else
                    "SORTED" if node.kind == "MERGE" else "SINGLE")
            ck = (id(node.source), part, tuple(node.partition_channels),
                  tuple(map(tuple, node.sort_keys or [])))
            if ck in cut_memo:
                fid = cut_memo[ck]
                types = fragments[fid].root.output_types()
                # a FRESH RemoteSourceNode per reference: consumers name
                # the shared producer independently in their specs
                return RemoteSourceNode(list(types), fid), [fid]
            child, child_feeds = walk(node.source)
            frag = PlanFragment(len(fragments), child, part, child_feeds,
                                list(node.partition_channels),
                                list(node.sort_keys or []))
            fragments.append(frag)
            cut_memo[ck] = frag.id
            rs = RemoteSourceNode(list(child.output_types()), frag.id)
            return rs, [frag.id]
        feeds: List[int] = []
        replaced = {}
        for f in _dc.fields(node):
            v = getattr(node, f.name)
            if isinstance(v, PlanNode):
                nv, fs = walk(v)
                feeds.extend(fs)
                if nv is not v:
                    replaced[f.name] = nv
            elif isinstance(v, list) and v and isinstance(v[0], PlanNode):
                nl = []
                changed = False
                for s in v:
                    nv, fs = walk(s)
                    feeds.extend(fs)
                    changed = changed or nv is not s
                    nl.append(nv)
                if changed:
                    replaced[f.name] = nl
        if replaced:
            node = _dc.replace(node, **replaced)
        return node, feeds

    new_root, feeds = walk(root)
    fragments.append(PlanFragment(len(fragments), new_root, "SINGLE", feeds))
    return fragments
