"""Plan -> executable lowering: the LocalExecutionPlanner analog.

Counterpart of presto_tpu/exec/planner.py::compile_plan: the plan tree
becomes one Python function over the staged scan batches, calling the
operators in turn, once per worker of a mesh (parallel/mesh.py) or
once on one device without one. Join and aggregation
overflow (more matches than a join's out_capacity, more distinct keys
than max_groups, more elements than an unnest's out_capacity) is
returned as one device flag per capacity node; the runner owns the
rerun-bigger policy. Distinct and MarkDistinct sort
instead of filling a table (ops/misc.py) and have no flag.

Aggregation steps lower as the reference lowers them: SINGLE and
PARTIAL run `group_by` over rows, INTERMEDIATE and FINAL run
`merge_partials` over state tables, and SINGLE and FINAL finalize.
Without a mesh an ExchangeNode of any kind and scope is the identity,
as the reference's lowering without a mesh: one device holds every
partition. On a mesh a REMOTE exchange moves rows between the workers
(the reference's collectives), the capacity flags are ORed over the
workers and the exchange slots' overflow is a flag of its own, which
the runner cures by doubling every slot. A GroupId
node stacks one copy of its source per grouping set, so the capacity
nodes above it see that many times the rows. A ValuesNode is a leaf
whose batch the runner stages like a scan's; a SampleNode keeps the
rows whose slot hashes below its ratio.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Callable, List, Sequence, Tuple

import torch

from .. import types as T
from ..block import Batch, Column, concat_batches
from ..expr.compile import compile_filter, compile_projections
from ..expr.functions import mix64
from ..ops.aggregation import finalize_states, group_by, merge_partials
from ..ops.keys import SIGN
from ..ops.join import hash_join, semi_join_mask
from ..ops.misc import distinct, group_id, limit, mark_distinct
from ..ops.sort import sort_batch, top_n
from ..ops.unnest import unnest
from ..ops.window import WindowSpec, specs_of, window
from ..parallel.exchange import (any_flag, broadcast_build, exchange_by_hash,
                                 exchange_by_range, gather_to_root)
from ..plan import nodes as N
from ..plan.stats import capacity_nodes

__all__ = ["compile_plan", "CompiledPlan", "scan_leaves"]


@dataclasses.dataclass
class CompiledPlan:
    """fn(scan_batches) -> (Batch, overflow flags), and on a mesh
    fn(per-scan lists of worker batches) -> (worker batches, overflow
    flags, exchange-slot flag); `scan_nodes` lists the TableScanNodes,
    ValuesNodes and RemoteSourceNodes in the order their batches are
    supplied, and the flags are a bool vector, one per node of
    plan.stats.capacity_nodes of the plan, set where that node
    overflowed (on any worker)."""
    fn: Callable[[Sequence], Tuple]
    scan_nodes: List[N.PlanNode]
    output_types: List[T.Type]


def _walk_dag(node: N.PlanNode, scans: List[N.PlanNode],
              uses: Counter, seen: set) -> None:
    """The scan and values leaves in preorder, and per node id the
    number of edges that reach it: a shared subtree (one node id under
    several parents, plan.nodes.from_json) is walked once."""
    if node.id in seen:
        return
    seen.add(node.id)
    if isinstance(node, (N.TableScanNode, N.ValuesNode,
                         N.RemoteSourceNode)):
        scans.append(node)
    for s in node.sources:
        uses[s.id] += 1
        _walk_dag(s, scans, uses, seen)


def _note_exchange(kind: str) -> None:
    """One mesh exchange run: the QueryStats counters `exchange.<kind>`
    and `exchanges` of the ambient collector (EXPLAIN ANALYZE's
    collectives section), and an `exchange_shape` flight event. The
    reference counts its exchanges once per traced program; the port
    runs its closures on every dispatch and counts per dispatch."""
    from .stats import current_collector
    c = current_collector()
    if c is not None:
        c.note(f"exchange.{kind}")
        c.note("exchanges")
        from ..server.flight_recorder import record_event
        record_event("exchange_shape", query_id=c.query_id, shape=kind)


def scan_leaves(root: N.PlanNode) -> List[N.PlanNode]:
    """The plan's scan, values and remote-source leaves in the order
    compile_plan takes their batches (a shared subtree once), without
    lowering it."""
    scans: List[N.PlanNode] = []
    _walk_dag(root, scans, Counter(), set())
    return scans


def _channels(key) -> List[int]:
    return key if isinstance(key, list) else [key]


def sample(batch: Batch, ratio: float) -> Batch:
    """Deterministic Bernoulli: a row stays where the splitmix64 hash of
    its slot, as an unsigned 64-bit number, is at most ratio * (2^64 -
    1), the reference's rule (so the rows kept depend on the slots the
    table was staged in). Unsigned order of the int64 hash patterns is
    the signed order of `h ^ SIGN`."""
    h = mix64(torch.arange(batch.capacity, dtype=torch.int64,
                           device=batch.active.device))
    thresh = int(ratio * float(2 ** 64 - 1))
    if thresh >= 1 << 64:  # ratio 1.0 keeps every row
        return batch
    keep = (h ^ SIGN) <= (thresh - (1 << 63))
    return batch.with_active(batch.active & keep)


def _remote(node: N.PlanNode, kind: str) -> bool:
    return (isinstance(node, N.ExchangeNode) and node.kind == kind
            and node.scope == "REMOTE")


def _root_only(outs: List[Batch]) -> List[Batch]:
    """Worker 0's batch as it is, every other worker's inactive."""
    return [b if w == 0 else b.with_active(torch.zeros_like(b.active))
            for w, b in enumerate(outs)]


def _any(flags: Sequence[torch.Tensor]) -> torch.Tensor:
    """The OR of the workers' flags; one device's flag as it is, so that
    the path without a mesh launches nothing more."""
    return flags[0].reshape(()) if len(flags) == 1 else any_flag(flags)


def compile_plan(root: N.PlanNode, limb_form: str = "narrow",
                 default_join_capacity: int = 1 << 16, mesh=None,
                 exchange_slot_scale: int = 1) -> CompiledPlan:
    """Lower Scan/Values/Filter/Project/Aggregation (every step)/Join
    (inner, left, right, full)/SemiJoin/Sort/TopN/Limit/Distinct/Union/
    Sample/AssignUniqueId/MarkDistinct/Window/RowNumber/GroupId/Unnest/
    Exchange/Output. A join without an
    out_capacity gets `default_join_capacity`, an unnest without one
    four times its source's rows; `limb_form` picks the
    stacked limb lanes of the small-table group-by sums
    (ops/aggregation.py).

    With a `mesh` (parallel/mesh.py) the plan runs on every worker:
    `fn` takes, per scan, the list of the workers' batches and returns
    (the workers' output batches, the capacity flags ORed over the
    workers, the exchange-slot flag). Every REMOTE exchange moves rows
    (parallel/exchange.py), each slot `exchange_slot_scale` times its
    base (never above the sender's capacity, where no slot can
    overflow), and the reference's mesh-only rules hold: a global
    aggregation's FINAL row, and the rows after a GATHER, are active on
    worker 0 alone; a RIGHT or FULL join over a replicated build is
    refused; a broadcast build and a semi join's filtering side are
    replicated where no REPLICATE exchange did it; AssignUniqueId puts
    the worker in bits 40 and up."""
    scans: List[N.PlanNode] = []
    uses: Counter = Counter()
    _walk_dag(root, scans, uses, set())
    capacity_ids = [n.id for n in capacity_nodes(root)]
    dist = mesh is not None

    def scaled_slot(base: int, sender_capacity: int) -> int:
        # a sender never has more than its capacity in rows for one
        # receiver, so a larger slot cannot overflow
        return min(base * exchange_slot_scale, max(sender_capacity, 1))

    def run(scan_batches: Sequence):
        inputs = {n.id: list(b) if dist else [b]
                  for n, b in zip(scans, scan_batches)}
        # a shared subtree runs once; its output is kept until its last
        # parent has read it: node id -> [output, reads left]
        shared = {}
        overflow = {}
        slot_flags = []

        def lower(node: N.PlanNode) -> List[Batch]:
            """The node's output on each worker (one without a mesh)."""
            if node.id in inputs:
                return inputs[node.id]
            if uses[node.id] <= 1:
                return lower_node(node)
            if node.id not in shared:
                shared[node.id] = [lower_node(node), uses[node.id]]
            entry = shared[node.id]
            entry[1] -= 1
            if not entry[1]:
                del shared[node.id]
            return entry[0]

        def lower_node(node: N.PlanNode) -> List[Batch]:
            if isinstance(node, N.FilterNode):
                f = compile_filter(node.predicate)
                return [f(b) for b in lower(node.source)]
            if isinstance(node, N.ProjectNode):
                f = compile_projections(node.expressions)
                return [f(b) for b in lower(node.source)]
            if isinstance(node, N.AggregationNode):
                nkeys = len(node.group_channels)
                rs = []
                for b in lower(node.source):
                    if node.step in ("FINAL", "INTERMEDIATE"):
                        rs.append(merge_partials(b, nkeys, node.aggregates,
                                                 node.max_groups, limb_form))
                    else:  # SINGLE and PARTIAL aggregate rows
                        rs.append(group_by(b, node.group_channels,
                                           node.aggregates, node.max_groups,
                                           limb_form))
                overflow[node.id] = _any([r.overflow for r in rs])
                outs = [finalize_states(r.batch, nkeys, node.aggregates)
                        if node.step in ("SINGLE", "FINAL") else r.batch
                        for r in rs]
                if dist and not nkeys:
                    gathered = _remote(node.source, "GATHER")
                    if node.step == "SINGLE" and not gathered:
                        raise ValueError(
                            "a SINGLE global aggregation on a mesh would "
                            "emit one partial row per worker; run "
                            "plan.distribute.add_exchanges first (run_query "
                            "does)")
                    if node.step == "FINAL" or gathered:
                        outs = _root_only(outs)
                return outs
            if isinstance(node, N.ExchangeNode):
                return lower_exchange(node)
            if isinstance(node, N.JoinNode):
                probes = lower(node.left)
                builds = lower(node.right)
                replicated = _remote(node.right, "REPLICATE")
                if dist and node.join_type in ("right", "full") and \
                        (node.distribution == "broadcast" or replicated):
                    raise ValueError(
                        "a RIGHT or FULL join on a mesh needs PARTITIONED "
                        "distribution (a replicated build side would emit "
                        "its unmatched rows once per worker); run "
                        "plan.distribute.add_exchanges first (run_query "
                        "does)")
                if dist and node.distribution == "broadcast" and \
                        not replicated:
                    builds = broadcast_build(builds)
                cap = node.out_capacity or default_join_capacity
                rs = [hash_join(p, b, node.left_keys, node.right_keys, cap,
                                node.join_type, node.right_output_channels)
                      for p, b in zip(probes, builds)]
                overflow[node.id] = _any([r.overflow for r in rs])
                return [r.batch for r in rs]
            if isinstance(node, N.SemiJoinNode):
                srcs = lower(node.source)
                filts = lower(node.filtering_source)
                if dist and not _remote(node.filtering_source, "REPLICATE"):
                    filts = broadcast_build(filts)
                outs = []
                for src, filt in zip(srcs, filts):
                    m, mnull = semi_join_mask(src, filt,
                                              _channels(node.source_key),
                                              _channels(node.filtering_key),
                                              node.null_keys_match)
                    outs.append(Batch(src.columns + (
                        Column(m, mnull, T.BOOLEAN),), src.active))
                return outs
            if isinstance(node, N.SortNode):
                return [sort_batch(b, node.keys) for b in lower(node.source)]
            if isinstance(node, N.TopNNode):
                return [top_n(b, node.keys, node.count)
                        for b in lower(node.source)]
            if isinstance(node, N.LimitNode):
                return [limit(b, node.count) for b in lower(node.source)]
            if isinstance(node, N.DistinctNode):
                outs = []
                for src in lower(node.source):
                    keys = node.key_channels
                    if keys is None:
                        keys = range(src.num_columns)
                    outs.append(distinct(src, keys))
                return outs
            if isinstance(node, N.UnionNode):
                parts = [lower(s) for s in node.inputs]
                return [concat_batches(list(p)) for p in zip(*parts)]
            if isinstance(node, N.SampleNode):
                # each worker hashes its own row slots, as each shard of
                # the reference does
                return [sample(b, node.ratio) for b in lower(node.source)]
            if isinstance(node, N.AssignUniqueIdNode):
                # the row slot, and on a mesh the worker in bits 40 and
                # up (the reference's task salt)
                outs = []
                for w, src in enumerate(lower(node.source)):
                    rid = torch.arange(src.capacity, dtype=torch.int64,
                                       device=src.active.device)
                    if dist:
                        rid = rid | (w << 40)
                    outs.append(Batch(src.columns + (Column(
                        rid, torch.zeros_like(src.active), T.BIGINT),),
                        src.active))
                return outs
            if isinstance(node, N.MarkDistinctNode):
                outs = []
                for src in lower(node.source):
                    m = mark_distinct(src, node.key_channels)
                    outs.append(Batch(src.columns + (Column(
                        m, torch.zeros_like(m), T.BOOLEAN),), src.active))
                return outs
            if isinstance(node, N.WindowNode):
                specs = specs_of(node.functions)
                return [window(b, node.partition_channels, node.order_keys,
                               specs) for b in lower(node.source)]
            if isinstance(node, N.RowNumberNode):
                outs = []
                for b in lower(node.source):
                    out = window(b, node.partition_channels,
                                 node.order_keys, [WindowSpec("row_number")])
                    if node.max_rows_per_partition is not None:
                        rn = out.column(out.num_columns - 1)
                        out = out.with_active(
                            out.active
                            & (rn.values <= node.max_rows_per_partition))
                    outs.append(out)
                return outs
            if isinstance(node, N.UnnestNode):
                outs, flags = [], []
                for src in lower(node.source):
                    cap = node.out_capacity or \
                        src.capacity * 4 * node.capacity_factor
                    out, ovf = unnest(src, node.array_channel, cap,
                                      node.with_ordinality)
                    outs.append(out)
                    flags.append(ovf)
                overflow[node.id] = _any(flags)
                return outs
            if isinstance(node, N.GroupIdNode):
                return [group_id(b, node.grouping_sets, node.key_channels)
                        for b in lower(node.source)]
            if isinstance(node, N.OutputNode):
                return lower(node.source)
            raise NotImplementedError(f"{type(node).__name__} is not ported "
                                      "yet (ROADMAP queue 1)")

        def lower_exchange(node: N.ExchangeNode) -> List[Batch]:
            """Without a mesh, or at LOCAL scope, the identity (one
            device holds every partition). On a mesh: MERGE is a range
            exchange and a sort on each worker (the local Sort under it
            is skipped: the sort after the exchange orders every row),
            REPARTITION a hash exchange, REPLICATE broadcast_build and
            GATHER gather_to_root, active on worker 0 alone."""
            if not dist or node.scope != "REMOTE":
                return lower(node.source)
            _note_exchange({"MERGE": "range", "REPARTITION": "hash",
                            "REPLICATE": "broadcast",
                            "GATHER": "gather"}.get(node.kind, node.kind))
            if node.kind == "MERGE":
                src = node.source
                if isinstance(src, N.SortNode):
                    src = src.source
                inner = lower(src)
                cap = max(b.capacity for b in inner)
                slot = scaled_slot(
                    node.slot_capacity or max(4 * cap // mesh.size, 64), cap)
                outs, ovf = exchange_by_range(inner, node.sort_keys, slot)
                slot_flags.append(ovf)
                return [sort_batch(b, node.sort_keys) for b in outs]
            src = lower(node.source)
            cap = max(b.capacity for b in src)
            if node.kind == "REPARTITION":
                slot = scaled_slot(node.slot_capacity or max(cap, 1), cap)
                outs, ovf = exchange_by_hash(src, node.partition_channels,
                                             slot)
                slot_flags.append(ovf)
                return outs
            if node.kind == "REPLICATE":
                return broadcast_build(src)
            if node.kind == "GATHER":
                return _root_only(gather_to_root(src))
            raise ValueError(node.kind)

        outs = lower(root)
        dev = outs[0].active.device
        flags = [overflow[i].reshape(()).to(dev) for i in capacity_ids]
        flags = (torch.stack(flags) if flags else
                 torch.zeros(0, dtype=torch.bool, device=dev))
        # lower and lower_node refer to each other, so this frame's
        # dicts outlive the call until the cyclic collector runs: empty
        # them, or every staged batch stays on the device that long (a
        # stream of splits would hold several at once)
        inputs.clear()
        shared.clear()
        overflow.clear()
        if not dist:
            return outs[0], flags
        slots = any_flag(slot_flags) if slot_flags else \
            torch.zeros((), dtype=torch.bool, device=dev)
        slot_flags.clear()
        return outs, flags, slots

    return CompiledPlan(run, scans, root.output_types())
