"""Plan -> executable lowering: the LocalExecutionPlanner analog.

Counterpart of presto_tpu/exec/planner.py::compile_plan for one device
and no mesh: the plan tree becomes one Python function over the staged
scan batches, calling the operators in turn. Join and aggregation
overflow (more matches than a join's out_capacity, more distinct keys
than max_groups, more elements than an unnest's out_capacity) is
returned as one device flag per capacity node; the runner owns the
rerun-bigger policy. Distinct and MarkDistinct sort
instead of filling a table (ops/misc.py) and have no flag.

Aggregation steps lower as the reference lowers them: SINGLE and
PARTIAL run `group_by` over rows, INTERMEDIATE and FINAL run
`merge_partials` over state tables, and SINGLE and FINAL finalize. An
ExchangeNode of any kind and scope is the identity, as the reference's
lowering without a mesh: one device holds every partition. A GroupId
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
from ..plan import nodes as N
from ..plan.stats import capacity_nodes

__all__ = ["compile_plan", "CompiledPlan"]


@dataclasses.dataclass
class CompiledPlan:
    """fn(scan_batches) -> (Batch, overflow flags); `scan_nodes` lists the
    TableScanNodes and ValuesNodes in the order their batches are
    supplied, and the
    flags are a bool vector, one per node of plan.stats.capacity_nodes
    of the plan, set where that node overflowed."""
    fn: Callable[[Sequence[Batch]], Tuple[Batch, torch.Tensor]]
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
    if isinstance(node, (N.TableScanNode, N.ValuesNode)):
        scans.append(node)
    for s in node.sources:
        uses[s.id] += 1
        _walk_dag(s, scans, uses, seen)


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


def compile_plan(root: N.PlanNode, limb_form: str = "narrow",
                 default_join_capacity: int = 1 << 16) -> CompiledPlan:
    """Lower Scan/Values/Filter/Project/Aggregation (every step)/Join
    (inner, left, right, full)/SemiJoin/Sort/TopN/Limit/Distinct/Union/
    Sample/AssignUniqueId/MarkDistinct/Window/RowNumber/GroupId/Unnest/
    Exchange/Output. A join without an
    out_capacity gets `default_join_capacity`, an unnest without one
    four times its source's rows; `limb_form` picks the
    stacked limb lanes of the small-table group-by sums
    (ops/aggregation.py)."""
    scans: List[N.PlanNode] = []
    uses: Counter = Counter()
    _walk_dag(root, scans, uses, set())
    capacity_ids = [n.id for n in capacity_nodes(root)]

    def run(scan_batches: Sequence[Batch]):
        inputs = {n.id: b for n, b in zip(scans, scan_batches)}
        # a shared subtree runs once; its output is kept until its last
        # parent has read it: node id -> [output, reads left]
        shared = {}
        overflow = {}

        def lower(node: N.PlanNode) -> Batch:
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

        def lower_node(node: N.PlanNode) -> Batch:
            if isinstance(node, N.FilterNode):
                return compile_filter(node.predicate)(lower(node.source))
            if isinstance(node, N.ProjectNode):
                return compile_projections(node.expressions)(
                    lower(node.source))
            if isinstance(node, N.AggregationNode):
                src = lower(node.source)
                nkeys = len(node.group_channels)
                if node.step in ("FINAL", "INTERMEDIATE"):
                    r = merge_partials(src, nkeys, node.aggregates,
                                       node.max_groups, limb_form)
                else:  # SINGLE and PARTIAL aggregate rows
                    r = group_by(src, node.group_channels, node.aggregates,
                                 node.max_groups, limb_form)
                overflow[node.id] = r.overflow
                if node.step in ("SINGLE", "FINAL"):
                    return finalize_states(r.batch, nkeys, node.aggregates)
                return r.batch
            if isinstance(node, N.ExchangeNode):
                return lower(node.source)
            if isinstance(node, N.JoinNode):
                probe = lower(node.left)
                build = lower(node.right)
                cap = node.out_capacity or default_join_capacity
                r = hash_join(probe, build, node.left_keys, node.right_keys,
                              cap, node.join_type,
                              node.right_output_channels)
                overflow[node.id] = r.overflow
                return r.batch
            if isinstance(node, N.SemiJoinNode):
                src = lower(node.source)
                filt = lower(node.filtering_source)
                m, mnull = semi_join_mask(src, filt,
                                          _channels(node.source_key),
                                          _channels(node.filtering_key),
                                          node.null_keys_match)
                return Batch(src.columns + (Column(m, mnull, T.BOOLEAN),),
                             src.active)
            if isinstance(node, N.SortNode):
                return sort_batch(lower(node.source), node.keys)
            if isinstance(node, N.TopNNode):
                return top_n(lower(node.source), node.keys, node.count)
            if isinstance(node, N.LimitNode):
                return limit(lower(node.source), node.count)
            if isinstance(node, N.DistinctNode):
                src = lower(node.source)
                keys = node.key_channels
                if keys is None:
                    keys = range(src.num_columns)
                return distinct(src, keys)
            if isinstance(node, N.UnionNode):
                return concat_batches([lower(s) for s in node.inputs])
            if isinstance(node, N.SampleNode):
                return sample(lower(node.source), node.ratio)
            if isinstance(node, N.AssignUniqueIdNode):
                # one device and no mesh: the row slot is unique, with
                # no worker salt in the high bits
                src = lower(node.source)
                rid = torch.arange(src.capacity, dtype=torch.int64,
                                   device=src.active.device)
                return Batch(src.columns + (Column(
                    rid, torch.zeros_like(src.active), T.BIGINT),),
                    src.active)
            if isinstance(node, N.MarkDistinctNode):
                src = lower(node.source)
                m = mark_distinct(src, node.key_channels)
                return Batch(src.columns + (Column(
                    m, torch.zeros_like(m), T.BOOLEAN),), src.active)
            if isinstance(node, N.WindowNode):
                return window(lower(node.source), node.partition_channels,
                              node.order_keys, specs_of(node.functions))
            if isinstance(node, N.RowNumberNode):
                out = window(lower(node.source), node.partition_channels,
                             node.order_keys, [WindowSpec("row_number")])
                if node.max_rows_per_partition is not None:
                    rn = out.column(out.num_columns - 1)
                    out = out.with_active(
                        out.active & (rn.values <= node.max_rows_per_partition))
                return out
            if isinstance(node, N.UnnestNode):
                src = lower(node.source)
                cap = node.out_capacity or \
                    src.capacity * 4 * node.capacity_factor
                out, overflow[node.id] = unnest(
                    src, node.array_channel, cap, node.with_ordinality)
                return out
            if isinstance(node, N.GroupIdNode):
                return group_id(lower(node.source), node.grouping_sets,
                                node.key_channels)
            if isinstance(node, N.OutputNode):
                return lower(node.source)
            raise NotImplementedError(f"{type(node).__name__} is not ported "
                                      "yet (ROADMAP queue 1)")

        out = lower(root)
        dev = scan_batches[0].active.device
        flags = [overflow[i].reshape(()) for i in capacity_ids]
        # lower and lower_node refer to each other, so this frame's
        # dicts outlive the call until the cyclic collector runs: empty
        # them, or every staged batch stays on the device that long (a
        # stream of splits would hold several at once)
        inputs.clear()
        shared.clear()
        overflow.clear()
        return out, (torch.stack(flags) if flags else
                     torch.zeros(0, dtype=torch.bool, device=dev))

    return CompiledPlan(run, scans, root.output_types())
