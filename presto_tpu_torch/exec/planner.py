"""Plan -> executable lowering: the LocalExecutionPlanner analog.

Counterpart of presto_tpu/exec/planner.py::compile_plan for one device
and no mesh: the plan tree becomes one Python function over the staged
scan batches, calling the operators in turn. Join and aggregation
overflow (more matches than a join's out_capacity, more distinct keys
than max_groups) is returned as one device flag per capacity node; the
runner owns the rerun-bigger policy.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

import torch

from .. import types as T
from ..block import Batch, Column
from ..expr.compile import compile_filter, compile_projections
from ..ops.aggregation import finalize_states, group_by
from ..ops.join import hash_join, semi_join_mask
from ..ops.sort import sort_batch, top_n
from ..plan import nodes as N
from ..plan.stats import capacity_nodes

__all__ = ["compile_plan", "CompiledPlan"]


@dataclasses.dataclass
class CompiledPlan:
    """fn(scan_batches) -> (Batch, overflow flags); `scan_nodes` lists the
    TableScanNodes in the order their batches are supplied, and the
    flags are a bool vector, one per node of plan.stats.capacity_nodes
    of the plan, set where that node overflowed."""
    fn: Callable[[Sequence[Batch]], Tuple[Batch, torch.Tensor]]
    scan_nodes: List[N.TableScanNode]
    output_types: List[T.Type]


def _collect_scans(node: N.PlanNode, out: List[N.TableScanNode]):
    if isinstance(node, N.TableScanNode):
        out.append(node)
    for s in node.sources:
        _collect_scans(s, out)


def _check_supported(node: N.PlanNode) -> None:
    if isinstance(node, N.AggregationNode) and node.step != "SINGLE":
        raise NotImplementedError(
            f"{node.step} aggregation is not ported yet (ROADMAP queue 1 "
            "item 8: merge_partials for PARTIAL/FINAL)")
    if isinstance(node, N.JoinNode) and node.join_type != "inner":
        raise NotImplementedError(
            f"{node.join_type} joins are not ported yet (ROADMAP queue 1 "
            "item 5: outer joins)")
    for s in node.sources:
        _check_supported(s)


def _channels(key) -> List[int]:
    return key if isinstance(key, list) else [key]


def compile_plan(root: N.PlanNode, limb_form: str = "narrow",
                 default_join_capacity: int = 1 << 16) -> CompiledPlan:
    """Lower Scan/Filter/Project/Aggregation(SINGLE)/Join(inner)/
    SemiJoin/Sort/TopN/Output. A join without an out_capacity gets
    `default_join_capacity`; `limb_form` picks the stacked limb lanes of
    the small-table group-by sums (ops/aggregation.py)."""
    _check_supported(root)
    scans: List[N.TableScanNode] = []
    _collect_scans(root, scans)
    capacity_ids = [n.id for n in capacity_nodes(root)]

    def run(scan_batches: Sequence[Batch]):
        inputs = {n.id: b for n, b in zip(scans, scan_batches)}
        overflow = {}

        def flag(node: N.PlanNode, r) -> None:
            overflow[node.id] = overflow[node.id] | r.overflow \
                if node.id in overflow else r.overflow

        def lower(node: N.PlanNode) -> Batch:
            if isinstance(node, N.TableScanNode):
                return inputs[node.id]
            if isinstance(node, N.FilterNode):
                return compile_filter(node.predicate)(lower(node.source))
            if isinstance(node, N.ProjectNode):
                return compile_projections(node.expressions)(
                    lower(node.source))
            if isinstance(node, N.AggregationNode):
                r = group_by(lower(node.source), node.group_channels,
                             node.aggregates, node.max_groups, limb_form)
                flag(node, r)
                return finalize_states(r.batch, len(node.group_channels),
                                       node.aggregates)
            if isinstance(node, N.JoinNode):
                probe = lower(node.left)
                build = lower(node.right)
                cap = node.out_capacity or default_join_capacity
                r = hash_join(probe, build, node.left_keys, node.right_keys,
                              cap, node.join_type,
                              node.right_output_channels)
                flag(node, r)
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
            if isinstance(node, N.OutputNode):
                return lower(node.source)
            raise NotImplementedError(f"{type(node).__name__} is not ported "
                                      "yet (ROADMAP queue 1)")

        out = lower(root)
        dev = scan_batches[0].active.device
        flags = [overflow[i].reshape(()) for i in capacity_ids]
        return out, (torch.stack(flags) if flags else
                     torch.zeros(0, dtype=torch.bool, device=dev))

    return CompiledPlan(run, scans, root.output_types())
