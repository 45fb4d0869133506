"""Plan -> executable lowering: the LocalExecutionPlanner analog.

Counterpart of presto_tpu/exec/planner.py::compile_plan for one device
and no mesh: the plan tree becomes one Python function over the staged
scan batches, calling the operators in turn. Aggregation overflow
(more distinct keys than max_groups) is returned as a device flag; the
runner owns the rerun-bigger policy.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

import torch

from .. import types as T
from ..block import Batch
from ..expr.compile import compile_filter, compile_projections
from ..ops.aggregation import SMALL_G, finalize_states, group_by
from ..ops.sort import sort_batch
from ..plan import nodes as N

__all__ = ["compile_plan", "CompiledPlan"]


@dataclasses.dataclass
class CompiledPlan:
    """fn(scan_batches) -> (Batch, overflow flag); `scan_nodes` lists the
    TableScanNodes in the order their batches are supplied."""
    fn: Callable[[Sequence[Batch]], Tuple[Batch, torch.Tensor]]
    scan_nodes: List[N.TableScanNode]
    output_types: List[T.Type]


def _collect_scans(node: N.PlanNode, out: List[N.TableScanNode]):
    if isinstance(node, N.TableScanNode):
        out.append(node)
    for s in node.sources:
        _collect_scans(s, out)


def _check_supported(node: N.PlanNode) -> None:
    if isinstance(node, N.AggregationNode):
        if node.step != "SINGLE":
            raise NotImplementedError(
                f"{node.step} aggregation is not ported yet (ROADMAP queue 1 "
                "item 9: merge_partials for PARTIAL/FINAL)")
        if node.group_channels and node.max_groups > SMALL_G:
            raise NotImplementedError(
                f"max_groups {node.max_groups} > {SMALL_G} needs the "
                "large-G aggregation (ROADMAP queue 1 item 9)")
    for s in node.sources:
        _check_supported(s)


def compile_plan(root: N.PlanNode, limb_form: str = "narrow") -> CompiledPlan:
    """Lower Scan/Filter/Project/Aggregation(SINGLE)/Sort/Output.
    `limb_form` picks the stacked limb lanes of the group-by sums
    (ops/aggregation.py)."""
    _check_supported(root)
    scans: List[N.TableScanNode] = []
    _collect_scans(root, scans)

    def run(scan_batches: Sequence[Batch]):
        inputs = {n.id: b for n, b in zip(scans, scan_batches)}
        overflow = torch.zeros((), dtype=torch.bool,
                               device=scan_batches[0].active.device)

        def lower(node: N.PlanNode) -> Batch:
            nonlocal overflow
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
                overflow = overflow | r.overflow
                return finalize_states(r.batch, len(node.group_channels),
                                       node.aggregates)
            if isinstance(node, N.SortNode):
                return sort_batch(lower(node.source), node.keys)
            if isinstance(node, N.OutputNode):
                return lower(node.source)
            raise NotImplementedError(f"{type(node).__name__} is not ported "
                                      "yet (ROADMAP queue 1)")

        out = lower(root)
        return out, overflow

    return CompiledPlan(run, scans, root.output_types())
