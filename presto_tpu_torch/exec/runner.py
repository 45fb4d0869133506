"""Query runner: staging, execution, result fetch.

Counterpart of presto_tpu/exec/runner.py (`QueryResult`, `run_query`,
the staging of `stage_scan_split`, the overflow->rerun ladder of
`_dispatch_ladder`, `_batch_to_result`) for one device. The
observability ledgers of the reference (stats, datapath, timeline,
accuracy) are not part of this port yet.

`run_query` runs on CUDA unless the caller names another device, and
raises when there is no CUDA device; it never falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import types as T
from ..block import (Batch, batch_from_numpy, gather_block, resolve_device,
                     to_numpy)
from ..connectors import catalog
from ..ops.aggregation import SMALL_G
from ..plan import nodes as N
from ..plan.widths import annotate_widths, checked_physical_dtypes
from .planner import compile_plan

__all__ = ["run_query", "QueryResult", "resolve_device", "stage_scans",
           "execute"]

_PAD = 8  # staged capacities are a multiple of this


@dataclasses.dataclass
class QueryResult:
    columns: List[np.ndarray]
    nulls: List[np.ndarray]
    names: List[str]
    row_count: int
    types: List[T.Type] = dataclasses.field(default_factory=list)

    def rows(self) -> List[tuple]:
        return [tuple(None if self.nulls[c][i] else self.columns[c][i]
                      for c in range(len(self.columns)))
                for i in range(self.row_count)]

    def canonical_rows(self, digits: int = 6) -> List[tuple]:
        """Order-independent, stringified rows for oracle comparison
        (floats rounded so summation order cannot flip a digit)."""
        out = []
        for i in range(self.row_count):
            row = []
            for c in range(len(self.columns)):
                v = None if self.nulls[c][i] else self.columns[c][i]
                if isinstance(v, (float, np.floating)):
                    v = round(float(v), digits)
                row.append(str(v))
            out.append(tuple(row))
        return sorted(out)


def _stage_scan(node: N.TableScanNode, sf: float, device) -> Batch:
    """Generate one scan's host columns and stage them at the node's
    narrow lanes, each re-proved against the actual values."""
    conn = catalog(node.connector)
    rows = conn.table_row_count(node.table, sf)
    data = conn.generate_columns(node.table, sf, node.columns)
    arrays = [data[c] for c in node.columns]
    phys = node.physical_dtypes
    if phys:
        phys = checked_physical_dtypes(phys, node.column_types, arrays)
    cap = max(-(-rows // _PAD) * _PAD, _PAD)
    return batch_from_numpy(node.column_types, arrays, capacity=cap,
                            physical_dtypes=phys, device=device)


def stage_scans(root: N.PlanNode, sf: float, device) -> List[Batch]:
    """Staged batches of the plan's scans, in compile_plan's order."""
    return [_stage_scan(n, sf, device)
            for n in compile_plan(root).scan_nodes]


def _grow_groups(root: N.PlanNode) -> Optional[N.PlanNode]:
    """The plan with every keyed aggregation's max_groups doubled (capped
    at the small-table limit); None when all are at the limit."""
    grown = False

    def walk(node: N.PlanNode) -> N.PlanNode:
        nonlocal grown
        changes = {f.name: walk(getattr(node, f.name))
                   for f in dataclasses.fields(node)
                   if isinstance(getattr(node, f.name), N.PlanNode)}
        if isinstance(node, N.AggregationNode) and node.group_channels \
                and node.max_groups < SMALL_G:
            changes["max_groups"] = min(2 * node.max_groups, SMALL_G)
            grown = True
        return dataclasses.replace(node, **changes) if changes else node

    new = walk(root)
    return new if grown else None


def execute(root: N.PlanNode, batches: Sequence[Batch],
            limb_form: str = "narrow") -> Batch:
    """Run the plan over staged batches. When a group table overflows,
    rerun with max_groups doubled, up to 64, then raise."""
    while True:
        out, overflow = compile_plan(root, limb_form).fn(batches)
        if not bool(overflow):
            return out
        grown = _grow_groups(root)
        if grown is None:
            raise RuntimeError(
                f"more than {SMALL_G} groups: the large-G aggregation is not "
                "ported yet (ROADMAP queue 1 item 9)")
        root = grown


def run_query(root: N.PlanNode, sf: float = 0.01, device=None,
              limb_form: str = "narrow", mesh=None) -> QueryResult:
    """Plan -> rows, end to end: narrow-width annotation, staging of
    the generated tables on `device` (CUDA unless asked otherwise),
    execution, result fetch."""
    if mesh is not None:
        raise NotImplementedError("a mesh is not ported yet (ROADMAP queue 1 "
                                  "item 12: parallel/ and the worker tier)")
    dev = resolve_device(device)
    root = annotate_widths(root, sf)
    out = execute(root, stage_scans(root, sf, dev), limb_form)
    return _batch_to_result(out, root)


def _batch_to_result(out: Batch, root: N.PlanNode) -> QueryResult:
    idx = torch.nonzero(out.active).flatten()
    cols, nulls, types = [], [], []
    for c in range(out.num_columns):
        block = out.column(c)
        v, n = to_numpy(gather_block(block, idx))
        if v.dtype != object and v.dtype.kind in "iu" and \
                block.type.is_fixed_width:
            # narrow lanes widen back to the logical dtype
            ld = np.dtype(block.type.to_dtype())
            if ld.kind in "iu" and v.dtype != ld:
                v = v.astype(ld)
        cols.append(v)
        nulls.append(n)
        types.append(block.type)
    names = root.names if isinstance(root, N.OutputNode) else \
        [f"col{i}" for i in range(out.num_columns)]
    return QueryResult(cols, nulls, names, len(idx), types=types)
