"""Query runner: staging, execution, result fetch.

Counterpart of presto_tpu/exec/runner.py (`QueryResult`, `run_query`,
the staging of `stage_scan_split`, the overflow->rerun ladder of
`_dispatch_ladder` with its per-plan capacity memo, `_batch_to_result`)
for one device. The observability ledgers of the reference (stats,
datapath, timeline, accuracy) are not part of this port yet.

`run_query` runs on CUDA unless the caller names another device, and
raises when there is no CUDA device; it never falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .. import types as T
from ..block import (Batch, batch_from_numpy, gather_block, resolve_device,
                     to_numpy)
from ..connectors import catalog
from ..plan import nodes as N
from ..plan.stats import capacity_nodes, scale_capacities
from ..plan.widths import annotate_widths, checked_physical_dtypes
from .planner import compile_plan

__all__ = ["run_query", "QueryResult", "resolve_device", "stage_scans",
           "execute", "capacity_plan"]

_PAD = 8  # staged capacities are a multiple of this


@dataclasses.dataclass
class QueryResult:
    columns: List[np.ndarray]
    nulls: List[np.ndarray]
    names: List[str]
    row_count: int
    types: List[T.Type] = dataclasses.field(default_factory=list)
    # "capacity_reruns" of the run's ladder and its "capacity_scale",
    # the largest capacity factor it gave a node
    stats: Dict[str, int] = dataclasses.field(default_factory=dict)

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


def _stage_values(node: N.ValuesNode, device) -> Batch:
    """A VALUES node's rows as one batch, as the reference's
    `_scan_batch` builds it: strings and long decimals as object
    columns, other values at their type's dtype with NULL as 0; a
    node without columns (a FROM-less SELECT) is its active rows
    alone."""
    n = len(node.rows)
    cap = max(-(-n // _PAD) * _PAD, _PAD)
    if not node.types:
        active = torch.zeros(cap, dtype=torch.bool, device=device)
        active[:n] = True
        return Batch((), active)
    arrays, nulls = [], []
    for ci, ty in enumerate(node.types):
        col = [r[ci] for r in node.rows]
        nulls.append(np.array([v is None for v in col], dtype=bool))
        if ty.is_string or (ty.is_decimal and not ty.is_short_decimal):
            a = np.empty(n, dtype=object)
            a[:] = col
        else:
            a = np.array([0 if v is None else v for v in col],
                         dtype=ty.to_dtype())
        arrays.append(a)
    return batch_from_numpy(node.types, arrays, nulls=nulls, capacity=cap,
                            device=device)


def stage_scans(root: N.PlanNode, sf: float, device) -> List[Batch]:
    """Staged batches of the plan's scans and VALUES, in compile_plan's
    order."""
    return [_stage_values(n, device) if isinstance(n, N.ValuesNode)
            else _stage_scan(n, sf, device)
            for n in compile_plan(root).scan_nodes]


# plan fingerprint -> the capacity factors (one per capacity node, in
# plan.stats.capacity_nodes order) that made it fit, so that a
# structurally identical plan starts at the known-good sizes instead of
# climbing the ladder again (the reference's _CAPACITY_FEEDBACK)
_CAPACITY_FEEDBACK: Dict[str, Tuple[int, ...]] = {}
_MAX_CAPACITY_SCALE = 1 << 10


def _fingerprint(root: N.PlanNode) -> str:
    """The plan's wire JSON with node ids left out."""
    def strip(v):
        if isinstance(v, dict):
            return {k: strip(x) for k, x in v.items() if k != "id"}
        if isinstance(v, list):
            return [strip(x) for x in v]
        return v
    return json.dumps(strip(N.to_json(root)), sort_keys=True)


def capacity_plan(root: N.PlanNode, default_join_capacity: int = 1 << 16
                  ) -> N.PlanNode:
    """The plan at the capacities the ladder last found to fit it (its
    own where it has not run): what `execute` runs once it has."""
    ids = [n.id for n in capacity_nodes(root)]
    factors = _CAPACITY_FEEDBACK.get(_fingerprint(root), (1,) * len(ids))
    return scale_capacities(root, dict(zip(ids, factors)),
                            default_join_capacity)


def _joins_above(root: N.PlanNode, ids: List[str]) -> Dict[str, set]:
    """capacity node id -> positions in `ids` of the joins above it."""
    pos = {i: k for k, i in enumerate(ids)}
    out: Dict[str, set] = {}

    def walk(n: N.PlanNode, above: Tuple[int, ...]):
        out.setdefault(n.id, set()).update(above)
        if isinstance(n, N.JoinNode):
            above += (pos[n.id],)
        for s in n.sources:
            walk(s, above)

    walk(root, ())
    return out


def _dispatch_ladder(root: N.PlanNode, batches: Sequence[Batch],
                     limb_form: str, default_join_capacity: int
                     ) -> Tuple[Batch, int, int]:
    """Run the plan; when a join or group table overflows, rerun with
    its capacity 4x larger (scale_capacities; a join without an
    out_capacity starts at `default_join_capacity`), up to 1024x, and
    with the capacity of every join above it 4x larger too, since their
    input was cut short. The reference raises every capacity of the
    plan at once; an aggregation here grows only when it overflows
    itself, so a join's overflow leaves a small aggregation on its
    small-table path. Returns (output, largest capacity factor,
    reruns)."""
    fp = _fingerprint(root)
    ids = [n.id for n in capacity_nodes(root)]
    above = _joins_above(root, ids)
    factors = list(_CAPACITY_FEEDBACK.get(fp, (1,) * len(ids)))
    reruns = 0
    while True:
        plan = compile_plan(
            scale_capacities(root, dict(zip(ids, factors)),
                             default_join_capacity), limb_form)
        out, flags = plan.fn(batches)
        over = [k for k, o in enumerate(flags.tolist()) if o]
        if not over:
            if any(k > 1 for k in factors):
                _CAPACITY_FEEDBACK[fp] = tuple(factors)
            return out, max(factors, default=1), reruns
        if any(factors[k] >= _MAX_CAPACITY_SCALE for k in over):
            raise RuntimeError(
                "plan execution overflowed a static bucket (join/group "
                "capacity) beyond the adaptive rerun ceiling; rerun with "
                "larger capacity hints (max_groups / join capacity)")
        for k in set(over).union(*(above[ids[k]] for k in over)):
            factors[k] = min(factors[k] * 4, _MAX_CAPACITY_SCALE)
        reruns += 1


def execute(root: N.PlanNode, batches: Sequence[Batch],
            limb_form: str = "narrow",
            default_join_capacity: int = 1 << 16) -> Batch:
    """Run the plan over staged batches through the overflow ladder."""
    return _dispatch_ladder(root, batches, limb_form,
                            default_join_capacity)[0]


def run_query(root: N.PlanNode, sf: float = 0.01, device=None,
              limb_form: str = "narrow", mesh=None,
              default_join_capacity: int = 1 << 16) -> QueryResult:
    """Plan -> rows, end to end: narrow-width annotation, staging of
    the generated tables on `device` (CUDA unless asked otherwise),
    execution through the overflow ladder, result fetch. A join node
    without an out_capacity starts at `default_join_capacity` rows."""
    if mesh is not None:
        raise NotImplementedError("a mesh is not ported yet (ROADMAP queue 1 "
                                  "item 14: parallel/ and the worker tier)")
    dev = resolve_device(device)
    root = annotate_widths(root, sf)
    out, scale, reruns = _dispatch_ladder(
        root, stage_scans(root, sf, dev), limb_form, default_join_capacity)
    res = _batch_to_result(out, root)
    res.stats = {"capacity_reruns": reruns, "capacity_scale": scale}
    return res


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
