"""Dynamic filtering: the join keys of small build sides prune the
probe side's scans before they are staged.

Counterpart of presto_tpu/exec/dynfilter.py (DynamicFilterSourceOperator
and LocalDynamicFilter of Presto). The runner first runs each small
dimension build side (a scan under filters and projections, estimated
at no more than `_MAX_BUILD_ROWS` rows) on the query's device, takes
each key's domain to the host (min, max, and the exact value set below
`_SET_LIMIT` distinct keys), and drops the probe scan's host rows
outside it before staging. Only joins that drop unmatched probe rows
(inner, right) qualify, and only a scan read by no other branch of the
plan DAG is pruned, so the rows are the same with filtering on or off;
what changes is the bytes staged on the device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..block import to_numpy
from ..expr import ir as E
from ..plan import nodes as N

__all__ = ["collect_dynamic_filters", "apply_dynamic_filters"]

# a build estimated above this many rows does not qualify: running it
# first would rival the scan it prunes
_MAX_BUILD_ROWS = 1 << 20
# an exact value set is kept below this many distinct keys; above it
# the min/max range still prunes
_SET_LIMIT = 1 << 16


def _strip_exchanges(node: N.PlanNode) -> N.PlanNode:
    while isinstance(node, N.ExchangeNode):
        node = node.source
    return node


def _is_dimension_subtree(node: N.PlanNode) -> bool:
    node = _strip_exchanges(node)
    if isinstance(node, N.TableScanNode):
        return True
    if isinstance(node, (N.FilterNode, N.ProjectNode)):
        return _is_dimension_subtree(node.source)
    return False


def _trace_to_scan(node: N.PlanNode, channel: int
                   ) -> Optional[Tuple[N.TableScanNode, int]]:
    """The scan node and its column index that an output channel
    passes through unchanged, or None. A SampleNode stops the trace:
    its Bernoulli choice hashes the staged row slot, which pruning
    before staging would move."""
    if isinstance(node, N.TableScanNode):
        if 0 <= channel < len(node.columns):
            return node, channel
        return None
    if isinstance(node, N.ProjectNode):
        e = node.expressions[channel] \
            if 0 <= channel < len(node.expressions) else None
        if isinstance(e, E.InputReference):
            return _trace_to_scan(node.source, e.channel)
        return None
    if isinstance(node, (N.FilterNode, N.ExchangeNode)):
        return _trace_to_scan(node.sources[0], channel)
    if isinstance(node, N.JoinNode):
        if channel < len(node.left.output_types()):
            return _trace_to_scan(node.left, channel)
        return None  # a filter on a build side prunes no fact rows
    if isinstance(node, N.SemiJoinNode):
        if channel < len(node.source.output_types()):
            return _trace_to_scan(node.source, channel)
        return None
    return None


def collect_dynamic_filters(root: N.PlanNode, sf: float, device=None
                            ) -> Dict[str, List[Tuple[int, tuple]]]:
    """Find the qualifying joins, run their build sides on `device`,
    and return {scan node id: [(scan column index, (lo, hi, values or
    None))]}."""
    from ..plan.stats import estimate_rows

    joins: List[N.JoinNode] = []
    seen: Dict[int, N.PlanNode] = {}
    # node -> the ids of its parents, once per edge: a join whose two
    # sides are one node reads it twice
    parent_ids: Dict[int, List[int]] = {}

    def walk(n: N.PlanNode):
        if id(n) in seen:
            return
        seen[id(n)] = n
        if isinstance(n, N.JoinNode):
            joins.append(n)
        for s in n.sources:
            parent_ids.setdefault(id(s), []).append(id(n))
            walk(s)

    walk(root)

    def single_consumer(scan: N.PlanNode, join: N.JoinNode) -> bool:
        """A pruned batch is keyed by scan id and read by every reader
        of the scan, so pruning is safe only when each node from the
        scan up to the join has one parent edge. (The reference counts
        parents, not edges, so it would prune a self-join over one
        node, build side included, by the build's own keys.)"""
        cur = scan
        while cur is not join:
            parents = parent_ids.get(id(cur), [])
            if len(parents) != 1:
                return False
            cur = seen[parents[0]]
        return True

    out: Dict[str, List[Tuple[int, tuple]]] = {}
    for j in joins:
        if j.join_type not in ("inner", "right"):
            continue
        build = _strip_exchanges(j.right)
        if not _is_dimension_subtree(build):
            continue
        est = estimate_rows(build, sf)
        if est is None or est > _MAX_BUILD_ROWS:
            continue
        targets = []
        for probe_ch, build_ch in zip(j.left_keys, j.right_keys):
            hit = _trace_to_scan(j.left, probe_ch)
            ty = build.output_types()[build_ch]
            if hit is None or not (ty.is_integral or ty.is_decimal
                                   or ty.base == "date"):
                continue
            if not single_consumer(hit[0], j):
                continue
            targets.append((hit, build_ch))
        if not targets:
            continue
        domains = _build_domains(build, sf, [bc for _, bc in targets],
                                 device)
        if domains is None:
            continue
        for ((scan, scan_col), _), dom in zip(targets, domains):
            out.setdefault(scan.id, []).append((scan_col, dom))
    return out


def _build_domains(build: N.PlanNode, sf: float, channels: List[int],
                   device) -> Optional[list]:
    """Run the dimension subtree on `device` and take the key domains
    to the host; None when the port cannot run the subtree (it then
    gives no filter). Any other error propagates."""
    from .planner import compile_plan
    from .runner import _scan_batch

    try:
        plan = compile_plan(build)
        batches = [_scan_batch(s, sf, device) for s in plan.scan_nodes]
        out, _flags = plan.fn(batches)
    except NotImplementedError:
        return None
    act = out.active.cpu().numpy()
    domains = []
    for ch in channels:
        vals, nulls = to_numpy(out.column(ch))
        v = vals[act & ~nulls]
        if v.dtype == object:  # long decimals: Python ints, compared
            v = np.array([int(x) for x in v], dtype=np.float64)
        if len(v) == 0:
            domains.append((0, -1, np.array([], dtype=np.int64)))
            continue
        uniq = np.unique(v)
        domains.append((v.min(), v.max(),
                        uniq if len(uniq) <= _SET_LIMIT else None))
    return domains


def apply_dynamic_filters(arrays: Dict[str, np.ndarray],
                          columns: List[str],
                          filters: List[Tuple[int, tuple]],
                          ) -> Tuple[np.ndarray, int]:
    """Row mask of one scan's host arrays under its domains: (keep,
    rows pruned)."""
    n = len(arrays[columns[0]])
    keep = np.ones(n, dtype=bool)
    for col_idx, (lo, hi, values) in filters:
        v = arrays[columns[col_idx]]
        if v.dtype == object:
            v = np.array([int(x) for x in v], dtype=np.float64)
        keep &= (v >= lo) & (v <= hi)
        if values is not None:
            keep &= np.isin(v, values)
    return keep, int(n - keep.sum())
