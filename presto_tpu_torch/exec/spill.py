"""Spilled aggregation and join: host-memory offload when the state
exceeds a device budget.

Counterpart of presto_tpu/exec/spill.py (Presto's
SpillableHashAggregationBuilder, HashBuilderOperator's spill states and
GenericPartitioningSpiller). The unit of spilling is a bucket of
grouped execution: rows partition by the hash of their aggregation or
join keys (parallel/exchange.py) into B buckets whose states are
disjoint, the device works on one bucket at a time, and each finished
bucket's live rows move to host memory as numpy arrays (and, past a
threshold, to .npz run files on disk). Buckets never interleave, so
nothing spilled is ever merged again: the runs concatenate.

B is sized from the budget: B = ceil(2 * planned state bytes / budget)
for an aggregation (two tables coexist during the running merge), and
ceil(3 * input bytes / budget) for a join. The counters go to the
caller's stats under the reference's names: spill_buckets,
spilled_bytes (the live rows' bytes moved to the host),
spilled_to_disk_bytes and spill_run_files.
"""

from __future__ import annotations

import dataclasses
import math
import os
import uuid
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import failpoints
from .. import types as T
from ..block import Batch, batch_from_numpy, pinned_staging, to_numpy
from ..connectors import catalog
from ..ops.aggregation import finalize_states
from ..ops.join import hash_join
from ..parallel.exchange import bucket_of, row_hash
from ..plan import nodes as N
from .planner import compile_plan
from .runner import stage_scan_split
from .streaming import _make_agg_executor, streamable_agg_shape

__all__ = ["plan_state_bytes", "plan_join_bytes", "run_spilled_agg",
           "run_spilled_join", "spill_bucket_count"]


def _add(stats: Optional[Dict], name: str, value) -> None:
    if stats is not None:
        stats[name] = stats.get(name, 0) + value


def _type_bytes(ty: T.Type) -> int:
    """Planned device bytes per row of one column (value and NULL)."""
    if ty.is_string:
        return 64 + 4 + 1  # a typical chars row, the length, the NULL
    if ty.is_decimal and not ty.is_short_decimal:
        return 16 + 1
    if ty.base in ("array", "map", "row"):
        return 17  # nested: counted wide
    return np.dtype(ty.to_dtype()).itemsize + 1


def plan_state_bytes(agg: N.AggregationNode) -> int:
    """Planned footprint of the aggregation's dense state table."""
    return agg.max_groups * sum(_type_bytes(t) for t in agg.output_types())


def plan_join_bytes(join: N.JoinNode, sf: float) -> int:
    """Planned footprint of a spilled join's two inputs: each side's
    scan rows times its output row's bytes."""
    return sum(catalog(scan.connector).table_row_count(scan.table, sf)
               * sum(_type_bytes(t) for t in node.output_types())
               for node, scan in ((n, _linear_scan(n))
                                  for n in (join.left, join.right)))


def spill_bucket_count(state_bytes: int, hbm_budget_bytes: int) -> int:
    """Buckets needed for two bucket tables to fit the budget."""
    return max(1, math.ceil(2 * state_bytes / max(hbm_budget_bytes, 1)))


class _HostRows:
    """Live rows in host memory as numpy arrays, the first spill tier.
    With a `disk_dir`, chunks past `disk_threshold_bytes` flush to .npz
    run files, which `columns` reads back in order; `close` deletes
    them."""

    def __init__(self, types: List[T.Type], disk_dir: Optional[str] = None,
                 disk_threshold_bytes: int = 256 << 20):
        self.types = types
        self._cols: List[List[np.ndarray]] = [[] for _ in types]
        self._nulls: List[List[np.ndarray]] = [[] for _ in types]
        self.rows = 0
        self._mem_bytes = 0
        self.disk_dir = disk_dir
        self.disk_threshold = disk_threshold_bytes
        self._runs: List[str] = []

    def append(self, batch: Batch, stats: Optional[Dict]):
        """Move the batch's active rows to the host."""
        cols = [to_numpy(c) for c in batch.columns]
        self.append_rows([v for v, _ in cols], [n for _, n in cols],
                         np.nonzero(batch.active.cpu().numpy())[0], stats)

    def append_rows(self, cols: List[np.ndarray], nulls: List[np.ndarray],
                    sel: np.ndarray, stats: Optional[Dict]):
        """Keep rows `sel` of host columns already fetched."""
        self.rows += len(sel)
        moved = 0
        for c in range(len(self.types)):
            v, nl = cols[c][sel], nulls[c][sel]
            self._cols[c].append(v)
            self._nulls[c].append(nl)
            moved += (v.nbytes if v.dtype != object else 32 * len(v)) \
                + nl.nbytes
        self._mem_bytes += moved
        _add(stats, "spilled_bytes", moved)
        if self.disk_dir is not None and \
                self._mem_bytes >= self.disk_threshold:
            self._flush_run(stats)

    def _flush_run(self, stats: Optional[Dict]):
        if self.rows == 0 or not self._cols[0]:
            return
        if failpoints.ARMED:
            # a full or broken spill disk at run-flush time
            failpoints.hit("spill.write")
        os.makedirs(self.disk_dir, exist_ok=True)
        path = os.path.join(self.disk_dir,
                            f"spill_{uuid.uuid4().hex[:12]}.npz")
        payload = {}
        for c in range(len(self.types)):
            payload[f"v{c}"] = np.concatenate(self._cols[c]) \
                if self._cols[c] else np.array([], dtype=object)
            payload[f"n{c}"] = np.concatenate(self._nulls[c]) \
                if self._nulls[c] else np.array([], dtype=bool)
            self._cols[c] = []
            self._nulls[c] = []
        np.savez(path, **payload)
        self._runs.append(path)
        self._mem_bytes = 0
        _add(stats, "spilled_to_disk_bytes", os.path.getsize(path))
        _add(stats, "spill_run_files", 1)

    def columns(self) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        cols_runs: List[List[np.ndarray]] = [[] for _ in self.types]
        nulls_runs: List[List[np.ndarray]] = [[] for _ in self.types]
        if failpoints.ARMED and self._runs:
            # a run file that vanished or rotted between write and read
            failpoints.hit("spill.read")
        for path in self._runs:
            with np.load(path, allow_pickle=True) as z:
                for c in range(len(self.types)):
                    cols_runs[c].append(z[f"v{c}"])
                    nulls_runs[c].append(z[f"n{c}"])
        for c in range(len(self.types)):
            cols_runs[c].extend(self._cols[c])
            nulls_runs[c].extend(self._nulls[c])
        cols = [np.concatenate(c) if c else np.array([], dtype=object)
                for c in cols_runs]
        nulls = [np.concatenate(n) if n else np.array([], dtype=bool)
                 for n in nulls_runs]
        return cols, nulls

    def close(self):
        for path in self._runs:
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
        self._runs = []

    def to_batch(self, device, capacity: Optional[int] = None) -> Batch:
        """The rows staged as one padded Batch on `device`."""
        cols, nulls = self.columns()
        cap = capacity or max(8, -(-self.rows // 8) * 8)
        with pinned_staging():
            return batch_from_numpy(self.types, cols, nulls=nulls,
                                    capacity=cap, device=device)


def run_spilled_agg(root: N.PlanNode, sf: float, split_rows: int,
                    hbm_budget_bytes: int, device,
                    stats: Optional[Dict] = None,
                    spill_dir: Optional[str] = None,
                    spill_file_threshold: int = 256 << 20,
                    limb_form: str = "narrow") -> Batch:
    """A streamable aggregation whose state table exceeds the budget,
    run bucket by bucket: each bucket streams every split, and its
    finalized live rows move to the host before the next bucket
    starts. Returns the result as one Batch on the CPU."""
    shape = streamable_agg_shape(root)
    if shape is None:
        raise ValueError("plan is not a streamable aggregation")
    agg, _scan = shape
    n_buckets = spill_bucket_count(plan_state_bytes(agg), hbm_budget_bytes)
    # groups hash about evenly into buckets; 2x slack absorbs skew, and
    # the overflow flag still guards the result
    bucket_groups = max(64, -(-2 * agg.max_groups // n_buckets))
    agg_b = dataclasses.replace(agg, max_groups=bucket_groups)
    runner = _make_agg_executor(_rebuild_above(root, agg, agg_b), sf,
                                split_rows, n_buckets, device, limb_form)
    nkeys = len(agg.group_channels)
    staged: Optional[_HostRows] = None
    try:
        for b in range(n_buckets):
            r = runner(b)
            if bool(r.overflow):
                raise RuntimeError(
                    f"spilled aggregation bucket {b} overflowed its "
                    f"{bucket_groups}-group table; raise max_groups")
            out = finalize_states(r.batch, nkeys, agg.aggregates)
            if staged is None:
                staged = _HostRows(
                    [c.type for c in out.columns], disk_dir=spill_dir,
                    disk_threshold_bytes=spill_file_threshold)
            staged.append(out, stats)
            _add(stats, "spill_buckets", 1)
        return staged.to_batch("cpu")
    finally:
        # run files never outlive the query, whether it ends or fails
        if staged is not None:
            staged.close()


def _rebuild_above(root: N.PlanNode, old: N.PlanNode,
                   new: N.PlanNode) -> N.PlanNode:
    """Replace `old` (by identity) with `new` in a linear chain."""
    if root is old:
        return new
    if len(root.sources) != 1:
        raise ValueError("expected a linear chain")
    return dataclasses.replace(root,
                               source=_rebuild_above(root.source, old, new))


def _linear_scan(node: N.PlanNode) -> N.TableScanNode:
    cur = node
    while isinstance(cur, (N.FilterNode, N.ProjectNode)):
        cur = cur.source
    if not isinstance(cur, N.TableScanNode):
        raise ValueError("a spilled join streams scan-rooted pipelines")
    return cur


def run_spilled_join(join: N.JoinNode, sf: float, split_rows: int,
                     hbm_budget_bytes: int, device,
                     stats: Optional[Dict] = None,
                     out_capacity_per_bucket: Optional[int] = None
                     ) -> Batch:
    """Join two scan-rooted pipelines under a device budget:

    1. stream both sides split by split; each split's live rows move to
       the host once and partition there by the hash of their join keys
       into per-bucket host rows (every row leaves the device before
       the join runs);
    2. per bucket, stage that bucket's two sides, join them on the
       device, and move the result's live rows to the host.

    Returns the result as one Batch on the CPU."""
    sides = []
    for node, keys in ((join.left, join.left_keys),
                       (join.right, join.right_keys)):
        scan = _linear_scan(node)
        conn = catalog(scan.connector)
        sides.append((node, keys, scan, compile_plan(node), conn,
                      conn.table_row_count(scan.table, sf)))
    n_buckets = max(1, math.ceil(3 * plan_join_bytes(join, sf)
                                 / max(hbm_budget_bytes, 1)))

    host_buckets: List[List[_HostRows]] = []
    for node, keys, scan, pipeline, conn, total in sides:
        buckets = [_HostRows(node.output_types()) for _ in range(n_buckets)]
        host_buckets.append(buckets)
        for start in range(0, max(total, 1), split_rows):
            count = min(split_rows, max(total - start, 0))
            with pinned_staging():
                batch = stage_scan_split(conn, scan, sf, start, count,
                                         split_rows, device)
            out, _ = pipeline.fn((batch,))
            bid = bucket_of(row_hash([out.column(c) for c in keys]),
                            n_buckets)
            fetched = [to_numpy(c) for c in out.columns]
            cols = [v for v, _ in fetched]
            nulls = [n for _, n in fetched]
            act = out.active.cpu().numpy()
            bid = bid.cpu().numpy()
            for b in range(n_buckets):
                buckets[b].append_rows(cols, nulls,
                                       np.nonzero(act & (bid == b))[0],
                                       stats)
        _add(stats, "spill_buckets", n_buckets)

    result: Optional[_HostRows] = None
    for b in range(n_buckets):
        probe = host_buckets[0][b].to_batch(device)
        build = host_buckets[1][b].to_batch(device)
        cap = out_capacity_per_bucket or \
            4 * max(probe.capacity, build.capacity)
        r = hash_join(probe, build, join.left_keys, join.right_keys, cap,
                      join.join_type, join.right_output_channels)
        if bool(r.overflow):
            raise RuntimeError(
                f"spilled join bucket {b} overflowed out_capacity {cap}; "
                "raise out_capacity_per_bucket")
        if result is None:
            result = _HostRows([c.type for c in r.batch.columns])
        result.append(r.batch, stats)
        _add(stats, "spill_buckets", 1)
    return result.to_batch("cpu")
