"""Split streaming: a scan read in bounded splits feeding a running
aggregation.

Counterpart of presto_tpu/exec/streaming.py (the split-driven Driver
loop of Presto's SqlTaskExecution, and grouped execution by bucket).
Each split stages from pinned host buffers with copies that do not
wait, runs the scan's filter/project pipeline and a PARTIAL group-by
on the device, and merges into the running state table
(`merge_partials` over the two tables), so the device holds one split
and two state tables whatever the table's size. The overflow flag
stays on the device across the splits and is read once per bucket, so
the host can generate split k + 1 while the device works on split k
(as far as the operators themselves do not wait for the device).

With n_buckets > 1, one run is one lifespan of grouped execution: only
rows whose key hash (parallel/exchange.py, the reference's bit for bit)
falls in the bucket are aggregated, trading scan passes for a state
table of about 1/n_buckets of the groups.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..block import Batch, concat_batches, pinned_staging, to_numpy
from ..connectors import catalog
from ..expr import ir as E
from ..ops.aggregation import GroupByResult, group_by, merge_partials
from ..parallel.exchange import bucket_of, row_hash
from ..plan import nodes as N
from .planner import compile_plan
from .runner import stage_scan_split

__all__ = ["streamable_agg_shape", "run_streaming_agg", "run_grouped_agg",
           "run_spilled_sort"]


def streamable_agg_shape(root: N.PlanNode
                         ) -> Optional[Tuple[N.AggregationNode,
                                             N.TableScanNode]]:
    """(aggregation, scan) of Output?(identity projections?(SINGLE
    Aggregation(linear filter/project pipeline(Scan)))), the shape
    streaming runs; None for any other plan. count_distinct and
    approx_percentile keep value-order states that do not merge across
    splits."""
    node = root.source if isinstance(root, N.OutputNode) else root
    while isinstance(node, N.ProjectNode) and \
            len(node.expressions) == len(node.source.output_types()) and \
            all(isinstance(e, E.InputReference) and e.channel == i
                for i, e in enumerate(node.expressions)):
        node = node.source
    if not isinstance(node, N.AggregationNode) or node.step != "SINGLE":
        return None
    if any(a.canonical in ("count_distinct", "approx_percentile")
           for a in node.aggregates):
        return None
    cur = node.source
    while isinstance(cur, (N.FilterNode, N.ProjectNode)):
        cur = cur.source
    if isinstance(cur, N.TableScanNode):
        return node, cur
    return None


def _split_starts(total: int, split_rows: int) -> List[int]:
    # an empty table is one empty split, which still gives a
    # well-formed (empty) state table
    return list(range(0, total, split_rows)) or [0]


def _make_agg_executor(root: N.PlanNode, sf: float, split_rows: int,
                       n_buckets: int, device, limb_form: str = "narrow",
                       stats: Optional[Dict] = None):
    """The per-split and merge steps of the plan's aggregation; the
    returned function runs one bucket's lifespan over every split.
    `stats` gets "splits", "split_stage_s" (host time generating and
    enqueueing the splits) and, on CUDA, "split_device_s" (the device
    timeline from each split's first operator to its merge's last,
    read after the bucket's one synchronization)."""
    shape = streamable_agg_shape(root)
    if shape is None:
        raise ValueError("plan is not a streamable aggregation")
    agg, scan = shape
    pipeline = compile_plan(agg.source, limb_form)
    nkeys = len(agg.group_channels)

    def split_step(batch: Batch, bucket: int):
        b, flags = pipeline.fn((batch,))
        if n_buckets > 1:
            h = row_hash([b.column(c) for c in agg.group_channels])
            b = b.with_active(b.active & (bucket_of(h, n_buckets) == bucket))
        r = group_by(b, agg.group_channels, agg.aggregates, agg.max_groups,
                     limb_form)
        return r.batch, r.overflow | flags.any()

    def merge_step(running: Batch, part: Batch):
        r = merge_partials(concat_batches([running, part]), nkeys,
                           agg.aggregates, agg.max_groups, limb_form)
        return r.batch, r.overflow

    conn = catalog(scan.connector)
    total = conn.table_row_count(scan.table, sf)
    starts = _split_starts(total, split_rows)
    timed = stats is not None and torch.device(device).type == "cuda"

    def run(bucket: int) -> GroupByResult:
        running: Optional[Batch] = None
        overflow = torch.zeros((), dtype=torch.bool, device=device)
        events = []
        for start in starts:
            count = min(split_rows, max(total - start, 0))
            t0 = time.perf_counter()
            with pinned_staging():
                batch = stage_scan_split(conn, scan, sf, start, count,
                                         split_rows, device)
            if stats is not None:
                stats["splits"] = stats.get("splits", 0) + 1
                stats["split_stage_s"] = stats.get("split_stage_s", 0.0) \
                    + time.perf_counter() - t0
            if timed:
                events.append([torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True)])
                events[-1][0].record()
            part, ovf = split_step(batch, bucket)
            del batch  # before the next split stages: one on the device
            overflow = overflow | ovf
            if running is None:
                running = part
            else:
                running, ovf = merge_step(running, part)
                overflow = overflow | ovf
            if timed:
                events[-1][1].record()
        if timed:
            torch.cuda.synchronize(device)
            stats["split_device_s"] = stats.get("split_device_s", 0.0) + \
                sum(a.elapsed_time(b) for a, b in events) / 1e3
        return GroupByResult(running, running.active.sum(), overflow)

    return run


def run_streaming_agg(root: N.PlanNode, sf: float, split_rows: int,
                      device, n_buckets: int = 1, bucket: int = 0,
                      limb_form: str = "narrow",
                      stats: Optional[Dict] = None) -> GroupByResult:
    """Run a streamable aggregation split by split on `device`: its
    state table (not finalized) and the overflow flag. With n_buckets
    > 1, only the groups whose key hash falls in `bucket`."""
    return _make_agg_executor(root, sf, split_rows, n_buckets, device,
                              limb_form, stats)(bucket)


def run_grouped_agg(root: N.PlanNode, sf: float, split_rows: int,
                    n_buckets: int, device, limb_form: str = "narrow"
                    ) -> List[GroupByResult]:
    """Grouped execution: every bucket's lifespan in turn. The buckets'
    groups are disjoint, so their tables together are the result."""
    runner = _make_agg_executor(root, sf, split_rows, n_buckets, device,
                                limb_form)
    return [runner(b) for b in range(n_buckets)]


def run_spilled_sort(root: N.PlanNode, sf: float, split_rows: int, device):
    """External sort of Output?(Sort(linear pipeline(Scan))): each split
    runs the pipeline on the device and its live rows move to host
    memory as a run; the runs are combined by one lexsort on the host
    with ties kept (equal values share a key, so later sort keys break
    them). Returns (columns, nulls, names) as host arrays."""
    node = root.source if isinstance(root, N.OutputNode) else root
    if not isinstance(node, N.SortNode):
        raise ValueError("run_spilled_sort needs a Sort root")
    cur = node.source
    while isinstance(cur, (N.FilterNode, N.ProjectNode)):
        cur = cur.source
    if not isinstance(cur, N.TableScanNode):
        raise ValueError("a spilled sort streams one scan")
    scan = cur
    # the pipeline alone: the host's lexsort orders everything, so a
    # sort of each run on the device would be wasted work
    pipeline = compile_plan(node.source)
    conn = catalog(scan.connector)
    total = conn.table_row_count(scan.table, sf)
    runs: List[List[np.ndarray]] = []
    run_nulls: List[List[np.ndarray]] = []
    for start in range(0, max(total, 1), split_rows):
        count = min(split_rows, max(total - start, 0))
        with pinned_staging():
            batch = stage_scan_split(conn, scan, sf, start, count,
                                     split_rows, device)
        out, _ = pipeline.fn((batch,))
        sel = np.nonzero(out.active.cpu().numpy())[0]
        cols, nulls = [], []
        for c in range(out.num_columns):
            v, n = to_numpy(out.column(c))  # the run leaves the device
            cols.append(v[sel])
            nulls.append(n[sel])
        runs.append(cols)
        run_nulls.append(nulls)

    ncols = len(runs[0])
    merged = [np.concatenate([r[c] for r in runs]) for c in range(ncols)]
    merged_nulls = [np.concatenate([r[c] for r in run_nulls])
                    for c in range(ncols)]
    sort_cols = []
    for ch, desc, nulls_last in reversed(node.keys):
        vals = merged[ch]
        if vals.dtype == object:
            _, key = np.unique(np.array([str(x) for x in vals]),
                               return_inverse=True)
            key = key.astype(np.float64)
        elif np.issubdtype(vals.dtype, np.integer):
            # longdouble's 64-bit mantissa keeps int64 keys exact and
            # still has room for the +/-inf NULL sentinels
            key = vals.astype(np.longdouble)
        else:
            key = vals.astype(np.float64)
        if desc:
            key = -key
        key = np.where(merged_nulls[ch], np.inf if nulls_last else -np.inf,
                       key)
        sort_cols.append(key)
    perm = np.lexsort(sort_cols) if sort_cols else \
        np.arange(len(merged[0]))
    names = root.names if isinstance(root, N.OutputNode) else \
        [f"col{i}" for i in range(ncols)]
    return ([c[perm] for c in merged], [c[perm] for c in merged_nulls],
            names)
