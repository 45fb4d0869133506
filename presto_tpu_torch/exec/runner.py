"""Query runner: plan preparation, staging, execution, result fetch.

Counterpart of presto_tpu/exec/runner.py (`prepare_plan`, `QueryResult`,
`run_query` with its dynamic filtering, memory-pool admission and split
branch, `stage_scan_split`, the overflow->rerun ladder of
`_dispatch_ladder` with its per-plan capacity memo and, on a mesh, its
exchange-slot reruns, the write roots of `_run_write_root`,
`_batch_to_result`) on one device or a mesh of workers
(parallel/mesh.py), with the access-control check of
server/access.py on every plan and write root before anything is
staged. Every run keeps the reference's observability ledgers: a
live-progress entry (exec/progress.py), the datapath hops
(exec/datapath.py), the timeline (exec/timeline.py), the
estimate-vs-actual records (exec/accuracy.py), the structured
QueryStats with its stages staging, compile, execute, exchange and
fetch (exec/stats.py, on `QueryResult.query_stats`), the per-plan
profile (exec/profiler.py), one span per stage (server/tracing.py)
and the stage histograms (server/metrics.py). None of them adds a
host-device synchronization: each dispatch's span on the device
(stream time, host enqueue waits included) is a CUDA event pair read
after the run's fetch (datapath.device_hop).
A plan fragment runs through `run_query` too: its scans staged over
the row ranges of `scan_ranges` and its RemoteSourceNodes fed by the
batches of `remote_sources` (server/worker.py pulls them).

`run_query` runs on CUDA unless the caller names another device (or a
mesh, whose devices it runs on), and raises when there is no CUDA
device; it never falls back to the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import types as T
from ..block import (Batch, batch_from_numpy, gather_block, resolve_device,
                     to_numpy)
from ..connectors import catalog
from ..ops.aggregation import finalize_states
from ..parallel.exchange import move_batch, slice_batch
from ..plan import nodes as N
from ..plan.stats import capacity_nodes, scale_capacities
from ..plan.widths import checked_physical_dtypes
from ..utils.config import session_flag, session_value
from .dynfilter import apply_dynamic_filters, collect_dynamic_filters
from .datapath import device_hop, now_us, record_hop, timed_hop
from .donation import Handoff
from .memory import MemoryPool, batch_bytes
from .planner import compile_plan, scan_leaves
from .stats import QueryStats, StatsCollector, collecting, \
    current_collector

__all__ = ["run_query", "prepare_plan", "QueryResult", "resolve_device",
           "stage_scans", "stage_scan_split", "planned_scan_bytes",
           "execute", "capacity_plan", "shard_batch", "gather_outputs"]

_PAD = 8  # staged capacities are a multiple of this


@dataclasses.dataclass
class QueryResult:
    columns: List[np.ndarray]
    nulls: List[np.ndarray]
    names: List[str]
    row_count: int
    types: List[T.Type] = dataclasses.field(default_factory=list)
    # flat counters under the reference's names: "capacity_reruns" of
    # the run's ladder and its "capacity_scale" (the largest capacity
    # factor it gave a node); "dynamic_filters",
    # "dynamic_filter_rows_pruned", "dynamic_filter_rows_staged" and
    # "dynamic_filter_collect_s"; "reserved_bytes" and
    # "peak_reserved_bytes" of a memory pool; on a mesh
    # "exchange_slot_reruns"; "staged_bytes" and the
    # host walls "scan_stage_s", "execute_s" (the ladder, ending in the
    # read of its flags) and "fetch_s"; the split counters of
    # exec/streaming.py and the spill counters of exec/spill.py; a
    # write root's are its inner SELECT's
    stats: Dict[str, float] = dataclasses.field(default_factory=dict)
    # the structured telemetry (stages/operators/counters/ledgers with
    # a merge law, exec/stats.py); `stats` above stays the flat view
    query_stats: Optional["QueryStats"] = None

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


def _host_columns(conn, node: N.TableScanNode, sf: float, start: int = 0,
                  count: Optional[int] = None):
    """The scan's host columns over rows [start, start + count) (the
    whole table when count is None), and their NULL masks where the
    connector stores NULLs (else None)."""
    rng = () if start == 0 and count is None else (start, count)
    data = conn.generate_columns(node.table, sf, node.columns, *rng)
    nulls = None
    if hasattr(conn, "generate_nulls"):  # stored tables carry NULLs
        nmap = conn.generate_nulls(node.table, node.columns, *rng)
        nulls = [nmap[c] for c in node.columns]
    return data, nulls


def _host_bytes(arrays, nulls=None) -> int:
    """Host bytes of generated columns (object lanes count pointer
    bytes, as in the reference)."""
    total = sum(getattr(a, "nbytes", 0) for a in arrays)
    return total + sum(getattr(n, "nbytes", 0) for n in nulls or ())


def _stage_arrays(node: N.TableScanNode, arrays, nulls, capacity: int,
                  device) -> Batch:
    """Host columns staged at the node's narrow lanes, each narrowing
    re-proved against the actual values (the narrow_cast hop), then
    copied to the device (the device_put hop). The batch carries its
    live row count, known on the host, as `live_rows`."""
    phys = node.physical_dtypes
    if phys:
        with timed_hop("narrow_cast", _host_bytes(arrays, nulls)):
            phys = checked_physical_dtypes(phys, node.column_types, arrays,
                                           nulls=nulls)
    with timed_hop("device_put") as t_put:
        b = batch_from_numpy(node.column_types, arrays, nulls=nulls,
                             capacity=capacity, physical_dtypes=phys,
                             device=device)
        t_put.bytes = batch_bytes(b)
    return b


def _connector_batch(conn, node: N.TableScanNode, sf: float, **kw) -> Batch:
    """A batch the connector stages itself: its whole read and copy
    attribute to the connector_read hop (coarse, as in the
    reference)."""
    t0 = now_us()
    b = conn.generate_batch(node.table, sf, node.columns, **kw)
    end = now_us()
    record_hop("connector_read", batch_bytes(b), (end - t0) / 1e6,
               end_us=end)
    return b


def stage_scan_split(conn, node: N.TableScanNode, sf: float, start: int,
                     count: Optional[int], capacity: int, device) -> Batch:
    """Stage rows [start, start + count) of one scan (the whole table
    when count is None) at `capacity` on `device`: the shared staging
    path of the runner and the streaming executor. A scan without
    narrow lanes over a connector that stages its own batches (the
    stored and file tables) takes the connector's `generate_batch`, as
    in the reference: a file is then decoded once, not once for its
    values and again for its NULLs."""
    if not any(node.physical_dtypes or ()) and \
            hasattr(conn, "generate_batch"):
        return _connector_batch(conn, node, sf, start=start, count=count,
                                capacity=capacity, device=device)
    with timed_hop("connector_read") as t_read:
        data, nulls = _host_columns(conn, node, sf, start, count)
        arrays = [data[c] for c in node.columns]
        t_read.bytes = _host_bytes(arrays, nulls)
    return _stage_arrays(node, arrays, nulls, capacity, device)


def _padded(rows: int, pad: int = _PAD) -> int:
    return max(-(-rows // pad) * pad, pad)


def _scan_batch(node: N.PlanNode, sf: float, device,
                dyn_filters=None, stats: Optional[Dict] = None,
                pad: int = _PAD, scan_range=None) -> Batch:
    """One scan's or VALUES node's staged batch, its capacity a multiple
    of `pad`. A `scan_range` (start, count) stages only those rows of
    the table. With `dyn_filters` (the scan's domains from
    exec/dynfilter.py) the host rows outside them are dropped before
    staging, and the rows pruned and staged go to `stats`. Otherwise a
    scan with a `pushdown` range over a connector that prunes row
    groups (parquet) stages only the matching row groups, at the
    capacity of the whole table."""
    if isinstance(node, N.ValuesNode):
        return _stage_values(node, device, pad)
    conn = catalog(node.connector)
    if scan_range is not None:
        start, count = scan_range
        return stage_scan_split(conn, node, sf, start, count,
                                _padded(count, pad), device)
    if not dyn_filters:
        rows = conn.table_row_count(node.table, sf)
        if node.pushdown is not None and \
                hasattr(conn, "row_groups_matching"):
            # the connector skips the row groups its statistics prove
            # outside the range (the Filter above still runs); the
            # capacity stays the table's, as in the reference
            return _connector_batch(conn, node, sf,
                                    capacity=_padded(rows, pad),
                                    predicate=tuple(node.pushdown),
                                    device=device)
        return stage_scan_split(conn, node, sf, 0, None,
                                _padded(rows, pad), device)
    with timed_hop("connector_read") as t_read:
        data, nulls = _host_columns(conn, node, sf)
        t_read.bytes = _host_bytes(list(data.values()), nulls)
    keep, pruned = apply_dynamic_filters(data, node.columns, dyn_filters)
    if stats is not None:
        _add(stats, "dynamic_filter_rows_pruned", pruned)
        _add(stats, "dynamic_filter_rows_staged", int(keep.sum()))
    arrays = [data[c] for c in node.columns]
    if pruned:  # else the host arrays stage as they are, uncopied
        arrays = [a[keep] for a in arrays]
        if nulls is not None:
            nulls = [n[keep] for n in nulls]
    return _stage_arrays(node, arrays, nulls, _padded(len(arrays[0])),
                         device)


def _add(stats: Dict, name: str, value) -> None:
    stats[name] = stats.get(name, 0) + value


def _stage_values(node: N.ValuesNode, device, pad: int = _PAD) -> Batch:
    """A VALUES node's rows as one batch, as the reference's
    `_scan_batch` builds it: strings and long decimals as object
    columns, other values at their type's dtype with NULL as 0; a
    node without columns (a FROM-less SELECT) is its active rows
    alone."""
    n = len(node.rows)
    cap = _padded(n, pad)
    if not node.types:
        active = torch.zeros(cap, dtype=torch.bool, device=device)
        active[:n] = True
        b = Batch((), active)
        b.live_rows = n
        return b
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


def shard_batch(b: Batch, mesh) -> List[Batch]:
    """A staged batch (capacity a multiple of the mesh's size) cut into
    contiguous equal shards, worker w's on its own device: the
    reference's `P(WORKERS_AXIS)` split of axis 0."""
    step = b.capacity // mesh.size
    return [slice_batch(b, w * step, (w + 1) * step, d)
            for w, d in enumerate(mesh.devices)]


def stage_scans(root: N.PlanNode, sf: float, device,
                dynamic_filters: Optional[Dict] = None,
                stats: Optional[Dict] = None, mesh=None,
                scan_ranges: Optional[Mapping] = None,
                remote_sources: Optional[Mapping] = None,
                collector: Optional[StatsCollector] = None,
                prog=None) -> List:
    """Staged batches of the plan's scans, VALUES and remote sources, in
    compile_plan's order, each scan pruned by its `dynamic_filters`
    entry (what `run_query` collects) and cut to its `scan_ranges`
    entry (start, count), each RemoteSourceNode the batch of its
    `remote_sources` entry. With a mesh each is padded to a multiple of
    8 x its size, encoded once on the host (one string width and one
    lane per column for every worker) and cut into the workers' shards,
    each copied to its worker's device alone (`shard_batch`): one list
    of batches per scan.

    Each scan's staging hops attribute to its split index on the
    timeline; with a `collector` each scan gets its operator row
    (structural key `scan[i]:<label>`, wall, rows, bytes) and its
    estimate-vs-actual record, and `prog` advances one split per scan.
    Rows are the host-known live counts (`Batch.live_rows`): nothing is
    read back from the device."""
    from .accuracy import est_rows_of, record_node
    from .timeline import split_scope
    dynamic_filters = dynamic_filters or {}
    scan_ranges = scan_ranges or {}
    remote_sources = remote_sources or {}
    host = torch.device("cpu") if mesh is not None else device
    pad = _PAD * (mesh.size if mesh is not None else 1)
    out = []
    for si, n in enumerate(compile_plan(root).scan_nodes):
        t0 = time.perf_counter()
        if isinstance(n, N.RemoteSourceNode):
            if n.id not in remote_sources:
                raise KeyError(f"no remote source batch supplied for "
                               f"node {n.id}")
            b = remote_sources[n.id]
        else:
            with split_scope(si):
                b = _scan_batch(n, sf, host,
                                dynamic_filters.get(n.id) if mesh is None
                                else None, stats, pad=pad,
                                scan_range=scan_ranges.get(n.id))
        rows = getattr(b, "live_rows", None)
        nbytes = batch_bytes(b)
        out.append(b if mesh is None else shard_batch(b, mesh))
        if collector is not None:
            key = _scan_key(si, n)
            collector.operator(key, _scan_label(n),
                               wall_us=int((time.perf_counter() - t0) * 1e6),
                               output_rows=rows or 0, output_bytes=nbytes)
            collector.bump_stage("staging", rows=rows or 0, bytes=nbytes)
            record_node(key, _scan_label(n), unit="rows",
                        est=est_rows_of(n, sf), actual=rows)
        if prog is not None:  # one split staged = one heartbeat
            prog.advance(splits=1, rows=rows or 0, bytes=nbytes)
    return out


def _scan_key(index: int, node: N.PlanNode) -> str:
    """Structural operator key of the index-th scan leaf (staging
    order): it lines up across workers running the same fragment, so
    per-node rows merge by key, as in the reference."""
    return f"scan[{index}]:{_scan_label(node)}"


def _scan_label(node: N.PlanNode) -> str:
    if isinstance(node, N.TableScanNode):
        return f"TableScan[{node.connector}.{node.table}]"
    if isinstance(node, N.RemoteSourceNode):
        return "RemoteSource"
    return type(node).__name__


def planned_scan_bytes(node: N.PlanNode, sf: float, pad: int = _PAD,
                       scan_range=None, remote_sources=None) -> int:
    """Planned device footprint of a scan, VALUES or remote input,
    without generating it: per row padded to a multiple of `pad`
    (a `scan_range`'s count of rows), the active mask, each column's
    lane and null mask (a string its declared width, 64 bytes where
    that is unbounded, and its length). A remote source's batch is
    already staged: its bytes."""
    if isinstance(node, N.RemoteSourceNode):
        b = (remote_sources or {}).get(node.id)
        return 0 if b is None else batch_bytes(b)
    if isinstance(node, N.ValuesNode):
        rows, types = len(node.rows), node.types
    elif scan_range is not None:
        rows, types = scan_range[1], node.column_types
    else:
        rows = catalog(node.connector).table_row_count(node.table, sf)
        types = node.column_types
    per_row = 1
    for ty in types:
        if ty.is_string:
            per_row += (ty.max_length if ty.max_length < 1 << 20 else 64) + 5
        else:
            per_row += np.dtype(ty.to_dtype()).itemsize + 1
    return _padded(rows, pad) * per_row


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


def _dispatch_ladder(root: N.PlanNode, batches: Sequence,
                     limb_form: str, default_join_capacity: int,
                     adaptive: bool = True, mesh=None,
                     staged_bytes: int = 0, hops: Optional[List] = None,
                     prog=None, use_cache: bool = False
                     ) -> Tuple[object, int, int, int, int]:
    """Run the plan; when a join or group table overflows, rerun with
    its capacity 4x larger (scale_capacities; a join without an
    out_capacity starts at `default_join_capacity`), up to 1024x, and
    with the capacity of every join above it 4x larger too, since their
    input was cut short. The reference raises every capacity of the
    plan at once; an aggregation here grows only when it overflows
    itself, so a join's overflow leaves a small aggregation on its
    small-table path. With `adaptive` off (the session property
    adaptive_capacity false) the first overflow raises. On a mesh an
    exchange slot that overflowed (and no capacity) reruns the plan
    with every slot twice as large, as the reference's ladder does (a
    capacity rerun starts the slots again at their base). Returns
    (output, largest capacity factor, capacity reruns, slot reruns,
    lowerings paid); on a mesh the output is the workers' batches.

    With `use_cache` each rung's plan is lowered through the
    compiled-plan cache (exec/plan_cache.py), and only a miss pays a
    lowering. A lowering, and the kernel builds a dispatch paid
    (ops/kernels.py's BUILD_SECONDS delta), are compile time of the
    ambient collector; each dispatch is one `kernel` hop over
    `staged_bytes` (datapath.device_hop: CUDA events, resolved after
    the fetch), its hop object appended to `hops`, and `prog` advances
    per dispatch."""
    fp, ids, factors = _fitted_capacities(root, mesh)
    above = _joins_above(root, ids)
    factors = list(factors)
    reruns = slot_reruns = lowered = 0
    slot_scale = 1
    collector = current_collector()
    device = mesh.devices[0] if mesh is not None else \
        _batches_device(batches)
    while True:
        plan, hit = _lower(root, ids, factors, mesh, limb_form,
                           default_join_capacity, slot_scale, use_cache)
        if not hit:
            lowered += 1
        built0 = _build_seconds()
        with device_hop("kernel", staged_bytes, device) as hop:
            if mesh is None:
                out, flags = plan.fn(batches)
            else:
                out, flags, slots = plan.fn(batches)
        # a first launch that built its kernel paid that inside the hop
        hop.compile_s = _build_seconds() - built0
        if collector is not None:
            collector.add_compile_seconds(hop.compile_s)
        if hops is not None:
            hops.append(hop)
        if prog is not None:  # each dispatch advances
            prog.advance()
        if mesh is None:
            read = flags.tolist()
        else:
            read = torch.cat([flags, slots.reshape(1)]).tolist()
            slots = read.pop()
        over = [k for k, o in enumerate(read) if o]
        if not over and (mesh is None or not slots):
            if any(k > 1 for k in factors):
                _CAPACITY_FEEDBACK[fp] = tuple(factors)
            return (out, max(factors, default=1), reruns, slot_reruns,
                    lowered)
        if not over:
            if slot_scale >= 1 << 20:
                raise RuntimeError("exchange slot overflow did not "
                                   "converge")
            slot_scale *= 2
            slot_reruns += 1
            continue
        if not adaptive or \
                any(factors[k] >= _MAX_CAPACITY_SCALE for k in over):
            raise RuntimeError(
                "plan execution overflowed a static bucket (join/group "
                "capacity) beyond the adaptive rerun ceiling; rerun with "
                "larger capacity hints (max_groups / join capacity)")
        for k in set(over).union(*(above[ids[k]] for k in over)):
            factors[k] = min(factors[k] * 4, _MAX_CAPACITY_SCALE)
        reruns += 1
        slot_scale = 1


def _fitted_capacities(root: N.PlanNode, mesh=None
                       ) -> Tuple[str, List[str], Tuple[int, ...]]:
    """(capacity memo key, capacity node ids, the factors the ladder
    last found to fit them: all 1 where it has not run)."""
    fp = _fingerprint(root)
    if mesh is not None:
        # a fitted capacity is per worker: its memo is per mesh size
        fp = f"{fp}@{mesh.size}"
    ids = [n.id for n in capacity_nodes(root)]
    return fp, ids, tuple(_CAPACITY_FEEDBACK.get(fp, (1,) * len(ids)))


def _lower(root: N.PlanNode, ids: List[str], factors: Sequence[int], mesh,
           limb_form: str, default_join_capacity: int, slot_scale: int = 1,
           use_cache: bool = False):
    """(CompiledPlan, cache hit) of one ladder rung: the plan at these
    capacity factors, lowered through the compiled-plan cache with
    `use_cache`; a lowering is compile time of the ambient collector."""
    t0 = time.perf_counter()
    scaled = scale_capacities(root, dict(zip(ids, factors)),
                              default_join_capacity)
    if use_cache:
        from .plan_cache import cached_compile
        plan, _lock, hit = cached_compile(
            scaled, mesh, default_join_capacity, slot_scale, limb_form)
    else:
        plan, hit = compile_plan(scaled, limb_form, mesh=mesh,
                                 exchange_slot_scale=slot_scale), False
    collector = current_collector()
    if not hit and collector is not None:  # a lowering is at least 1 us
        collector.add_compile_seconds(max(time.perf_counter() - t0, 1e-6))
    return plan, hit


def _batches_device(batches: Sequence):
    """The device of the first staged batch (None without one)."""
    for b in batches:
        return b.device if isinstance(b, Handoff) else b.active.device
    return None


def _build_seconds() -> float:
    """Seconds this process has spent building CUDA kernels
    (ops/kernels.py), for the hops that paid a build inside them."""
    from ..ops import kernels
    return kernels.BUILD_SECONDS["total"]


def execute(root: N.PlanNode, batches: Sequence,
            limb_form: str = "narrow",
            default_join_capacity: int = 1 << 16, mesh=None) -> Batch:
    """Run the plan over staged batches (on a mesh, stage_scans' lists)
    through the overflow ladder; a mesh's outputs come back as one
    batch, the workers' rows in worker order on the first device."""
    out = _dispatch_ladder(root, batches, limb_form, default_join_capacity,
                           mesh=mesh, use_cache=True)[0]
    return out if mesh is None else gather_outputs(out, mesh)


def gather_outputs(outs: Sequence[Batch], mesh) -> Batch:
    """The workers' output batches one after another in worker order,
    on the mesh's first device: the reference's concatenation of the
    `P(WORKERS_AXIS)` shards."""
    from ..block import concat_batches
    dev = mesh.devices[0]
    return concat_batches([move_batch(b, dev) for b in outs])


def prepare_plan(root: N.PlanNode, sf: float = 0.01,
                 session=None, mesh=None) -> N.PlanNode:
    """The plan-shaping pipeline run_query applies before lowering, in
    the reference's order and under its session properties: rule-based
    simplification and channel pruning (iterative_optimizer), cost-based
    join reordering and a second simplification sweep
    (join_reordering_strategy), connector predicate pushdown
    (scan_predicate_pushdown: plan/pushdown.py marks the scans whose
    connector prunes row groups), distinct-count capacity refinement
    (stats_capacity_refinement), narrow-width annotation
    (narrow_width_execution), with a mesh the exchanges of
    plan/distribute.py::add_exchanges (join_distribution_type
    BROADCAST, the default, PARTITIONED or AUTOMATIC), and the plan
    checker (its distributed rules with a mesh). Write and DDL roots
    pass through untouched: their inner SELECT is prepared when the
    writer re-enters run_query.

    Last, every distinct node object gets its own id by the rule
    `from_json` reads plan JSON with: the same id with the same content
    is one shared node, the same id with other content becomes `id.k`.
    The passes copy nodes with dataclasses.replace, which keeps the id
    of a node they change, and everything keyed by node id (lowering,
    the capacity ladder, dynamic filters) needs one node per id.

    Then, as in the reference, every node gets its planner row estimate
    as `est_rows` (exec/accuracy.py::stamp_estimates), which EXPLAIN
    and the estimate-vs-actual ledger read. It runs after the
    relabelling: `est_rows` is an attribute, not a JSON field, and the
    round trip through JSON would drop it."""
    inner = root.source if isinstance(root, N.OutputNode) else root
    if isinstance(inner, N.WRITE_ROOTS):
        return root
    from ..plan.reorder import reorder_joins
    from ..plan.rules import optimize_plan
    from ..plan.stats import refine_capacities
    from ..plan.validator import validate_plan
    from ..plan.widths import annotate_widths, narrow_enabled

    iterative = session_flag(session, "iterative_optimizer", True)
    if iterative:
        root = optimize_plan(root)
    if session_value(session, "join_reordering_strategy",
                     "AUTOMATIC") != "NONE":
        rr = reorder_joins(root, sf)
        if rr is not root and iterative:
            rr = optimize_plan(rr)
        root = rr
    if session_flag(session, "scan_predicate_pushdown", True):
        from ..plan.pushdown import push_scan_predicates
        root = push_scan_predicates(root)
    if session_flag(session, "stats_capacity_refinement", True):
        root = refine_capacities(root, sf)
    if narrow_enabled(session):
        root = annotate_widths(root, sf)
    if mesh is not None:
        from ..plan.distribute import add_exchanges
        jd = session_value(session, "join_distribution_type")
        strategy = {"PARTITIONED": "partitioned",
                    "AUTOMATIC": "automatic"}.get(jd, "broadcast")
        root = add_exchanges(root, join_strategy=strategy, sf=sf)
    violations = validate_plan(root, distributed=mesh is not None)
    if violations:
        raise ValueError("plan not executable by the engine "
                         f"(PlanChecker): {violations}")
    from .accuracy import stamp_estimates
    root = N.from_json(N.to_json(root))
    stamp_estimates(root, sf)
    return root


@contextlib.contextmanager
def _query_ledgers(query_id: str, session: Optional[Mapping]):
    """One run_query invocation's live-progress entry (released FINISHED
    or FAILED) and its ambient datapath, accuracy and timeline ledgers:
    yields (progress entry, datapath, accuracy, timeline)."""
    from .accuracy import AccuracyLedger
    from .accuracy import recording as acc_recording
    from .datapath import DatapathLedger
    from .datapath import recording as dp_recording
    from .progress import begin as progress_begin
    from .timeline import TimelineLedger, timeline_enabled
    from .timeline import recording as tl_recording
    prog = progress_begin(query_id)
    dp = DatapathLedger()
    acc = AccuracyLedger()
    tl = TimelineLedger(query_id=query_id,
                        enabled=timeline_enabled(session))
    try:
        with dp_recording(dp), acc_recording(acc), tl_recording(tl):
            yield prog, dp, acc, tl
    except BaseException:
        prog.release(state="FAILED")
        raise
    prog.release(state="FINISHED")


def run_query(root: N.PlanNode, sf: float = 0.01, device=None,
              limb_form: str = "narrow", mesh=None,
              default_join_capacity: int = 1 << 16,
              split_rows: Optional[int] = None,
              hbm_budget_bytes: Optional[int] = None,
              session: Optional[Mapping] = None,
              memory_pool: Optional[MemoryPool] = None,
              query_id: str = "query",
              prepared: bool = False,
              scan_ranges: Optional[Mapping[str, Tuple[int, int]]] = None,
              remote_sources: Optional[Mapping[str, Batch]] = None,
              trace_id=None) -> QueryResult:
    """Plan -> rows, end to end on `device` (CUDA unless asked
    otherwise): `prepare_plan` unless `prepared`, dynamic filtering
    (the small build sides run first and prune the probe scans' host
    rows), the
    reservation of the planned scan bytes in `memory_pool`, staging,
    execution through the overflow ladder, result fetch. A join node
    without an out_capacity starts at `default_join_capacity` rows.

    With `split_rows`, a streamable aggregation (exec/streaming.py)
    runs split by split; when twice its planned state table exceeds
    the device budget (`hbm_budget_bytes`, or the session's), it runs
    bucket by bucket with each finished bucket moved to host memory
    (exec/spill.py). Any other plan takes the normal path. A write
    root (DDL, CTAS, INSERT, DELETE, UPDATE) runs its inner SELECT
    through run_query and writes on the host.

    A plan that the access control (server/access.py::
    set_access_control) refuses for the session's `user` raises
    AccessDeniedException before anything is staged.

    Session properties read (the reference's names): those of
    prepare_plan, user, dynamic_filtering (default on), adaptive_capacity
    (default on), hbm_budget_bytes, spill_path and
    spill_file_threshold_bytes.

    With a `mesh` (parallel/mesh.py::make_mesh) the plan runs on its
    workers, on the mesh's devices (`device` is not read):
    prepare_plan adds the exchanges, each scan is padded to a multiple
    of 8 x the mesh's size and cut into contiguous shards, one a worker
    (`shard_batch`), the ladder also reruns with larger exchange slots
    (`exchange_slot_reruns`), and the result is the workers' rows in
    worker order. Dynamic filtering and split streaming stay off, as in
    the reference.

    The plan is cut into pipeline regions (exec/regions.py): one, the
    whole plan, with fusion on and nothing refused or demoted; else
    each region runs through the ladder in turn, its output handed to
    the next on the device (`fusion_regions`, and per region
    `fusion_region_<tag>_device_us`, in `stats`). Each rung of the
    ladder lowers its plan through the compiled-plan cache
    (exec/plan_cache.py), except for a plan fragment, whose inputs are
    named by node id; only a miss pays a lowering, the compile stage.

    A plan fragment of the worker tier names its inputs by node id:
    `scan_ranges` maps a TableScanNode to the (start, count) rows it
    stages, `remote_sources` a RemoteSourceNode to its batch (on the
    run's device; on a mesh, padded to a multiple of 8 x its size).
    Dynamic filtering and split streaming stay off for such a
    fragment.

    The ledgers: a live-progress entry keyed by `query_id`
    (exec/progress.py) that a status poll, /v1/cluster and the
    stuck-progress watchdog read while the query runs (a write root's
    inner SELECT shares its outer entry), and an ambient datapath,
    accuracy and timeline ledger for the whole invocation. The result
    carries `query_stats` (exec/stats.py). `trace_id` is a plain
    grouping string or a server.tracing.TraceContext, whose span the
    stage spans hang under. Session properties of the ledgers:
    continuous_profiling and timeline (both on by default)."""
    dev = mesh.devices[0] if mesh is not None else resolve_device(device)
    with _query_ledgers(query_id, session) as (prog, dp, acc, tl):
        kw = dict(sf=sf, device=dev, limb_form=limb_form, mesh=mesh,
                  default_join_capacity=default_join_capacity,
                  split_rows=split_rows, hbm_budget_bytes=hbm_budget_bytes,
                  session=session, memory_pool=memory_pool, query_id=query_id,
                  scan_ranges=scan_ranges, remote_sources=remote_sources,
                  trace_id=trace_id)
        fragment = bool(scan_ranges) or bool(remote_sources)
        inner = root.source if isinstance(root, N.OutputNode) else root
        if isinstance(inner, N.WRITE_ROOTS):
            _check_access(root, session)
            return _run_write_root(inner, **kw)
        if not prepared:
            root = prepare_plan(root, sf, session=session, mesh=mesh)
        prog.advance(stage="plan")
        _check_access(root, session)
        stats: Dict[str, float] = {}
        collector = StatsCollector(query_id)
        t_query0 = time.time()
        if split_rows is not None and mesh is None and not fragment:
            built0 = _build_seconds()
            with collecting(collector), collector.stage("execute"):
                prog.advance(stage="execute")
                res = _run_split(root, sf, dev, limb_form, split_rows,
                                 hbm_budget_bytes, session, stats)
            collector.add_compile_seconds(_build_seconds() - built0)
            if res is not None:
                _finalize_query_stats(collector, res, t_query0, 0, root,
                                      trace_id, dp=dp, acc=acc, tl=tl, sf=sf)
                return res
            # not a streamable aggregation: the normal path below
            collector = StatsCollector(query_id)
        dyn_filters = {}
        if mesh is None and not fragment and \
                session_flag(session, "dynamic_filtering", True):
            t0 = time.perf_counter()
            dyn_filters = collect_dynamic_filters(root, sf, dev)
            stats["dynamic_filter_collect_s"] = time.perf_counter() - t0
            if dyn_filters:
                stats["dynamic_filters"] = sum(len(v)
                                               for v in dyn_filters.values())
        reserved = 0
        scan_nodes = scan_leaves(root)
        if memory_pool is not None:
            # admission: the planned scan bytes are charged before anything
            # is staged, so a refusal comes before the device runs out
            pad = _PAD * (mesh.size if mesh is not None else 1)
            reserved = sum(planned_scan_bytes(
                s, sf, pad, (scan_ranges or {}).get(s.id), remote_sources)
                for s in scan_nodes)
            memory_pool.reserve(query_id, reserved)
            stats["reserved_bytes"] = reserved
            prog.note_memory(reserved)
        from .profiler import profiling_enabled
        prof_on = profiling_enabled(session)
        rplan = _partition(root, session, sf, mesh, stats, collector,
                           query_id)
        multi_region = len(rplan.regions) > 1
        built0 = _build_seconds()
        hops: List = []
        region_hops: List = []
        res = None
        peak_reserved = 0
        lowered = 0
        try:
            prog.set_planned(len(scan_nodes))
            prog.advance(stage="staging")
            t0 = time.perf_counter()
            with collector.stage("staging"):
                batches = stage_scans(root, sf, dev, dyn_filters, stats,
                                      mesh=mesh, scan_ranges=scan_ranges,
                                      remote_sources=remote_sources,
                                      collector=collector, prog=prog)
            flat = batches if mesh is None else [w for ws in batches
                                                 for w in ws]
            staged = sum(batch_bytes(b) for b in flat)
            stats["staged_bytes"] = staged
            _note_narrowed(flat, stats, collector, query_id)
            inst = _Instruments(session, collector, stats, memory_pool,
                                query_id, prof_on)
            if inst.audit_on and not multi_region:
                # the plan as its first dispatch will run it, audited
                # once more over the staged batches (audit/staged.py)
                with collecting(collector):
                    _, ids, factors = _fitted_capacities(root, mesh)
                    plan, hit = _lower(root, ids, factors, mesh, limb_form,
                                       default_join_capacity, 1,
                                       not fragment)
                lowered += not hit
                from .plan_cache import plan_fingerprint
                inst.audit(plan, batches, plan_fingerprint(root), mesh=mesh,
                           fused_span=rplan.fused and mesh is None
                           and rplan.regions[0].ops > 1)
            t1 = time.perf_counter()
            prog.advance(stage="execute")
            adaptive = session_flag(session, "adaptive_capacity", True)
            with collecting(collector), collector.stage("execute"):
                if multi_region:
                    out, scale, reruns, lw = _execute_regions(
                        rplan, scan_nodes, batches, limb_form,
                        default_join_capacity, adaptive, staged,
                        region_hops, prog, inst)
                    lowered += lw
                    slot_reruns = 0
                    hops = [h for _reg, hs, _lw in region_hops for h in hs]
                else:
                    out, scale, reruns, slot_reruns, lw = \
                        _dispatch_ladder(
                            root, batches, limb_form, default_join_capacity,
                            adaptive=adaptive, mesh=mesh,
                            staged_bytes=staged, hops=hops, prog=prog,
                            use_cache=not fragment)
                    lowered += lw
            del batches, flat
            if mesh is not None:
                out = gather_outputs(out, mesh)
                stats["exchange_slot_reruns"] = slot_reruns
            t2 = time.perf_counter()
            prog.advance(stage="fetch")
            with collector.stage("fetch"):
                res = _batch_to_result(out, root)
            stats.update(scan_stage_s=t1 - t0, execute_s=t2 - t1,
                         fetch_s=time.perf_counter() - t2)
        finally:
            if memory_pool is not None:
                memory_pool.free(query_id, reserved)
                peak_reserved = memory_pool.query_peak_bytes(query_id,
                                                             pop=True)
                stats["peak_reserved_bytes"] = peak_reserved
            # the dispatches' spans: after the fetch the stream is
            # drained and the events resolve without a wait; on a failure
            # they are dropped unread (a failed run may not have drained)
            device_us = compile_in_us = 0
            if res is not None:
                resolved = _resolve_hops(dp, hops, collector)
                device_us, compile_in_us = resolved
            retraced = lowered > 0 or _build_seconds() > built0
            fused_sample = res is not None and rplan.fused and \
                mesh is None and not multi_region and \
                rplan.regions[0].ops > 1
            fp = None
            if not multi_region and (prof_on or fused_sample):
                from .plan_cache import plan_fingerprint
                fp = plan_fingerprint(root)
            if multi_region:
                if res is not None:
                    _note_regions(rplan, region_hops, stats, prof_on,
                                  query_id, trace_id)
            elif prof_on:
                _profile_call(root, fp, collector, query_id, trace_id,
                              device_us, compile_in_us,
                              stats.get("staged_bytes", 0), res,
                              retraced=retraced)
            if fused_sample:
                _note_fused(fp, device_us - compile_in_us, stats,
                            collector, query_id)
        res.stats = {"capacity_reruns": reruns, "capacity_scale": scale,
                     **stats}
        _finalize_query_stats(collector, res, t_query0, peak_reserved, root,
                              trace_id, dp=dp, acc=acc, tl=tl, sf=sf)
        return res


def _partition(root: N.PlanNode, session, sf: float, mesh, stats: Dict,
               collector: StatsCollector, query_id: str):
    """The plan's pipeline regions (exec/regions.py). Where the
    `fusion.demote` failpoint is armed and the plan is one fused region
    of several operators, an injected error demotes the span mid-query:
    counted as a demotion and a forced one, a `fusion_demotion` flight
    event, and the plan partitioned again, materialised."""
    from .. import failpoints
    from .regions import fusion_memory, partition_regions
    rplan = partition_regions(root, session=session, sf=sf, mesh=mesh)
    if failpoints.ARMED and rplan.fused and mesh is None \
            and len(rplan.regions) == 1 and rplan.regions[0].ops > 1:
        try:
            failpoints.hit("fusion.demote")
        except Exception as e:  # noqa: BLE001 - any injected error class
            from ..server.flight_recorder import record_event
            from .plan_cache import plan_fingerprint
            fusion_memory().demote(plan_fingerprint(rplan.regions[0].root),
                                   f"failpoint ({type(e).__name__})")
            _add(stats, "fusion_demotions", 1)
            _add(stats, "fusion_forced_demotions", 1)
            collector.note("fusion_demotions")
            record_event("fusion_demotion", query_id=query_id,
                         reason="failpoint")
            rplan = partition_regions(root, session=session, sf=sf,
                                      mesh=mesh)
    if len(rplan.regions) > 1:
        stats["fusion_regions"] = len(rplan.regions)
        collector.note("fusion_regions", len(rplan.regions))
    return rplan


class _Instruments:
    """One run_query's kernel audit (audit/staged.py, with the session's
    `kernel_audit` on) and buffer donation (exec/donation.py, with
    `buffer_donation` on): the books both report into."""

    def __init__(self, session, collector: StatsCollector, stats: Dict,
                 memory_pool, query_id: str, prof_on: bool):
        from ..audit.staged import kernel_audit_enabled
        from .donation import donation_enabled
        self.session = session
        self.audit_on = kernel_audit_enabled(session)
        self.donate = donation_enabled(session)
        self.collector = collector
        self.stats = stats
        self.memory_pool = memory_pool
        self.query_id = query_id
        self.prof_on = prof_on

    def audit(self, plan, batches: Sequence, fp: str, mesh=None,
              fused_span: bool = False, donate: Sequence[int] = ()) -> None:
        """Audit one closure over its staged batches; its K005 estimate
        becomes the footprint accuracy record, the profiler row's
        footprint, and, for a fused span, the fusion choice's measured
        footprint (exec/regions.py: over the budget, the span is refused
        on its next submission)."""
        from ..audit.staged import audit_staged_query
        t0 = time.perf_counter()
        built0 = _build_seconds()
        report = audit_staged_query(
            plan, batches, mesh=mesh, query_id=self.query_id,
            session=self.session, collector=self.collector,
            stats=self.stats, memory_pool=self.memory_pool, plan_fp=fp,
            donate=donate)
        # a kernel the audited run built first is compile time
        self.collector.add_compile_seconds(_build_seconds() - built0)
        _add(self.stats, "kernel_audit_s", time.perf_counter() - t0)
        est = (report or {}).get("peak_bytes_estimate")
        if not est:
            return
        from .accuracy import record_node
        record_node("footprint", "MemoryPool", unit="bytes", est=float(est))
        if fused_span:
            from .regions import fusion_memory
            fusion_memory().note_footprint(fp, est)
        if self.prof_on:
            from .profiler import note_footprint
            note_footprint(fp, est)

    def prepare_donation(self, reg, rbatches: Sequence, consumers: Dict,
                         rfp: str):
        """The region's handoff plan (exec/donation.py), or None: the
        region-kind inputs whose last consumer this region is, read once
        here, if its root is overflow-incapable. An error before the
        handoff is a fallback to the undonated dispatch."""
        from .donation import note_fallback, prepare_donation
        if not self.donate:
            return None
        uses: Dict[int, int] = {}
        for i in reg.inputs:
            if i.kind == "region":
                uses[i.region] = uses.get(i.region, 0) + 1
        dead = [k for k, i in enumerate(reg.inputs)
                if i.kind == "region" and consumers[i.region] == 1
                and uses[i.region] == 1]
        if not dead:
            return None
        try:
            return prepare_donation(rfp, reg.root, rbatches, dead)
        except Exception as e:  # noqa: BLE001 - any injected error class
            from ..server.flight_recorder import record_event
            note_fallback()
            _add(self.stats, "donation_fallbacks", 1)
            self.collector.note("donation_fallbacks")
            record_event("donation_fallback", query_id=self.query_id,
                         region=reg.tag, reason=str(e)[:200])
            return None

    def note_donation(self, reg, prep) -> None:
        from ..server.flight_recorder import record_event
        from .donation import note_donation
        note_donation(prep.donated_bytes, len(prep.donate_idx))
        _add(self.stats, "donations", 1)
        _add(self.stats, "donated_bytes", prep.donated_bytes)
        self.collector.note("donations")
        self.collector.note("donated_bytes", prep.donated_bytes)
        record_event("buffer_donation", query_id=self.query_id,
                     region=reg.tag, bytes=prep.donated_bytes,
                     inputs=len(prep.donate_idx))


def _execute_regions(rplan, scan_nodes: Sequence, batches: Sequence,
                     limb_form: str, default_join_capacity: int,
                     adaptive: bool, staged_bytes: int,
                     region_hops: List, prog, inst: _Instruments
                     ) -> Tuple[Batch, int, int, int]:
    """The region executor (the reference's `_execute_regions`): each
    region's root lowered alone through the compiled-plan cache and run
    through the overflow ladder in producer order, its cut children fed
    as remote-source inputs: their output batches, which stay on the
    device (a materialised handoff, no host round trip), and are dropped
    after their last consumer ran. With `kernel_audit` on, each region's
    closure is audited before its dispatch; with `buffer_donation` on, a
    region of an overflow-incapable root is handed the dead
    intermediates it is the last reader of (exec/donation.py): the
    executor drops its own references to them first, so what the region
    does not pass through frees while it runs. Appends (region, its
    dispatch hops, the lowerings it paid) to `region_hops`. Returns (the
    last region's output, the largest capacity factor, the capacity
    reruns, the lowerings paid)."""
    from .plan_cache import plan_fingerprint
    staged_by_id = {id(n): b for n, b in zip(scan_nodes, batches)}
    outputs: Dict[int, Batch] = {}
    consumers: Dict[int, int] = {}
    for reg in rplan.regions:
        for i in reg.inputs:
            if i.kind == "region":
                consumers[i.region] = consumers.get(i.region, 0) + 1
    scale, reruns, lowered = 1, 0, 0
    for reg in rplan.regions:
        rbatches = [staged_by_id[id(i.node)] if i.kind == "scan"
                    else outputs[i.region] for i in reg.inputs]
        rfp = plan_fingerprint(reg.root) \
            if inst.audit_on or inst.donate else ""
        prep = inst.prepare_donation(reg, rbatches, consumers, rfp)
        if inst.audit_on:
            _, ids, factors = _fitted_capacities(reg.root)
            plan, hit = _lower(reg.root, ids, factors, None, limb_form,
                               default_join_capacity, 1, True)
            lowered += not hit
            inst.audit(plan, rbatches, rfp, fused_span=True,
                       donate=prep.donate_idx if prep is not None else ())
        if prep is not None:
            rbatches = prep.handoff(rbatches)
            for k in prep.donate_idx:
                outputs.pop(reg.inputs[k].region)
            inst.note_donation(reg, prep)
        hops: List = []
        # no local name may keep an input alive through the dispatch
        res = _dispatch_ladder(
            reg.root, rbatches, limb_form, default_join_capacity,
            adaptive=adaptive, staged_bytes=staged_bytes, hops=hops,
            prog=prog, use_cache=True)
        del rbatches
        outputs[reg.index], k, r, _slots, lw = res
        del res
        region_hops.append((reg, hops, lw))
        scale, reruns, lowered = max(scale, k), reruns + r, lowered + lw
        for i in reg.inputs:  # drop intermediates past their last use
            if i.kind == "region":
                consumers[i.region] -= 1
                if not consumers[i.region]:
                    outputs.pop(i.region, None)
    return outputs[rplan.regions[-1].index], scale, reruns, lowered


def _note_regions(rplan, region_hops: List, stats: Dict, prof_on: bool,
                  query_id: str, trace_id) -> None:
    """After the fetch: each region's device microseconds (its dispatch
    spans less the kernel builds paid inside them) as the flat counter
    `fusion_region_<tag>_device_us` and, with profiling on, a profiler
    row under the region's fingerprint tagged `[region Rk/n]`
    (retraced where it paid a lowering or a build); their
    sum is the materialised sample of the span the whole plan fuses to
    (FusionMemory.note_unfused)."""
    from ..server.tracing import TraceContext
    from .datapath import hop_device_us
    from .plan_cache import plan_fingerprint
    from .profiler import plan_label, plan_tables, record_call
    from .regions import fusion_memory
    nreg = len(rplan.regions)
    total = 0
    for reg, hops, lowered in region_hops:
        cu = sum(int(h.compile_s * 1e6) for h in hops)
        dev_us = max(sum(hop_device_us(h) for h in hops) - cu, 0)
        total += dev_us
        stats[f"fusion_region_{reg.tag}_device_us"] = dev_us
        if prof_on:
            record_call(
                plan_fingerprint(reg.root),
                label=(f"{plan_label(reg.root, max_len=120)} "
                       f"[region {reg.tag}/{nreg}]"),
                tables=plan_tables(reg.root), device_us=dev_us,
                retraced=lowered > 0 or cu > 0, query_id=query_id,
                trace_id=trace_id.trace_id
                if isinstance(trace_id, TraceContext)
                else (trace_id or query_id))
    fusion_memory().note_unfused(plan_fingerprint(rplan.root), total)


def _note_fused(fp: str, device_us: int, stats: Dict,
                collector: StatsCollector, query_id: str) -> None:
    """The fused side of the demotion comparator: this run's device
    microseconds of the fused span, whose fingerprint is `fp`. When the
    profiler's samples show it slower than the span run materialised,
    beyond the perfgate band, the span demotes and the next submission
    runs materialised."""
    from .regions import fusion_memory
    mem = fusion_memory()
    mem.note_fused(fp, max(device_us, 0))
    verdict = mem.maybe_demote(fp)
    if verdict is not None:
        from ..server.flight_recorder import record_event
        _add(stats, "fusion_demotions", 1)
        collector.note("fusion_demotions")
        record_event("fusion_demotion", query_id=query_id,
                     reason="profiler", ratio=verdict.get("ratio"))


def _resolve_hops(dp, hops: List, collector: StatsCollector
                  ) -> Tuple[int, int]:
    """(device micros, compile micros paid inside them) of the run's
    kernel hops: CUDA event pairs resolved now, after the fetch, plus
    the host walls of hops on other devices. The anchor's skew rides
    QueryStats' counters as `device_anchor_skew_us`."""
    from .datapath import resolve_device_hops
    got = resolve_device_hops(dp)
    if got["hops"]:
        collector.note("device_anchor_skew_us", got["anchorSkewUs"])
    device_us = got["deviceUs"] + sum(h.dur_us for h in hops
                                      if not h.cuda)
    compile_us = got["compileUs"] + sum(int(h.compile_s * 1e6)
                                        for h in hops if not h.cuda)
    return device_us, compile_us


def _profile_call(root, fp: str, collector, query_id: str, trace_id,
                  device_us: int, compile_in_us: int, staged_bytes: int,
                  res, retraced: bool) -> None:
    """Attribute the run to its plan fingerprint `fp` in the continuous
    profiler, on success and failure: the dispatch spans less the
    compile paid inside the dispatches. `retraced` where the run paid
    a lowering (a miss of the compiled-plan cache) or built a kernel,
    as an XLA compile marks a cold run in the reference."""
    from ..server.tracing import TraceContext
    from .profiler import plan_label, plan_tables, record_call
    staging = collector.stats.stages.get("staging")
    record_call(
        fp, label=plan_label(root),
        tables=plan_tables(root),
        device_us=max(device_us - compile_in_us, 0),
        rows_in=staging.rows if staging is not None else 0,
        bytes_in=staged_bytes,
        rows_out=res.row_count if res is not None else 0,
        bytes_out=_result_bytes(res) if res is not None else 0,
        retraced=retraced,
        query_id=query_id,
        trace_id=trace_id.trace_id if isinstance(trace_id, TraceContext)
        else (trace_id or query_id))


def _note_narrowed(batches: Sequence, stats: Dict,
                   collector: StatsCollector, query_id: str) -> None:
    """The staged bytes narrow lanes saved against the logical ones:
    a flat counter, QueryStats counters, the process totals of
    /v1/metrics and one flight-recorder event."""
    from ..plan.widths import batch_narrowed_bytes_saved, note_narrowed
    cols = saved = 0
    for b in batches:
        c, n = batch_narrowed_bytes_saved(b)
        cols += c
        saved += n
    if not saved:
        return
    stats["narrowed_bytes_saved"] = saved
    collector.note("narrowed_bytes_saved", saved)
    collector.note("narrowed_columns", cols)
    note_narrowed(cols, saved)
    from ..server.flight_recorder import record_event
    record_event("narrow_width", query_id=query_id, columns=cols,
                 bytes_saved=saved)


def _result_bytes(res: QueryResult) -> int:
    return sum(getattr(v, "nbytes", 0) + getattr(n, "nbytes", 0)
               for v, n in zip(res.columns, res.nulls))


def _finalize_query_stats(collector: StatsCollector, res: QueryResult,
                          t0: float, peak_reserved_bytes: int,
                          root: Optional[N.PlanNode], trace_id=None,
                          dp=None, acc=None, tl=None,
                          sf: float = 0.01) -> None:
    """Close out the structured stats of one run_query invocation, as
    the reference does: the datapath hops and timeline slice ride
    QueryStats and the per-query registries, the compile seconds become
    the `compile` stage (anchored at the start of execute and clamped
    to its wall), the output operator and the root's estimate-vs-actual
    record close the ledgers, one span per stage goes to the tracer
    (children of the TraceContext's span when `trace_id` is one) and
    each stage's wall to the stage histogram."""
    from ..server.metrics import observe_histogram
    from ..server.tracing import TraceContext
    from .accuracy import est_rows_of
    from .accuracy import finalize_query as acc_finalize
    from .accuracy import merge_record_maps
    from .datapath import merge_hop_maps
    from .datapath import note_query as dp_note
    from .timeline import note_query as tl_note
    qs = collector.stats
    tid = trace_id.trace_id if isinstance(trace_id, TraceContext) \
        else (trace_id or collector.query_id)
    if dp is not None:
        hops = dp.snapshot_hops()
        if hops:
            qs.datapath = merge_hop_maps(qs.datapath, hops)
            dp_note(collector.query_id, hops)
    if tl is not None:
        sl = tl.snapshot_slice()
        if not sl.is_empty():
            qs.timeline = qs.timeline.merge(sl)
            tl_note(collector.query_id, sl, trace_id=tid)
    compile_us = collector.take_compile_us()
    exec_stage = qs.stages.get("execute")
    if exec_stage is not None and exec_stage.wall_us:
        compile_us = min(compile_us, exec_stage.wall_us)
    if compile_us:
        anchor = collector.stage_span_start("execute") or t0
        collector.record_stage("compile", anchor, anchor + compile_us / 1e6,
                               compile_us=compile_us)
    qs.wall_us = int((time.time() - t0) * 1e6)
    qs.output_rows = res.row_count
    qs.output_bytes = _result_bytes(res)
    staging = qs.stages.get("staging")
    qs.peak_memory_bytes = max(qs.peak_memory_bytes,
                               staging.bytes if staging else 0,
                               peak_reserved_bytes)
    if root is not None:
        collector.operator("output", type(root).__name__,
                           output_rows=res.row_count,
                           output_bytes=qs.output_bytes,
                           wall_us=qs.stage_us("fetch"))
    if acc is not None:
        if root is not None:
            acc.record("output", node_type=type(root).__name__,
                       unit="rows", est=est_rows_of(root, sf),
                       actual=float(res.row_count))
        recs = acc.snapshot_records()
        if "footprint" in recs and qs.peak_memory_bytes:
            # the K005 estimate's actual: the pool's measured peak
            acc.record("footprint", node_type="MemoryPool", unit="bytes",
                       actual=float(qs.peak_memory_bytes))
            recs = acc.snapshot_records()
        if recs:
            qs.accuracy = merge_record_maps(qs.accuracy, recs)
            acc_finalize(collector.query_id, recs)
    res.query_stats = qs
    if isinstance(trace_id, TraceContext):
        collector.emit_spans(trace_id.trace_id, parent_id=trace_id.span_id)
    else:
        collector.emit_spans(tid)
    for name, st in qs.stages.items():
        if st.wall_us:
            observe_histogram("presto_tpu_stage_seconds", st.wall_us / 1e6,
                              labels={"stage": name}, trace_id=tid)


def _check_access(root: N.PlanNode, session) -> None:
    """The process-wide access control (server/access.py), if one is
    set, on the plan for the session's user: before anything is
    staged."""
    from ..server.access import get_access_control
    acl = get_access_control()
    if acl is not None:
        acl.check_plan(root, (session or {}).get("user", ""))


def _run_split(root: N.PlanNode, sf: float, device, limb_form: str,
               split_rows: int, hbm_budget_bytes: Optional[int], session,
               stats: Dict) -> Optional[QueryResult]:
    """The split branch of run_query: a streamable aggregation streamed
    (or spilled, under a budget its state table does not fit), None
    for any other plan."""
    from .spill import plan_state_bytes, run_spilled_agg
    from .streaming import run_streaming_agg, streamable_agg_shape
    shape = streamable_agg_shape(root)
    if shape is None:
        return None
    agg, _scan = shape
    budget = hbm_budget_bytes
    if budget is None:
        budget = session_value(session, "hbm_budget_bytes")
    if budget and 2 * plan_state_bytes(agg) > budget:  # 0/None: no cap
        out = run_spilled_agg(
            root, sf, split_rows, budget, device, stats,
            spill_dir=session_value(session, "spill_path") or None,
            spill_file_threshold=int(session_value(
                session, "spill_file_threshold_bytes", 256 << 20)),
            limb_form=limb_form)
    else:
        r = run_streaming_agg(root, sf, split_rows, device,
                              limb_form=limb_form, stats=stats)
        if bool(r.overflow):
            raise RuntimeError("streaming aggregation overflowed "
                               "max_groups; raise AggregationNode.max_groups")
        # the splits accumulate states; the SINGLE step still finalizes
        out = finalize_states(r.batch, len(agg.group_channels),
                              agg.aggregates)
    res = _batch_to_result(out, root)
    res.stats = {"capacity_reruns": 0, "capacity_scale": 1, **stats}
    return res


def _count_result(rows: int, stats: Dict) -> QueryResult:
    return QueryResult([np.array([rows], dtype=np.int64)],
                       [np.array([False])], ["rows"], 1, types=[T.BIGINT],
                       stats=dict(stats))


def _run_write_root(node: N.PlanNode, **kw) -> QueryResult:
    """Run a DdlNode, TableRewriteNode, TableWriterNode or
    TableFinishNode root: the inner SELECT through run_query on the
    device, the write on the host. CTAS and INSERT stage into an insert
    handle and publish at once, aborting (a CTAS's table dropped) on
    any failure. A TableFinish whose source is no writer is the commit
    task of a distributed write: its source delivers the writer tasks'
    row counts, which it sums."""
    if isinstance(node, N.DdlNode):
        if node.op != "drop_table":
            raise ValueError(f"unknown DDL operation {node.op!r}")
        catalog(node.connector).drop_table(node.table,
                                           if_exists=node.if_exists)
        return QueryResult([np.array([True])], [np.array([False])],
                           ["result"], 1, types=[T.BOOLEAN])

    if isinstance(node, N.TableRewriteNode):
        # DELETE/UPDATE: new contents and the `changed` flags computed
        # on the device, the table swapped on the host, all under the
        # table's writer lock so that no committed insert is lost
        mod = catalog(node.connector)
        with mod.write_lock(node.table):
            res = run_query(N.OutputNode(node.source, []), **kw)
            ncols = len(res.columns) - 1
            changed = np.asarray(res.columns[-1]).astype(bool) & \
                ~np.asarray(res.nulls[-1], dtype=bool)
            if node.kind == "delete":
                keep = ~changed
                cols = [c[keep] for c in res.columns[:ncols]]
                nulls = [n[keep] for n in res.nulls[:ncols]]
            else:
                cols = list(res.columns[:ncols])
                nulls = list(res.nulls[:ncols])
            mod.replace_table(node.table, cols, nulls)
        return _count_result(int(changed.sum()), res.stats)

    if isinstance(node, N.TableWriterNode):
        res = run_query(N.OutputNode(node.source, node.column_names), **kw)
        mod = catalog(node.connector)
        h = mod.begin_insert(node.table)
        try:
            mod.append(h, res.columns, res.nulls)
            rows = mod.finish_insert(h)
        except BaseException:
            mod.abort_insert(h)
            raise
        return _count_result(rows, res.stats)

    mod = catalog(node.connector)
    src = node.source
    while isinstance(src, N.ExchangeNode):  # one device: the identity
        src = src.source
    if not isinstance(src, N.TableWriterNode):
        res = run_query(N.OutputNode(node.source, ["rows"]), **kw)
        total = int(sum(int(v) for v, nl in zip(res.columns[0],
                                                 res.nulls[0]) if not nl))
        return _count_result(total, res.stats)
    h = mod.begin_insert(
        node.table,
        create_columns=node.create_columns if node.create else None,
        create_types=node.create_types if node.create else None)
    try:
        res = run_query(N.OutputNode(src.source, src.column_names), **kw)
        mod.append(h, res.columns, res.nulls)
        rows = mod.finish_insert(h)
    except BaseException:
        mod.abort_insert(h)
        raise
    return _count_result(rows, res.stats)


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
