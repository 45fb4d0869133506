"""Query runner: plan preparation, staging, execution, result fetch.

Counterpart of presto_tpu/exec/runner.py (`prepare_plan`, `QueryResult`,
`run_query` with its dynamic filtering, memory-pool admission and split
branch, `stage_scan_split`, the overflow->rerun ladder of
`_dispatch_ladder` with its per-plan capacity memo and, on a mesh, its
exchange-slot reruns, the write roots of `_run_write_root`,
`_batch_to_result`) on one device or a mesh of workers
(parallel/mesh.py), with the access-control check of
server/access.py on every plan and write root before anything is
staged. The observability ledgers of the reference (stats, datapath,
timeline, accuracy) are not part of this port yet (ROADMAP queue 1
item 15).
A plan fragment runs through `run_query` too: its scans staged over
the row ranges of `scan_ranges` and its RemoteSourceNodes fed by the
batches of `remote_sources` (server/worker.py pulls them).

`run_query` runs on CUDA unless the caller names another device (or a
mesh, whose devices it runs on), and raises when there is no CUDA
device; it never falls back to the CPU.
"""

from __future__ import annotations

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
from .memory import MemoryPool, batch_bytes
from .planner import compile_plan

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


def _stage_arrays(node: N.TableScanNode, arrays, nulls, capacity: int,
                  device) -> Batch:
    """Host columns staged at the node's narrow lanes, each narrowing
    re-proved against the actual values."""
    phys = node.physical_dtypes
    if phys:
        phys = checked_physical_dtypes(phys, node.column_types, arrays,
                                       nulls=nulls)
    return batch_from_numpy(node.column_types, arrays, nulls=nulls,
                            capacity=capacity, physical_dtypes=phys,
                            device=device)


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
        return conn.generate_batch(node.table, sf, node.columns,
                                   start=start, count=count,
                                   capacity=capacity, device=device)
    data, nulls = _host_columns(conn, node, sf, start, count)
    return _stage_arrays(node, [data[c] for c in node.columns], nulls,
                         capacity, device)


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
            return conn.generate_batch(node.table, sf, node.columns,
                                       capacity=_padded(rows, pad),
                                       predicate=tuple(node.pushdown),
                                       device=device)
        return stage_scan_split(conn, node, sf, 0, None,
                                _padded(rows, pad), device)
    data, nulls = _host_columns(conn, node, sf)
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
                remote_sources: Optional[Mapping] = None) -> List:
    """Staged batches of the plan's scans, VALUES and remote sources, in
    compile_plan's order, each scan pruned by its `dynamic_filters`
    entry (what `run_query` collects) and cut to its `scan_ranges`
    entry (start, count), each RemoteSourceNode the batch of its
    `remote_sources` entry. With a mesh each is padded to a multiple of
    8 x its size, encoded once on the host (one string width and one
    lane per column for every worker) and cut into the workers' shards,
    each copied to its worker's device alone (`shard_batch`): one list
    of batches per scan."""
    dynamic_filters = dynamic_filters or {}
    scan_ranges = scan_ranges or {}
    remote_sources = remote_sources or {}
    host = torch.device("cpu") if mesh is not None else device
    pad = _PAD * (mesh.size if mesh is not None else 1)
    out = []
    for n in compile_plan(root).scan_nodes:
        if isinstance(n, N.RemoteSourceNode):
            if n.id not in remote_sources:
                raise KeyError(f"no remote source batch supplied for "
                               f"node {n.id}")
            b = remote_sources[n.id]
        else:
            b = _scan_batch(n, sf, host,
                            dynamic_filters.get(n.id) if mesh is None
                            else None, stats, pad=pad,
                            scan_range=scan_ranges.get(n.id))
        out.append(b if mesh is None else shard_batch(b, mesh))
    return out


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
                     adaptive: bool = True, mesh=None
                     ) -> Tuple[object, int, int, int]:
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
    (output, largest capacity factor, capacity reruns, slot reruns);
    on a mesh the output is the workers' batches."""
    fp = _fingerprint(root)
    if mesh is not None:
        # a fitted capacity is per worker: its memo is per mesh size
        fp = f"{fp}@{mesh.size}"
    ids = [n.id for n in capacity_nodes(root)]
    above = _joins_above(root, ids)
    factors = list(_CAPACITY_FEEDBACK.get(fp, (1,) * len(ids)))
    reruns = slot_reruns = 0
    slot_scale = 1
    while True:
        plan = compile_plan(
            scale_capacities(root, dict(zip(ids, factors)),
                             default_join_capacity), limb_form,
            mesh=mesh, exchange_slot_scale=slot_scale)
        if mesh is None:
            out, flags = plan.fn(batches)
            read = flags.tolist()
        else:
            out, flags, slots = plan.fn(batches)
            read = torch.cat([flags, slots.reshape(1)]).tolist()
            slots = read.pop()
        over = [k for k, o in enumerate(read) if o]
        if not over and (mesh is None or not slots):
            if any(k > 1 for k in factors):
                _CAPACITY_FEEDBACK[fp] = tuple(factors)
            return out, max(factors, default=1), reruns, slot_reruns
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


def execute(root: N.PlanNode, batches: Sequence,
            limb_form: str = "narrow",
            default_join_capacity: int = 1 << 16, mesh=None) -> Batch:
    """Run the plan over staged batches (on a mesh, stage_scans' lists)
    through the overflow ladder; a mesh's outputs come back as one
    batch, the workers' rows in worker order on the first device."""
    out = _dispatch_ladder(root, batches, limb_form, default_join_capacity,
                           mesh=mesh)[0]
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

    One pass of the reference's pipeline is not here: `stamp_estimates`
    feeds the observability ledgers (ROADMAP queue 1 item 15)."""
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
    return N.from_json(N.to_json(root))


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
              remote_sources: Optional[Mapping[str, Batch]] = None
              ) -> QueryResult:
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

    A plan fragment of the worker tier names its inputs by node id:
    `scan_ranges` maps a TableScanNode to the (start, count) rows it
    stages, `remote_sources` a RemoteSourceNode to its batch (on the
    run's device; on a mesh, padded to a multiple of 8 x its size).
    Dynamic filtering and split streaming stay off for such a
    fragment."""
    dev = mesh.devices[0] if mesh is not None else resolve_device(device)
    kw = dict(sf=sf, device=dev, limb_form=limb_form, mesh=mesh,
              default_join_capacity=default_join_capacity,
              split_rows=split_rows, hbm_budget_bytes=hbm_budget_bytes,
              session=session, memory_pool=memory_pool, query_id=query_id,
              scan_ranges=scan_ranges, remote_sources=remote_sources)
    fragment = bool(scan_ranges) or bool(remote_sources)
    inner = root.source if isinstance(root, N.OutputNode) else root
    if isinstance(inner, N.WRITE_ROOTS):
        _check_access(root, session)
        return _run_write_root(inner, **kw)
    if not prepared:
        root = prepare_plan(root, sf, session=session, mesh=mesh)
    _check_access(root, session)
    stats: Dict[str, float] = {}
    if split_rows is not None and mesh is None and not fragment:
        res = _run_split(root, sf, dev, limb_form, split_rows,
                         hbm_budget_bytes, session, stats)
        if res is not None:
            return res
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
    if memory_pool is not None:
        # admission: the planned scan bytes are charged before anything
        # is staged, so a refusal comes before the device runs out
        pad = _PAD * (mesh.size if mesh is not None else 1)
        reserved = sum(planned_scan_bytes(
            s, sf, pad, (scan_ranges or {}).get(s.id), remote_sources)
            for s in compile_plan(root).scan_nodes)
        memory_pool.reserve(query_id, reserved)
        stats["reserved_bytes"] = reserved
    try:
        t0 = time.perf_counter()
        batches = stage_scans(root, sf, dev, dyn_filters, stats, mesh=mesh,
                              scan_ranges=scan_ranges,
                              remote_sources=remote_sources)
        stats["staged_bytes"] = sum(
            batch_bytes(b) for b in (batches if mesh is None else
                                     [w for ws in batches for w in ws]))
        t1 = time.perf_counter()
        out, scale, reruns, slot_reruns = _dispatch_ladder(
            root, batches, limb_form, default_join_capacity,
            adaptive=session_flag(session, "adaptive_capacity", True),
            mesh=mesh)
        del batches
        if mesh is not None:
            out = gather_outputs(out, mesh)
            stats["exchange_slot_reruns"] = slot_reruns
        t2 = time.perf_counter()
        res = _batch_to_result(out, root)
        stats.update(scan_stage_s=t1 - t0, execute_s=t2 - t1,
                     fetch_s=time.perf_counter() - t2)
    finally:
        if memory_pool is not None:
            memory_pool.free(query_id, reserved)
            stats["peak_reserved_bytes"] = \
                memory_pool.query_peak_bytes(query_id, pop=True)
    res.stats = {"capacity_reruns": reruns, "capacity_scale": scale, **stats}
    return res


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
