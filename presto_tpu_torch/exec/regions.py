"""Pipeline regions: a prepared plan cut into the spans that run as one
lowered closure each, with materialised batches between them.

Counterpart of presto_tpu/exec/regions.py (`fusion_enabled`,
`RegionInput`, `PipelineRegion`, `RegionPlan`, `estimate_node_bytes`,
`FusionMemory`, `estimate_region_bytes`, `partition_regions`), with the
reference's partition and its seam laws:

  * scan, values and remote-source leaves are region INPUTS, never
    regions;
  * a plan on a mesh is always one region (its REMOTE exchanges move
    rows between the workers inside one lowered plan);
  * the streaming and spill executors (exec/streaming.py, exec/spill.py)
    take over before partitioning, and a write root is never cut: its
    inner SELECT is partitioned when the writer re-enters run_query.

In the reference a region is ONE XLA program. In the port it is one
closure of exec/planner.py::compile_plan, run through the compiled-plan
cache between two materialised `Batch` handoffs that stay on the card;
the closure launches its operators' kernels one by one as it always
does. With fusion on and nothing refused, the plan is one region whose
root is the plan itself: exactly the whole-plan closure run_query
lowers without regions, under the plan's own fingerprint. With
`fusion=false` (or PRESTO_TPU_FUSION=0) every operator is a region of
its own, the reference's A/B and bisection mode.

The torch counterpart of "one program" would be a CUDA graph captured
per region (or per batch template, exec/batching.py), replayed without
the host enqueuing each launch. It is not taken here: the port's
operators read flags and sizes on the host at places (the hash-slot
group-by's exit flag, the capacity ladder's flag read), which a capture
forbids, and what a graph would save is not measured yet; ROADMAP lists
it as a lever to measure.

Why a region ends: `fused` (it did not), `materialized` (fusion off),
`budget` (the static estimate of the fused span's intermediates exceeds
the session's `kernel_audit_budget_bytes`), `demoted` (the profiler's
device spans showed the fused span slower than the same span run
materialised, by the perfgate band, exec/perfgate.py), `footprint` (a
measured footprint over the budget), `mesh`. The measured footprint
is the kernel audit's K005 estimate (audit/passes/footprint.py): with
`kernel_audit` on, the runner feeds each audited fused span's peak
through `FusionMemory.note_footprint`, and a span over the budget is
refused on its next submission.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional

from ..plan import nodes as N
from .perfgate import MetricSpec, compare
from ..utils.locks import OrderedLock

__all__ = ["FUSION_ENV", "fusion_enabled", "RegionInput", "PipelineRegion",
           "RegionPlan", "partition_regions", "fusion_memory",
           "FusionMemory", "estimate_node_bytes", "estimate_region_bytes"]

FUSION_ENV = "PRESTO_TPU_FUSION"

_LEAF_TYPES = (N.TableScanNode, N.ValuesNode, N.RemoteSourceNode)


def fusion_enabled(session) -> bool:
    """Session property `fusion`; the process default from
    PRESTO_TPU_FUSION (on), one of exec/plan_cache.py's
    KERNEL_MODE_ENVS."""
    import os
    env_on = os.environ.get(FUSION_ENV, "1") not in ("0", "", "false")
    from ..utils.config import session_flag
    return session_flag(session, "fusion", env_on)


@dataclasses.dataclass
class RegionInput:
    """One positional input of a region's closure, in compile_plan's
    scan order. kind "scan": `node` is the original plan's leaf (its
    staged batch, by identity); kind "region": the output batch of
    region `region`, upstream."""
    kind: str
    node: Optional[N.PlanNode] = None
    region: int = -1


@dataclasses.dataclass
class PipelineRegion:
    """One span of the plan, lowered to one closure."""
    index: int
    root: N.PlanNode           # a standalone subtree (cuts: RemoteSource)
    inputs: List[RegionInput]  # positional, compile_plan's scan order
    span: str                  # the node chain (provenance surfaces)
    ops: int                   # operators in the span (non-leaf nodes)
    reason: str                # why the region ends where it does
    est_peak_bytes: int        # static estimate of its intermediates

    @property
    def tag(self) -> str:
        return f"R{self.index}"


@dataclasses.dataclass
class RegionPlan:
    root: N.PlanNode
    regions: List[PipelineRegion]   # producers first
    node_region: Dict[int, int]     # id(original node) -> region index
    fused: bool                     # fusion was in force


def _row_width_bytes(types) -> int:
    """Bytes a row of a node's output takes at the logical widths, the
    active and null lanes included (runner.planned_scan_bytes's
    arithmetic)."""
    per_row = 1  # active mask
    for ty in types:
        if ty.is_string:
            per_row += (ty.max_length if ty.max_length < 1 << 20 else 64) + 5
        elif ty.is_decimal and not ty.is_short_decimal:
            per_row += 17  # Int128 lanes: hi, lo and null
        else:
            try:
                per_row += ty.to_dtype().itemsize + 1
            except Exception:  # noqa: BLE001 - an exotic logical type
                per_row += 9
    return per_row


def estimate_node_bytes(node: N.PlanNode, sf: float) -> int:
    """Static estimate of one operator's materialised output: the
    planner's row estimate times the logical row width (the widest
    input's rows where the node has no estimate)."""
    from ..plan.stats import estimate_rows
    try:
        rows = estimate_rows(node, sf)
    except Exception:  # noqa: BLE001 - estimates are best-effort
        rows = None
    if rows is None:
        for s in node.sources:
            try:
                child = estimate_rows(s, sf)
            except Exception:  # noqa: BLE001
                child = None
            if child is not None:
                rows = max(rows or 0.0, child)
    if rows is None:
        rows = 1024.0
    try:
        width = _row_width_bytes(node.output_types())
    except Exception:  # noqa: BLE001 - aggregation state types etc.
        width = 64
    return int(rows) * width


class FusionMemory:
    """What the process measured per region fingerprint
    (exec/plan_cache.py::plan_fingerprint of the region's root), the
    input of the fusion choice:

      * `note_footprint`: a measured peak of a fused span's
        intermediates (max over notes), preferred to the static
        estimate when refusing over-budget fusions;
      * `note_fused` / `note_unfused`: per-run device microseconds of
        the fused span and of the same span run materialised (the
        runner notes the second under the fingerprint the span fuses
        to, so the pair compares like with like);
      * `maybe_demote`: perfgate's band comparison of the two medians;
        a demoted span is cut at every operator until the process
        restarts or `clear()`.

    Bounded maps of bounded sample windows, under one lock."""

    # tpulint C001: the runner's hot path appends samples from every
    # dispatch thread; the partitioner reads across them
    _GUARDED_BY = {"_lock": ("_footprint", "_fused", "_unfused",
                             "_demoted")}

    _WINDOW = 16
    _MAX_KEYS = 512
    # device time regresses upward; a fused span must lose to its
    # materialised form by more than noise and 10% before it demotes,
    # and spans under 200 us never demote (dispatch jitter rules them)
    SPEC = MetricSpec("region_device_us", higher_is_worse=True,
                      rel_threshold=0.10, abs_floor=200.0, mad_k=5.0)
    MIN_SAMPLES = 3

    def __init__(self):
        self._lock = OrderedLock("regions.FusionMemory._lock")
        self._footprint: "collections.OrderedDict[str, int]" = \
            collections.OrderedDict()
        self._fused: "collections.OrderedDict[str, collections.deque]" = \
            collections.OrderedDict()
        self._unfused: "collections.OrderedDict[str, collections.deque]" = \
            collections.OrderedDict()
        self._demoted: Dict[str, str] = {}

    def _bump(self, table, key, value) -> None:
        q = table.get(key)
        if q is None:
            q = table[key] = collections.deque(maxlen=self._WINDOW)
            while len(table) > self._MAX_KEYS:
                table.popitem(last=False)
        else:
            table.move_to_end(key)
        q.append(float(value))

    def note_footprint(self, fingerprint: str, peak_bytes: int) -> None:
        with self._lock:
            have = self._footprint.get(fingerprint, 0)
            self._footprint[fingerprint] = max(have, int(peak_bytes))
            self._footprint.move_to_end(fingerprint)
            while len(self._footprint) > self._MAX_KEYS:
                self._footprint.popitem(last=False)

    def footprint(self, fingerprint: str) -> int:
        with self._lock:
            return self._footprint.get(fingerprint, 0)

    def note_fused(self, fingerprint: str, device_us: int) -> None:
        with self._lock:
            self._bump(self._fused, fingerprint, device_us)

    def note_unfused(self, fingerprint: str, device_us: int) -> None:
        with self._lock:
            self._bump(self._unfused, fingerprint, device_us)

    def demoted(self, fingerprint: str) -> Optional[str]:
        with self._lock:
            return self._demoted.get(fingerprint)

    def demote(self, fingerprint: str, reason: str) -> None:
        with self._lock:
            self._demoted[fingerprint] = reason
            while len(self._demoted) > self._MAX_KEYS:
                self._demoted.pop(next(iter(self._demoted)))

    def maybe_demote(self, fingerprint: str) -> Optional[dict]:
        """Hold the fused span's samples against the materialised ones;
        past the band, demote and return the verdict (else None)."""
        with self._lock:
            if fingerprint in self._demoted:
                return None
            fused = list(self._fused.get(fingerprint) or ())
            base = list(self._unfused.get(fingerprint) or ())
        if len(fused) < self.MIN_SAMPLES or len(base) < self.MIN_SAMPLES:
            return None
        from .perfgate import median
        verdict = compare(median(fused), base, self.SPEC)
        if verdict is None:
            return None
        self.demote(fingerprint, f"device_us {verdict['value']:.0f} vs "
                                 f"materialized median {verdict['median']:.0f}"
                                 f" (band {verdict['band']:.0f})")
        return verdict

    def snapshot(self) -> dict:
        with self._lock:
            return {"demoted": dict(self._demoted),
                    "footprints": dict(self._footprint),
                    "fused_keys": len(self._fused),
                    "unfused_keys": len(self._unfused)}

    def clear(self) -> None:
        with self._lock:
            self._footprint.clear()
            self._fused.clear()
            self._unfused.clear()
            self._demoted.clear()


def estimate_region_bytes(region: PipelineRegion, sf: float = 0.01) -> int:
    """Static estimate of a region's intermediates, computed when asked
    (partitioning walks the estimates only under a budget)."""
    if region.est_peak_bytes:
        return region.est_peak_bytes
    total = 0

    def walk(n):
        nonlocal total
        if not isinstance(n, _LEAF_TYPES):
            total += estimate_node_bytes(n, sf)
        for s in n.sources:
            walk(s)

    walk(region.root)
    return total


_MEMORY = FusionMemory()


def fusion_memory() -> FusionMemory:
    return _MEMORY


def _audit_budget(session) -> int:
    """The session's `kernel_audit_budget_bytes` (0: no budget)."""
    from ..utils.config import session_value
    try:
        return int(session_value(session, "kernel_audit_budget_bytes", 0)
                   or 0)
    except (TypeError, ValueError):
        return 0


def partition_regions(root: N.PlanNode, *, session=None, sf: float = 0.01,
                      mesh=None, force_per_op: bool = False) -> RegionPlan:
    """Cut a PREPARED plan into pipeline regions (module docstring).
    Deterministic for one (plan, session, kernel mode, FusionMemory
    state)."""
    fused = fusion_enabled(session) and not force_per_op
    single = mesh is not None
    per_op = not fused and not single
    budget = _audit_budget(session) if not single else 0

    regions: List[PipelineRegion] = []
    node_region: Dict[int, int] = {}
    carved: Dict[int, int] = {}     # id(original subtree root) -> region
    est_memo: Dict[int, int] = {}

    def est(n: N.PlanNode) -> int:
        if id(n) not in est_memo:
            est_memo[id(n)] = estimate_node_bytes(n, sf)
        return est_memo[id(n)]

    def carve(n: N.PlanNode, materialize_root: bool = False,
              cause: str = "") -> int:
        """Carve the region that produces `n`'s output; its index.
        `materialize_root` re-carves a demoted or refused span: `n` runs
        alone (`cause` says why) and its children fuse on their own."""
        if id(n) in carved and not materialize_root:
            return carved[id(n)]

        nodes: List[N.PlanNode] = []
        inputs: List[RegionInput] = []
        seen_leaves: Dict[int, None] = {}
        est_sum = [0]
        reasons: List[str] = []

        def absorb(parent: N.PlanNode, m: N.PlanNode) -> bool:
            """Whether the child chain `m` fuses into `parent`'s
            region."""
            if single:
                return True
            if isinstance(parent, N.OutputNode):
                return True  # a rename, never a region of its own
            if isinstance(m, N.ExchangeNode):
                # the identity on one device: it rides with its
                # consumer, and its child decides the cut
                return True
            if materialize_root or per_op:
                return False
            if budget > 0 and est_sum[0] + est(m) > budget:
                reasons.append("budget")
                return False
            return True

        def rebuild(m: N.PlanNode) -> N.PlanNode:
            nodes.append(m)
            node_region[id(m)] = len(regions)  # provisional; fixed below
            if budget > 0:
                est_sum[0] += est(m)
            new_sources: List[N.PlanNode] = []
            changed = False
            for c in m.sources:
                if isinstance(c, _LEAF_TYPES):
                    if id(c) not in seen_leaves:
                        seen_leaves[id(c)] = None
                        inputs.append(RegionInput("scan", node=c))
                    new_sources.append(c)
                    continue
                if id(c) in rebuilt:
                    new_sources.append(rebuilt[id(c)])
                    changed = changed or rebuilt[id(c)] is not c
                    continue
                if absorb(m, c):
                    rc = rebuild(c)
                    rebuilt[id(c)] = rc
                    new_sources.append(rc)
                    changed = changed or rc is not c
                    continue
                # a cut: the child chain is a region of its own,
                # upstream, and this region reads its output batch
                src_region = carve(c)
                leaf = N.RemoteSourceNode(types=c.output_types())
                rebuilt[id(c)] = leaf
                inputs.append(RegionInput("region", region=src_region))
                new_sources.append(leaf)
                changed = True
            if not changed:
                return m
            from ..plan.rules import _replace_sources
            return _replace_sources(m, new_sources)

        rebuilt: Dict[int, N.PlanNode] = {}
        region_root = rebuild(n)

        # a fused span the profiler demoted, or whose measured
        # footprint exceeds the budget, is re-carved materialised
        if fused and not single and not materialize_root and len(nodes) > 1:
            from .plan_cache import plan_fingerprint
            region_fp = plan_fingerprint(region_root)
            why = _MEMORY.demoted(region_fp)
            if why is None and budget > 0 and \
                    _MEMORY.footprint(region_fp) > budget:
                why = "footprint"
            if why is not None:
                return carve(n, materialize_root=True,
                             cause=("footprint" if why == "footprint"
                                    else "demoted"))

        idx = len(regions)
        for m in nodes:
            node_region[id(m)] = idx
        from .profiler import plan_label
        reason = ("mesh" if single else
                  (cause or "materialized")
                  if (per_op or materialize_root) else
                  "+".join(sorted(set(reasons))) or "fused")
        regions.append(PipelineRegion(
            index=idx, root=region_root, inputs=inputs,
            span=plan_label(region_root, max_len=120), ops=len(nodes),
            reason=reason, est_peak_bytes=est_sum[0]))
        carved[id(n)] = idx
        return idx

    carve(root)
    return RegionPlan(root=root, regions=regions,
                      node_region=node_region, fused=fused)
