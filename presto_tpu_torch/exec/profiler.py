"""Continuous per-kernel profiler: device time attributed to compiled
kernels, always on.

Counterpart of presto_tpu/exec/profiler.py: the same rows, merge law
and documents. A kernel here is one plan's execution: its device time
(``device_us``) is the dispatch span of the plan's dispatches, the
stream time between a CUDA event pair around each (the host wall on
the CPU), less the compile seconds the dispatch paid. The span holds
the stream idling while the host enqueues the plan's launches, so it
bounds the work on the card from above. Rows are keyed by
exec/plan_cache.py::plan_fingerprint, which gives the reference's hash
for the same plan JSON.

Each entry accumulates calls, device time, rows/bytes in and out,
retrace count (runs that paid a kernel build: the port lowers every
run's plan afresh, so a lowering marks no cold run) and plan-node provenance (a compact node-chain label +
scanned tables). ``footprint_bytes`` stays 0: it is the reference's
footprint audit (ROADMAP queue 1 item 16).

Surfaces:
  * ``GET /v1/profile`` on a worker: this process's slice
    (:func:`profile_doc`).
  * ``GET /v1/profile`` on the statement tier: cluster-merged
    (:func:`cluster_profile_doc` pulls worker slices and folds them by
    fingerprint; slices are deduplicated by ``processId`` so two
    servers sharing one process -- the test topology -- count once).
  * ``SELECT * FROM system.kernels`` (connectors/system.py).
  * EXPLAIN ANALYZE's "kernels" section and flight-recorder dumps
    (cross-linked by fingerprint via :func:`profile_for_query`).

The registry is process-wide and bounded (LRU on last call). Gating:
session property ``continuous_profiling`` (default on), process env
``PRESTO_TPU_PROFILE``.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import uuid
from typing import Dict, List, Optional


__all__ = ["profiling_enabled", "record_call", "note_footprint",
           "note_query_kernel",
           "profile_snapshot", "profile_doc", "profile_for_query",
           "query_fingerprints", "merge_kernel_rows",
           "cluster_profile_doc",
           "clear_profiler", "set_capacity", "plan_label", "plan_tables",
           "PROFILE_ENV"]

PROFILE_ENV = "PRESTO_TPU_PROFILE"

# one id per process: cluster merges deduplicate slices by it, so a
# coordinator that can see the same process through two server shells
# (in-process test clusters) folds that slice exactly once
_PROCESS_ID = uuid.uuid4().hex


def profiling_enabled(session) -> bool:
    """Session property ``continuous_profiling``; process default from
    PRESTO_TPU_PROFILE (default ON -- continuous means continuous)."""
    import os
    env_on = os.environ.get("PRESTO_TPU_PROFILE", "1") \
        not in ("0", "", "false")
    from ..utils.config import session_flag
    return session_flag(session, "continuous_profiling", env_on)


@dataclasses.dataclass
class KernelProfile:
    """One compiled kernel's accumulated profile. Merges by fingerprint
    with the usual law: sums add, maxes max -- associative and
    commutative, like QueryStats."""
    fingerprint: str
    label: str = ""
    tables: str = ""
    calls: int = 0
    device_us: int = 0
    max_device_us: int = 0
    rows_in: int = 0
    bytes_in: int = 0
    rows_out: int = 0
    bytes_out: int = 0
    retraces: int = 0
    footprint_bytes: int = 0   # a footprint estimate (max seen)
    last_trace_id: str = ""

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, doc: dict) -> "KernelProfile":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in doc.items() if k in known})

    def merge(self, other: "KernelProfile") -> "KernelProfile":
        assert self.fingerprint == other.fingerprint
        return KernelProfile(
            fingerprint=self.fingerprint,
            label=self.label or other.label,
            tables=self.tables or other.tables,
            calls=self.calls + other.calls,
            device_us=self.device_us + other.device_us,
            max_device_us=max(self.max_device_us, other.max_device_us),
            rows_in=self.rows_in + other.rows_in,
            bytes_in=self.bytes_in + other.bytes_in,
            rows_out=self.rows_out + other.rows_out,
            bytes_out=self.bytes_out + other.bytes_out,
            retraces=self.retraces + other.retraces,
            footprint_bytes=max(self.footprint_bytes,
                                other.footprint_bytes),
            last_trace_id=self.last_trace_id or other.last_trace_id)


# -- process registry ----------------------------------------------------

# engine threads (run_query), request handlers (/v1/profile, system
# tables) and the flight recorder all touch the registry
_LOCK = threading.RLock()
_REGISTRY: "collections.OrderedDict[str, KernelProfile]" = \
    collections.OrderedDict()
_MAX_ENTRIES = 512
# query id -> fingerprints it executed (the flight-dump cross-link);
# bounded like the registry
_QUERY_KERNELS: "collections.OrderedDict[str, List[str]]" = \
    collections.OrderedDict()
_QUERY_KERNELS_MAX = 256


def set_capacity(max_entries: int) -> int:
    """Bound the registry (tests exercise eviction); returns the
    previous cap."""
    global _MAX_ENTRIES
    with _LOCK:
        prev = _MAX_ENTRIES
        _MAX_ENTRIES = max(1, int(max_entries))
        while len(_REGISTRY) > _MAX_ENTRIES:
            _REGISTRY.popitem(last=False)
    return prev


def clear_profiler() -> None:
    with _LOCK:
        _REGISTRY.clear()
        _QUERY_KERNELS.clear()


def record_call(fingerprint: str, label: str = "", tables: str = "",
                device_us: int = 0, rows_in: int = 0, bytes_in: int = 0,
                rows_out: int = 0, bytes_out: int = 0,
                retraced: bool = False,
                query_id: Optional[str] = None,
                trace_id: Optional[str] = None) -> None:
    """Fold one executed dispatch into the registry (never raises --
    this runs on the query hot path, right after the device sync)."""
    try:
        with _LOCK:
            p = _REGISTRY.get(fingerprint)
            if p is None:
                p = _REGISTRY[fingerprint] = KernelProfile(fingerprint)
                while len(_REGISTRY) > _MAX_ENTRIES:
                    _REGISTRY.popitem(last=False)
            else:
                _REGISTRY.move_to_end(fingerprint)
            if label and not p.label:
                p.label = label
            if tables and not p.tables:
                p.tables = tables
            p.calls += 1
            p.device_us += int(device_us)
            p.max_device_us = max(p.max_device_us, int(device_us))
            p.rows_in += int(rows_in)
            p.bytes_in += int(bytes_in)
            p.rows_out += int(rows_out)
            p.bytes_out += int(bytes_out)
            if retraced:
                p.retraces += 1
            if trace_id:
                p.last_trace_id = str(trace_id)
            if query_id:
                fps = _QUERY_KERNELS.get(query_id)
                if fps is None:
                    fps = _QUERY_KERNELS[query_id] = []
                    while len(_QUERY_KERNELS) > _QUERY_KERNELS_MAX:
                        _QUERY_KERNELS.popitem(last=False)
                else:
                    _QUERY_KERNELS.move_to_end(query_id)
                if fingerprint not in fps:
                    fps.append(fingerprint)
    except Exception as e:  # noqa: BLE001 - profiling must never fail
        # the query it observes; leave the counted trace
        from ..server.metrics import record_suppressed
        record_suppressed("profiler", "record_call", e)


def note_query_kernel(fingerprint: str, query_ids: List[str]) -> None:
    """Cross-link several query ids to one executed fingerprint in a
    single registry pass -- the batched-dispatch path's attribution
    (record_call folds the dispatch once for the leader; followers
    only need the query->fingerprint edge history/flight dumps read)."""
    with _LOCK:
        for query_id in query_ids:
            fps = _QUERY_KERNELS.get(query_id)
            if fps is None:
                fps = _QUERY_KERNELS[query_id] = []
                while len(_QUERY_KERNELS) > _QUERY_KERNELS_MAX:
                    _QUERY_KERNELS.popitem(last=False)
            else:
                _QUERY_KERNELS.move_to_end(query_id)
            if fingerprint not in fps:
                fps.append(fingerprint)


def note_footprint(fingerprint: str, peak_bytes: int) -> None:
    """Attach an intermediate-footprint estimate to a
    kernel (max across audits; creates the entry so an audited-but-not-
    yet-dispatched kernel is visible too)."""
    with _LOCK:
        p = _REGISTRY.get(fingerprint)
        if p is None:
            p = _REGISTRY[fingerprint] = KernelProfile(fingerprint)
            while len(_REGISTRY) > _MAX_ENTRIES:
                _REGISTRY.popitem(last=False)
        p.footprint_bytes = max(p.footprint_bytes, int(peak_bytes))


def profile_snapshot(top: Optional[int] = None) -> List[dict]:
    """Registry snapshot as JSON rows, hottest (total device time)
    first."""
    with _LOCK:
        rows = [dataclasses.replace(p) for p in _REGISTRY.values()]
    rows.sort(key=lambda p: (-p.device_us, p.fingerprint))
    if top is not None:
        rows = rows[:top]
    return [p.to_json() for p in rows]


def profile_for_query(query_id: str, top: Optional[int] = None
                      ) -> List[dict]:
    """The kernels a query id executed, cross-linked by fingerprint to
    their CURRENT registry rows (the flight-dump embed)."""
    with _LOCK:
        fps = list(_QUERY_KERNELS.get(query_id, ()))
        rows = [dataclasses.replace(_REGISTRY[fp]) for fp in fps
                if fp in _REGISTRY]
    rows.sort(key=lambda p: (-p.device_us, p.fingerprint))
    if top is not None:
        rows = rows[:top]
    return [p.to_json() for p in rows]


def query_fingerprints(query_id: str) -> List[str]:
    """The plan fingerprints a query id dispatched, in execution
    order (the query-history archive's plan identity; a write query's
    inner SELECT contributes its own fingerprint too)."""
    with _LOCK:
        return list(_QUERY_KERNELS.get(query_id, ()))


def profile_doc() -> dict:
    """This process's /v1/profile slice."""
    return {"processId": _PROCESS_ID, "kernels": profile_snapshot()}


def merge_kernel_rows(docs: List[dict]) -> List[dict]:
    """Fold per-process slices into one per-kernel table. Input docs
    are /v1/profile documents; slices sharing a processId are counted
    once (two server shells over one process report the same
    registry). Order-independent by KernelProfile.merge's law."""
    seen_processes = set()
    merged: Dict[str, KernelProfile] = {}
    for doc in docs:
        pid = doc.get("processId") or f"anon-{id(doc):x}"
        if pid in seen_processes:
            continue
        seen_processes.add(pid)
        for row in doc.get("kernels") or ():
            p = KernelProfile.from_json(row)
            if not p.fingerprint:
                continue
            have = merged.get(p.fingerprint)
            merged[p.fingerprint] = have.merge(p) if have else p
    out = sorted(merged.values(),
                 key=lambda p: (-p.device_us, p.fingerprint))
    return [p.to_json() for p in out]


def cluster_profile_doc(worker_urls=(), timeout: float = 3.0) -> dict:
    """The coordinator-side merge: this process's slice plus every
    reachable worker's ``GET /v1/profile``, folded by fingerprint.
    Pulls ride the shared best-effort helper
    (server/client.pull_worker_docs) so the internal bearer/TLS/trace
    headers -- and the skip-and-count-dead-workers contract -- stay
    identical to the history merge's."""
    from ..server.client import pull_worker_docs
    pulled, workers_seen = pull_worker_docs(
        worker_urls, timeout, lambda c: c.profile(), "profiler")
    docs = [profile_doc(), *pulled]
    return {"processId": _PROCESS_ID, "cluster": True,
            "workersPulled": workers_seen,
            "kernels": merge_kernel_rows(docs)}


# -- plan provenance -----------------------------------------------------


def plan_label(root, max_len: int = 160) -> str:
    """Compact plan-node provenance for a fingerprint: the node-type
    chain in DFS preorder with scan tables inlined, capped."""
    parts: List[str] = []

    def walk(n, depth):
        if len(parts) > 24:
            return
        name = type(n).__name__.replace("Node", "")
        table = getattr(n, "table", None)
        conn = getattr(n, "connector", None)
        if table and conn:
            name += f"[{conn}.{table}]"
        step = getattr(n, "step", None)
        if step and name.startswith("Aggregation"):
            name += f"({step})"
        parts.append(name)
        for s in getattr(n, "sources", ()):
            walk(s, depth + 1)

    walk(root, 0)
    label = " > ".join(parts)
    return label[:max_len]


def plan_tables(root) -> str:
    """Comma-joined connector.table list of a plan's scans."""
    out: List[str] = []

    def walk(n):
        table = getattr(n, "table", None)
        conn = getattr(n, "connector", None)
        if table and conn and f"{conn}.{table}" not in out:
            out.append(f"{conn}.{table}")
        for s in getattr(n, "sources", ()):
            walk(s)

    walk(root)
    return ",".join(out)
