"""Compiled-plan cache and plan fingerprints.

Counterpart of presto_tpu/exec/plan_cache.py: `plan_fingerprint`, the
structural identity the profiler, the query history, EXPLAIN ANALYZE
and the cache key plans by, and the compiled-plan cache itself
(`cached_compile`, `cache_stats`, `clear_plan_cache`). The fingerprint
must agree with the reference's: a worker of either package keys the
same plan fragment under the same hash, so the cluster-merged
/v1/profile and the history archive fold rows across packages.

What the port caches is not an XLA executable: `compile_plan` lowers a
plan to a Python closure over the staged batches (exec/planner.py),
and the cache keeps that CompiledPlan with a per-entry dispatch lock,
keyed as the reference keys its executables: (fingerprint, mesh, join
capacity where it can change the lowering, exchange slot scale, kernel
mode), plus the port's two lowering inputs the reference has no
counterpart for, the limb form and which node ids the plan shares (the
reference's fingerprint marks a shared subtree with a back-reference;
the port's hashes it in full, see below). Repeat submissions of a
structurally identical plan reuse the closure; the runner charges the
compile stage only on a miss. The closure keeps no state from one call
to the next, so the serial ladder calls it without the lock; the
batched dispatch (exec/batching.py) holds it while it runs a batch's
members back to back.

The hash walks node types and dataclass fields in traversal order,
node ids excluded (two plannings of one statement differ only in
ids), as the reference does. Two rules make it agree with the
reference on a plan read from the same JSON:

  * a node that appears twice under one root is hashed in full both
    times. The port's `from_json` reads a repeated node id as one
    shared node, where the reference's builds a copy per appearance;
    hashed as a tree, both readings give one hash.
  * a field of the port's that the reference's node lacks
    (`UnnestNode.capacity_factor`) is hashed only when it is not at
    its default, where the two plans differ anyway.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np

from ..plan import nodes as N
from .planner import CompiledPlan, compile_plan
from ..utils.locks import OrderedLock

__all__ = ["plan_fingerprint", "cached_compile", "cache_stats",
           "clear_plan_cache", "KERNEL_MODE_ENVS"]

# the environment knobs that change how a plan runs without changing its
# fingerprint: every one is part of each cache key, and the query
# history salts its baseline key with them, so a run under another mode
# baselines apart (PRESTO_TPU_NARROW: narrow-width staging; the two
# ledger gates leave the result alone but change the host work a run
# pays; PRESTO_TPU_FUSION: exec/regions.py, which regions a plan is cut
# into; PRESTO_TPU_KERNEL_AUDIT: audit/staged.py, which keys its memo
# with this mode, so clearing the cache and the memo stay in step;
# PRESTO_TPU_BATCHING: exec/batching.py, part of every batch key;
# PRESTO_TPU_DONATION: exec/donation.py, which hands a region its dead
# inputs)
KERNEL_MODE_ENVS: Tuple[Tuple[str, str], ...] = (
    ("PRESTO_TPU_NARROW", "1"),
    ("PRESTO_TPU_FUSION", "1"),
    ("PRESTO_TPU_KERNEL_AUDIT", "0"),
    ("PRESTO_TPU_PROFILE", "1"),
    ("PRESTO_TPU_BATCHING", "1"),
    ("PRESTO_TPU_DONATION", "0"),
    ("PRESTO_TPU_TIMELINE", "1"),
)

_MAX_ENTRIES = 64

_lock = OrderedLock("plan_cache._lock")
_cache: "OrderedDict[tuple, _Entry]" = OrderedDict()
_hits = 0
_misses = 0


@dataclasses.dataclass
class _Entry:
    plan: CompiledPlan
    call_lock: OrderedLock

# port-only dataclass fields -> the default at which the reference's
# node (which lacks the field) hashes the same
_PORT_ONLY_FIELDS: Dict[Tuple[str, str], object] = {
    ("UnnestNode", "capacity_factor"): 1,
}


def plan_fingerprint(root: N.PlanNode) -> str:
    """Deterministic structural hash of a plan tree (ids excluded)."""
    parts: list = []

    def emit(v):
        if isinstance(v, N.PlanNode):
            walk(v)
        elif isinstance(v, (list, tuple)):
            parts.append("[")
            for x in v:
                emit(x)
            parts.append("]")
        elif isinstance(v, np.ndarray):
            # repr truncates large arrays: hash the raw bytes instead
            parts.append(f"nd:{v.dtype}:{v.shape}:"
                         f"{hashlib.sha256(v.tobytes()).hexdigest()}")
        else:
            parts.append(repr(v))

    def walk(n):
        kind = type(n).__name__
        parts.append(kind)
        for f in dataclasses.fields(n):
            if f.name == "id":
                continue
            v = getattr(n, f.name)
            key = (kind, f.name)
            if key in _PORT_ONLY_FIELDS and v == _PORT_ONLY_FIELDS[key]:
                continue
            parts.append(f.name)
            emit(v)

    walk(root)
    return hashlib.sha256("|".join(parts).encode()).hexdigest()


def _mesh_key(mesh) -> Optional[tuple]:
    if mesh is None:
        return None
    return (mesh.axis_name, mesh.size, tuple(str(d) for d in mesh.devices))


def _kernel_mode() -> str:
    """The cache-key component built from KERNEL_MODE_ENVS."""
    import os
    return "|".join(os.environ.get(name, default)
                    for name, default in KERNEL_MODE_ENVS)


def _capacity_sensitive(root: N.PlanNode) -> bool:
    """Whether `default_join_capacity` can change this plan's lowering:
    the only site that reads it is a JoinNode without an out_capacity
    (exec/planner.py), so join-free plans, and plans whose joins all
    carry capacities, lower identically under every default and are
    keyed apart from it."""
    seen: set = set()

    def walk(n) -> bool:
        if id(n) in seen:  # a shared subtree once
            return False
        seen.add(id(n))
        if isinstance(n, N.JoinNode) and n.out_capacity is None:
            return True
        return any(walk(s) for s in n.sources)
    return walk(root)


def _sharing_key(root: N.PlanNode) -> Tuple[int, ...]:
    """Which nodes the plan shares, by node id in preorder (-1 a first
    visit, k a second visit of the k-th node): compile_plan runs a
    shared id once and takes one batch per distinct leaf, so two plans
    of one fingerprint that share differently lower differently."""
    seen: Dict[str, int] = {}
    out = []

    def walk(n):
        if n.id in seen:
            out.append(seen[n.id])
            return
        seen[n.id] = len(seen)
        out.append(-1)
        for s in n.sources:
            walk(s)
    walk(root)
    return tuple(out)


def cached_compile(root: N.PlanNode, mesh=None,
                   default_join_capacity: int = 1 << 16,
                   exchange_slot_scale: int = 1, limb_form: str = "narrow"
                   ) -> Tuple[CompiledPlan, OrderedLock, bool]:
    """(CompiledPlan, per-entry dispatch lock, hit) for this plan,
    lowering it at most once per key. The batches a cached closure
    takes are positional (compile_plan's scan order), so it runs any
    plan of its key."""
    global _hits, _misses
    cap_key = default_join_capacity if _capacity_sensitive(root) else None
    key = (plan_fingerprint(root), _mesh_key(mesh), cap_key,
           exchange_slot_scale, _kernel_mode(), limb_form,
           _sharing_key(root))
    with _lock:
        entry = _cache.get(key)
        if entry is not None:
            _cache.move_to_end(key)
            _hits += 1
            return entry.plan, entry.call_lock, True
        _misses += 1
    plan = compile_plan(root, limb_form, default_join_capacity, mesh=mesh,
                        exchange_slot_scale=exchange_slot_scale)
    entry = _Entry(plan, OrderedLock("plan_cache._Entry.call_lock"))
    with _lock:
        have = _cache.get(key)
        if have is not None:  # lost a race: keep the first
            return have.plan, have.call_lock, False
        _cache[key] = entry
        while len(_cache) > _MAX_ENTRIES:
            _cache.popitem(last=False)
    return entry.plan, entry.call_lock, False


def cache_stats() -> dict:
    with _lock:
        return {"entries": len(_cache), "hits": _hits, "misses": _misses}


def clear_plan_cache() -> None:
    """Drop every entry and zero the counts, and the kernel-audit memo
    (audit/staged.py), which keys on the same identity: a cleared
    cache means the next submission lowers afresh, and re-audits."""
    global _hits, _misses
    with _lock:
        _cache.clear()
        _hits = 0
        _misses = 0
    from ..audit.staged import clear_audit_memo
    clear_audit_memo()
