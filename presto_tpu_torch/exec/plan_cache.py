"""Plan fingerprints: the structural identity the profiler, the query
history and EXPLAIN ANALYZE key kernels by.

Counterpart of `plan_fingerprint` in presto_tpu/exec/plan_cache.py,
which must agree with it: a worker of either package keys the same
plan fragment under the same hash, so the cluster-merged /v1/profile
and the history archive fold rows across packages. The rest of the
reference module, the compiled-plan cache itself, waits for ROADMAP
queue 1 item 12.4.

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
from typing import Dict, Tuple

import numpy as np

from ..plan import nodes as N

__all__ = ["plan_fingerprint", "KERNEL_MODE_ENVS"]

# the environment knobs that change how a plan runs without changing its
# fingerprint; the query history salts its baseline key with them, so a
# run under another mode baselines apart (PRESTO_TPU_NARROW: narrow-width
# staging; the two ledger gates leave the result alone but change the
# host work a run pays)
KERNEL_MODE_ENVS: Tuple[Tuple[str, str], ...] = (
    ("PRESTO_TPU_NARROW", "1"),
    ("PRESTO_TPU_PROFILE", "1"),
    ("PRESTO_TPU_TIMELINE", "1"),
)

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
