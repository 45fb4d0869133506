"""C002: whole-program lock-acquisition-order graph, cycle = finding.

Counterpart of presto_tpu/lint/passes/lock_order.py over the port's
files. Two threads acquiring the same two locks in opposite orders is
the deadlock that only fires under load. This pass builds the
acquisition-order graph statically (lint/lockmodel.py: ``with``
nesting, ``*_locked`` conventions, call edges resolved through
class-attribute lock identities) over the server tier, failpoints and
the threaded exec/ modules, and reports every cycle with both
participating acquisition paths. The message is the reference's, word
for word, so the two packages' findings fingerprint alike.

The acyclic graph itself is the port's committed artifact,
``presto_tpu_torch/lint/LOCK_ORDER.json``, regenerated and gated by
``python -m presto_tpu_torch.lint.lockgraph``. The runtime complement
is utils/locks.py's witness: same node identities, checked at acquire
time.

Fixture files outside the target set are analyzed standalone; target
files share ONE memoized whole-program graph, and each cycle is
reported in the file anchoring its first edge.
"""

from __future__ import annotations

import os
from typing import Dict, List

from ..core import REPO, Finding, LintPass, ModuleSource, register
from ..lockmodel import LockProgram, build_program

__all__ = ["LockOrderPass", "program_for_targets", "CONCURRENCY_TARGETS"]

# the concurrency-audit surface: server tier, failpoints, and the
# exec/ modules whose registries are shared across request-handler,
# runner, and service threads (one list, shared by C002/C003/C004)
CONCURRENCY_TARGETS = (
    "presto_tpu_torch/server/*.py",
    "presto_tpu_torch/failpoints/*.py",
    "presto_tpu_torch/exec/progress.py",
    "presto_tpu_torch/exec/batching.py",
    "presto_tpu_torch/exec/profiler.py",
    "presto_tpu_torch/exec/plan_cache.py",
    "presto_tpu_torch/exec/regions.py",
    "presto_tpu_torch/exec/datapath.py",
    "presto_tpu_torch/exec/accuracy.py",
    "presto_tpu_torch/exec/timeline.py",
    "presto_tpu_torch/utils/locks.py",
)

_PROGRAM_CACHE: Dict[tuple, LockProgram] = {}


def program_for_targets(files: List[str], repo: str = REPO
                        ) -> LockProgram:
    """The memoized whole-program lock model over `files` (repo-
    relative), keyed by path+mtime so one CLI run builds it once and
    an edited file invalidates it."""
    key_parts = []
    for rel in sorted(files):
        ap = os.path.join(repo, rel)
        try:
            key_parts.append((rel, os.path.getmtime(ap)))
        except OSError:
            key_parts.append((rel, 0.0))
    key = (repo, tuple(key_parts))
    prog = _PROGRAM_CACHE.get(key)
    if prog is None:
        sources = [ModuleSource(rel, repo) for rel in sorted(set(files))]
        prog = build_program(sources)
        _PROGRAM_CACHE.clear()  # one live entry; edits invalidate
        _PROGRAM_CACHE[key] = prog
    return prog


def _cycle_findings(ms: ModuleSource, prog: LockProgram,
                    only_this_file: bool) -> List[Finding]:
    findings: List[Finding] = []
    for cyc in prog.cycles():
        ring = cyc + [cyc[0]]
        evidence = []
        for a, b in zip(ring, ring[1:]):
            ev = prog.edges.get((a, b), {})
            via = f" via {ev['via']}" if ev.get("via") else ""
            evidence.append((ev, f"{b} under {a} in "
                                 f"{ev.get('context', '?')}{via}"))
        anchor = evidence[0][0]
        if only_this_file and anchor.get("file") != ms.rel_path:
            continue
        msg = (f"lock-order cycle: {' -> '.join(ring)} "
               f"({'; '.join(e for _, e in evidence)}) -- potential "
               f"deadlock; see scripts/lockgraph.py for the full graph")
        findings.append(Finding(
            code="C002", path=ms.rel_path,
            line=int(anchor.get("line", 0)), col=0,
            context=anchor.get("context", "<module>"), message=msg))
    return findings


@register
class LockOrderPass(LintPass):
    code = "C002"
    name = "lock-order-graph"
    description = ("cycles in the whole-program lock-acquisition-order "
                   "graph (potential deadlocks)")
    TARGETS = CONCURRENCY_TARGETS

    def run(self, ms: ModuleSource) -> List[Finding]:
        targets = self.target_files()
        if ms.rel_path in targets:
            prog = program_for_targets(targets)
            return _cycle_findings(ms, prog, only_this_file=True)
        # standalone file (fixture corpus): self-contained graph
        prog = build_program([ms])
        return _cycle_findings(ms, prog, only_this_file=False)
