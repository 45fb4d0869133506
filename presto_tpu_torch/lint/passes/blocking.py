"""C003: blocking operations under a held lock.

Counterpart of presto_tpu/lint/passes/blocking.py over the port's
files, with ``ALLOWED`` keyed by the port's paths.

A lock held across a blocking operation turns one slow dependency into
a tier-wide stall: every thread that touches the lock queues behind
the blocked holder -- /v1/metrics scrapes behind a disk write, task
status polls behind an HTTP hop, admission behind a device sync. The
repo has paid for this twice at review time (PR 9 moved JSONL
persistence off the archive lock; PR 12's drain_status discipline
fix); this pass catches the class mechanically.

Catalog of blocking operations (lint/lockmodel._blocking_kind):

  * ``time.sleep`` / ``*.sleep`` (Backoff.sleep included)
  * ``Thread.join`` / ``Future.result`` (shape-discriminated from
    ``str.join`` / ``os.path.join``)
  * HTTP: ``urlopen``, ``getresponse``, any ``client.*`` method
    (WorkerClient/StatementClient), the worker-doc pull helpers
  * file/socket I/O: ``open``/``fdopen``/``mkstemp``, writes/reads on
    handles opened in the same function or on ``wfile``/``rfile``/
    socket receivers, ``json.dump``, ``subprocess.*``
  * waiting on a *different* lock/condition than every held one
    (``.wait()``/``.acquire()``; waiting on your own ``with``-held
    condition is the normal cv idiom and exempt)
  * device syncs: ``block_until_ready``, torch's ``synchronize``

A finding fires when a blocking op executes lexically under a ``with
<lock>:`` (or inside a ``*_locked`` function -- the caller holds the
lock), or when a call made under a RESOLVED lock reaches a function
whose transitive closure contains a blocking op (so the indirection of
one helper doesn't hide the stall).

Deliberately-held cases go in ``ALLOWED`` below with a reason -- the
visible allowlist idiom, mirroring W001's per-module whitelists -- or
carry an inline ``# tpulint: disable=C003`` at the site.
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

from ..core import Finding, LintPass, ModuleSource, register
from ..lockmodel import build_program
from .lock_order import CONCURRENCY_TARGETS, program_for_targets

__all__ = ["BlockingUnderLockPass", "ALLOWED"]

# (rel_path, context, detail) -> reason. The deliberate exceptions,
# each with its justification in the value (rendered nowhere -- the
# reason lives here, next to the exemption, reviewable in one place).
ALLOWED: Dict[Tuple[str, str, str], str] = {
    # The archive's JSONL persistence runs under a DEDICATED persistence
    # lock whose only job is to serialize file appends/reloads --
    # /v1/metrics and /v1/history readers take _lock, never _plock, so
    # a slow disk stalls only other writers. Holding I/O under _plock
    # is the design, not the bug. The key is (path, context, detail),
    # so one entry covers every `open` of the context: `load` opens the
    # newest ring file twice under _plock, once to count its lines and
    # once to terminate a torn tail, both the reload the lock excludes
    # appends from.
    ("presto_tpu_torch/server/history.py", "QueryHistoryArchive._persist",
     "open"): "dedicated persistence lock: its entire critical "
              "section IS the file append; readers ride _lock",
    ("presto_tpu_torch/server/history.py", "QueryHistoryArchive.load",
     "open"): "dedicated persistence lock: reload must exclude "
              "concurrent appends to the same JSONL ring",
}


@register
class BlockingUnderLockPass(LintPass):
    code = "C003"
    name = "blocking-under-lock"
    description = ("blocking operations (HTTP, I/O, sleeps, joins, "
                   "foreign lock waits, device syncs) under a held lock")
    TARGETS = CONCURRENCY_TARGETS

    def run(self, ms: ModuleSource) -> List[Finding]:
        targets = self.target_files()
        if ms.rel_path in targets:
            prog = program_for_targets(targets)
        else:
            prog = build_program([ms])
        findings: List[Finding] = []
        seen: Set[Tuple[int, str]] = set()

        def allowed(context: str, detail: str) -> bool:
            return (ms.rel_path, context, detail) in ALLOWED

        for mi in prog.infos:
            if mi.rel_path != ms.rel_path:
                continue
            for fi in mi.funcs:
                for b in fi.blocking:
                    if not b.held_any:
                        continue
                    if allowed(b.context, b.detail):
                        continue
                    lock = b.held[-1] if b.held else "a lock"
                    key = (b.line, b.detail)
                    if key in seen:
                        continue
                    seen.add(key)
                    findings.append(Finding(
                        code="C003", path=ms.rel_path, line=b.line,
                        col=b.col, context=b.context,
                        message=f"{b.detail} ({b.op}) while holding "
                                f"{lock} -- blocked holder stalls "
                                f"every thread behind this lock"))
                for c in fi.calls:
                    if not c.held:
                        continue
                    for g in prog.resolve_call(fi, c):
                        blk = prog.may_block.get(id(g), {})
                        if not blk:
                            continue
                        op = sorted(blk)[0]
                        detail, where = blk[op]
                        if allowed(c.context, c.name):
                            continue
                        key = (c.line, c.name)
                        if key in seen:
                            continue
                        seen.add(key)
                        findings.append(Finding(
                            code="C003", path=ms.rel_path, line=c.line,
                            col=c.col, context=c.context,
                            message=f"call {c.name}() reaches "
                                    f"{detail} ({op}, in {where}) "
                                    f"while holding {c.held[-1]}"))
                        break
        return findings
