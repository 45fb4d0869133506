"""Live task/query progress: the in-flight counterpart of QueryStats.

Counterpart of presto_tpu/exec/progress.py (same counters, monotonic
law and snapshot shape).

Every observability surface before this one was retrospective --
metrics, traces, kernel profiles and the history archive all describe
queries that already finished, while a RUNNING query reported
``processedBytes: 0`` and an opaque state string. This module keeps a
process-wide registry of **monotonic** progress counters for every
in-flight query/task (the ClusterStatsResource / live QueryInfo analog
of the reference coordinator): current stage, splits done vs planned,
rows/bytes so far, peak reserved memory, and the last-advance
timestamp a stuck-progress watchdog (server/watchdog.py) keys on.

The monotonic law (the property every consumer relies on): between two
polls of one entry, ``rows``, ``bytes``, ``splits_done``,
``peak_memory_bytes`` and ``progress_percent`` never decrease, and
``last_advance`` never moves backwards. ``advance()`` takes deltas
(negative deltas clamp to zero); the percent is a stored high-water
mark over a stage-weighted estimate, so a stage label regressing (a
rerun re-entering ``execute``) cannot pull the bar backwards.

Producers:
  * ``run_query`` (exec/runner.py) drives the local entry for its
    ``query_id`` through plan/staging/execute/fetch;
  * the worker's TaskManager registers its task id the moment the task
    flips RUNNING (so a task wedged before the runner starts is still
    visible -- exactly the window the `hang` failpoint exercises);
  * the coordinator's status polls fold each remote task's shipped
    snapshot back into this registry (:func:`note_remote`), keyed by
    task id and tagged with the query's trace id, so the statement
    tier sees cross-worker progress without a second protocol.

Consumers: the statement tier's ``_base_doc`` (live client stats),
``GET /v1/cluster``, ``system.live_tasks`` / ``system.queries``, the
``presto_tpu_running_tasks`` gauge, and the stuck-progress watchdog.

The registry is bounded: finished entries are retained briefly (final
polls still resolve) and evicted oldest-first past the capacity.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, Iterable, List, Optional

from ..utils.locks import OrderedLock


__all__ = ["TaskProgress", "begin", "get_progress", "note_remote",
           "finish_task", "live_snapshots", "snapshots_for_query",
           "live_task_count", "set_capacity", "reset",
           "aggregate_query_progress"]

# stage -> baseline percent estimate; staging interpolates over splits.
# Percents are an operator-facing heuristic, NOT a wall-time promise --
# the stored high-water mark is what makes the rendered bar monotonic.
_STAGE_PCT = {"start": 0.0, "plan": 2.0, "staging": 5.0,
              "execute": 60.0, "fetch": 90.0}
_STAGING_SPAN = (5.0, 60.0)  # staging interpolates splits over this band


class TaskProgress:
    """Monotonic progress counters for one in-flight query or task."""


    def __init__(self, key: str, kind: str = "query",
                 query: Optional[str] = None,
                 worker: Optional[str] = None, remote: bool = False):
        self.key = str(key)
        self.kind = kind          # "query" | "task"
        self.query = query        # owning query/trace id (cross-link)
        self.worker = worker      # origin node for remote-noted entries
        self.remote = remote
        # speculative-attempt provenance: the coordinator names every
        # straggler re-execution `<taskId>.spec[...]`, so the live
        # surfaces (system.live_tasks, /v1/cluster) can render which
        # in-flight work is a speculation racing its original
        self.speculative = ".spec" in self.key
        self.started_at = time.time()
        self.stage = "start"
        self.splits_planned = 0
        self.splits_done = 0
        self.rows = 0
        self.bytes = 0
        self.peak_memory_bytes = 0
        self.last_advance = self.started_at
        self.done = False
        self.final_state: Optional[str] = None
        self._depth = 1           # re-entrant begin() nesting (writes)
        self._pct = 0.0           # high-water percent (monotonic)
        self._lock = OrderedLock("progress.TaskProgress._lock")

    # -- producer side --------------------------------------------------

    def advance(self, stage: Optional[str] = None, splits: int = 0,
                rows: int = 0, bytes: int = 0) -> None:
        """Apply deltas (clamped non-negative) and bump last_advance.
        Cheap and never raises: this sits on the runner's hot loop."""
        now = time.time()
        with self._lock:
            if stage is not None:
                self.stage = str(stage)
            self.splits_done += max(int(splits), 0)
            self.rows += max(int(rows), 0)
            self.bytes += max(int(bytes), 0)
            if self.last_advance < now:
                self.last_advance = now
            self._pct = max(self._pct, self._percent_locked())

    def set_planned(self, splits: int) -> None:
        """Planned split count (grows only: a replan can add work but a
        shrink would make done/planned jump backwards)."""
        with self._lock:
            self.splits_planned = max(self.splits_planned, int(splits))

    def note_memory(self, reserved_bytes: int) -> None:
        with self._lock:
            self.peak_memory_bytes = max(self.peak_memory_bytes,
                                         int(reserved_bytes))

    def release(self, state: Optional[str] = None) -> None:
        """Leave one begin() scope; the outermost release finishes the
        entry (nested run_query re-entries -- write roots -- don't)."""
        with self._lock:
            self._depth -= 1
            if self._depth > 0:
                return
            self._finish_locked(state)

    def force_finish(self, state: Optional[str] = None) -> None:
        """Terminal regardless of nesting (the worker's task epilogue:
        the task state machine, not the runner, owns task finality)."""
        with self._lock:
            self._depth = 0
            self._finish_locked(state)

    def _finish_locked(self, state: Optional[str]) -> None:
        if self.done:
            return
        self.done = True
        self.final_state = state or "FINISHED"
        self.last_advance = max(self.last_advance, time.time())
        if self.final_state == "FINISHED":
            self._pct = 100.0

    def reenter(self) -> None:
        with self._lock:
            self._depth += 1

    # -- consumer side --------------------------------------------------

    def _percent_locked(self) -> float:
        base = _STAGE_PCT.get(self.stage, 0.0)
        if self.stage == "staging" and self.splits_planned > 0:
            lo, hi = _STAGING_SPAN
            frac = min(self.splits_done / self.splits_planned, 1.0)
            base = lo + (hi - lo) * frac
        return min(max(base, 0.0), 100.0)

    def snapshot(self) -> dict:
        """Consistent copy; ages computed here so remote consumers stay
        clock-skew free (they ship ages, not absolute timestamps)."""
        now = time.time()
        with self._lock:
            pct = max(self._pct, self._percent_locked())
            return {
                "key": self.key,
                "kind": self.kind,
                "query": self.query or self.key,
                "worker": self.worker,
                "speculative": self.speculative,
                "state": (self.final_state or "FINISHED") if self.done
                         else "RUNNING",
                "stage": self.stage,
                "splitsDone": self.splits_done,
                "splitsPlanned": self.splits_planned,
                "rows": self.rows,
                "bytes": self.bytes,
                "peakMemoryBytes": self.peak_memory_bytes,
                "progressPercent": round(100.0 if self.done and
                                         self.final_state == "FINISHED"
                                         else pct, 1),
                "elapsedMs": int((now - self.started_at) * 1000),
                "lastAdvanceTsUs": int(self.last_advance * 1e6),
                "lastAdvanceAgeMs": max(
                    int((now - self.last_advance) * 1000), 0),
            }

    def merge_remote(self, doc: dict) -> None:
        """Fold a remote snapshot into this entry, monotonically: every
        counter takes the max (status polls can arrive out of order),
        and last_advance derives from the shipped AGE (clock-skew
        free). A terminal shipped state finishes the entry."""
        now = time.time()
        with self._lock:
            self.stage = str(doc.get("stage", self.stage))
            self.splits_planned = max(self.splits_planned,
                                      int(doc.get("splitsPlanned", 0)))
            self.splits_done = max(self.splits_done,
                                   int(doc.get("splitsDone", 0)))
            self.rows = max(self.rows, int(doc.get("rows", 0)))
            self.bytes = max(self.bytes, int(doc.get("bytes", 0)))
            self.peak_memory_bytes = max(
                self.peak_memory_bytes,
                int(doc.get("peakMemoryBytes", 0)))
            age_ms = max(int(doc.get("lastAdvanceAgeMs", 0)), 0)
            self.last_advance = max(self.last_advance,
                                    now - age_ms / 1000.0)
            self._pct = max(self._pct,
                            float(doc.get("progressPercent", 0.0)))
            state = doc.get("state")
            if state in ("FINISHED", "FAILED", "ABORTED", "CANCELED"):
                self._depth = 0
                self._finish_locked(state)


# -- process registry ---------------------------------------------------

# entries keyed by query/task id, bounded; finished entries linger so a
# final poll still resolves, evicted oldest-first past capacity (done
# entries first -- a live entry is only evicted when everything is live)
_LOCK = OrderedLock("progress._LOCK")
_ENTRIES: "collections.OrderedDict[str, TaskProgress]" = \
    collections.OrderedDict()
_CAPACITY = 2048


def begin(key: str, kind: str = "query", query: Optional[str] = None,
          worker: Optional[str] = None) -> TaskProgress:
    """The live entry for `key`, created (or re-entered: a nested
    run_query of a write root shares its outer scope's entry)."""
    with _LOCK:
        ent = _ENTRIES.get(key)
        if ent is not None and not ent.done:
            ent.reenter()
            if query and ent.query is None:
                ent.query = query
            return ent
        ent = TaskProgress(key, kind=kind, query=query, worker=worker)
        _ENTRIES[key] = ent
        _ENTRIES.move_to_end(key)
        _evict_locked()
        return ent


def get_progress(key: str) -> Optional[TaskProgress]:
    with _LOCK:
        return _ENTRIES.get(key)


def note_remote(key: str, doc: dict, worker: Optional[str] = None,
                query: Optional[str] = None) -> None:
    """Fold a remote task's shipped progress snapshot into the local
    registry (the coordinator's status-poll hook). Never raises: a
    malformed document is telemetry loss, not a query failure."""
    if not isinstance(doc, dict):
        return
    try:
        with _LOCK:
            ent = _ENTRIES.get(key)
            if ent is None:
                ent = TaskProgress(key, kind="task", query=query,
                                   worker=worker, remote=True)
                _ENTRIES[key] = ent
                _ENTRIES.move_to_end(key)
                _evict_locked()
            elif query and ent.query is None:
                ent.query = query
        ent.merge_remote(doc)
    except Exception:  # noqa: BLE001 - progress is telemetry; the poll
        # that carried it must not fail (counted upstream when it
        # matters: the callers sit on already-best-effort paths)
        pass


def finish_task(key: str, state: str) -> None:
    ent = get_progress(key)
    if ent is not None:
        ent.force_finish(state)


def live_snapshots() -> List[dict]:
    """Snapshots of every in-flight entry (oldest first)."""
    with _LOCK:
        entries = [e for e in _ENTRIES.values() if not e.done]
    return [e.snapshot() for e in entries]


def snapshots_for_query(keys: Iterable[str],
                        include_done: bool = True) -> List[dict]:
    """Snapshots of entries belonging to any of the given query/trace
    ids (matched on the entry key OR its query cross-link)."""
    wanted = {str(k) for k in keys if k}
    with _LOCK:
        entries = [e for e in _ENTRIES.values()
                   if (e.key in wanted or (e.query or "") in wanted)
                   and (include_done or not e.done)]
    return [e.snapshot() for e in entries]


def live_task_count() -> int:
    with _LOCK:
        return sum(1 for e in _ENTRIES.values() if not e.done)


def set_capacity(n: int) -> None:
    """Registry bound (tests shrink it to pin eviction)."""
    global _CAPACITY
    with _LOCK:
        _CAPACITY = max(int(n), 1)
        _evict_locked()


def _evict_locked() -> None:
    while len(_ENTRIES) > _CAPACITY:
        victim = None
        for k, e in _ENTRIES.items():  # oldest done entry first
            if e.done:
                victim = k
                break
        if victim is None:  # everything live: evict the oldest anyway
            victim = next(iter(_ENTRIES))
        del _ENTRIES[victim]


def reset() -> None:
    """Drop every entry (tests isolate registry state)."""
    with _LOCK:
        _ENTRIES.clear()


# aggregate view used by the statement tier (one place so _base_doc,
# /v1/cluster and the watchdog agree on what "query progress" means)
def aggregate_query_progress(keys: Iterable[str]) -> Optional[dict]:
    """Fold the query's own entry plus its tasks' entries into ONE
    progress doc: rows/bytes/splits sum, peaks max, percent averages
    over live tasks, stage and last-advance follow the most recently
    advanced entry. None when nothing was ever registered."""
    docs = snapshots_for_query(keys)
    if not docs:
        return None
    live = [d for d in docs if d["state"] == "RUNNING"] or docs
    latest = max(docs, key=lambda d: d["lastAdvanceTsUs"])
    return {
        "stage": latest["stage"],
        "rows": sum(d["rows"] for d in docs),
        "bytes": sum(d["bytes"] for d in docs),
        "splitsDone": sum(d["splitsDone"] for d in docs),
        "splitsPlanned": sum(d["splitsPlanned"] for d in docs),
        "peakMemoryBytes": max(d["peakMemoryBytes"] for d in docs),
        "progressPercent": round(
            sum(d["progressPercent"] for d in live) / len(live), 1),
        "lastAdvanceAgeMs": min(d["lastAdvanceAgeMs"] for d in docs),
        "tasks": len(docs),
        "runningTasks": sum(1 for d in docs if d["state"] == "RUNNING"),
        "speculativeTasks": sum(1 for d in docs
                                if d.get("speculative")),
    }
