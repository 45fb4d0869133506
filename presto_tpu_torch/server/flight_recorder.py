"""Flight recorder: always-on bounded ring of structured events, with
automatic slow/failed-query dumps.

Counterpart of presto_tpu/server/flight_recorder.py. Dumps are
written only to a directory the caller names (``dump_dir``, or the
``PRESTO_TPU_FLIGHT_DIR`` environment variable); without one a dump
is counted and not written.

Both tiers keep a small always-on ring of structured events (query and
task state transitions, retries, suppressed errors, cache hits,
narrow-width decisions). When a query fails, finishes slower than the
``slow_query_threshold_ms`` session property (env fallback
``PRESTO_TPU_SLOW_QUERY_MS``), stalls (server/watchdog.py) or breaches
its history baseline (server/history.py), the events relevant to it
are dumped to one JSONL file, exactly once per key, and counted on
``/v1/metrics`` (``presto_tpu_flight_recorder_dumps_total{reason}``).

The ring is process-wide (both tiers run one per process); swap it with
:func:`set_flight_recorder` in tests to redirect the dump directory.
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Dict, List, Optional

from ..utils.locks import OrderedLock


__all__ = ["FlightRecorder", "get_flight_recorder", "set_flight_recorder",
           "record_event", "flight_recorder_totals"]

# -- process-lifetime counters (survive recorder swaps; /v1/metrics) ----

_COUNTERS_LOCK = OrderedLock("flight_recorder._COUNTERS_LOCK")
_EVENTS_TOTAL = {"count": 0}
_DUMPS_TOTAL: Dict[str, int] = {}  # reason -> count
_EVICTED_TOTAL = {"count": 0}      # dump files deleted by retention

# _dumped marker while the JSONL write is in flight ('' = capped/failed)
_PENDING = "<pending>"


def flight_recorder_totals() -> Dict[str, object]:
    with _COUNTERS_LOCK:
        return {"events": _EVENTS_TOTAL["count"],
                "dumps": dict(_DUMPS_TOTAL),
                "evicted": _EVICTED_TOTAL["count"]}


class FlightRecorder:
    """Bounded ring buffer of structured events + the dump trigger.

    Events are plain dicts ``{tsUs, kind, queryId?, ...fields}``; the
    ring drops oldest-first at capacity (a dump therefore shows the
    most recent window, which is the one that matters post-mortem)."""

    # request-handler, task, and engine threads all append; dump
    # bookkeeping shares the same lock
    _GUARDED_BY = {"_lock": ("_dumped",)}

    def __init__(self, capacity: int = 4096,
                 dump_dir: Optional[str] = None,
                 max_dump_files: int = 256,
                 max_dump_dir_files: Optional[int] = None):
        self.capacity = int(capacity)
        self._ring: "collections.deque[dict]" = \
            collections.deque(maxlen=self.capacity)
        # None: dumps are counted, not written
        self.dump_dir = dump_dir or os.environ.get(
            "PRESTO_TPU_FLIGHT_DIR") or None
        self.max_dump_files = max_dump_files
        # ON-DISK retention: the dump directory previously grew without
        # bound across process restarts (the in-memory _dumped cap only
        # limits one process's writes). Beyond this many *.jsonl files
        # the OLDEST are deleted after each new dump lands, counted
        # presto_tpu_flight_dumps_evicted_total. Env override
        # PRESTO_TPU_FLIGHT_MAX_DUMPS; <= 0 disables eviction.
        if max_dump_dir_files is None:
            try:
                max_dump_dir_files = int(os.environ.get(
                    "PRESTO_TPU_FLIGHT_MAX_DUMPS", "256"))
            except ValueError:
                max_dump_dir_files = 256
        self.max_dump_dir_files = int(max_dump_dir_files)
        self._dumped: Dict[str, str] = {}  # key -> dump path ('' = capped)
        self._lock = OrderedLock("flight_recorder.FlightRecorder._lock")

    # -- recording ------------------------------------------------------

    def record(self, kind: str, query_id: Optional[str] = None,
               **fields) -> None:
        """Append one event. Cheap and never raises: this runs on hot
        request paths."""
        evt = {"tsUs": int(time.time() * 1_000_000), "kind": str(kind)}
        if query_id is not None:
            evt["queryId"] = str(query_id)
        for k, v in fields.items():
            if v is not None:
                evt[k] = v if isinstance(v, (int, float, bool)) else str(v)
        # deque.append with maxlen is atomic under the GIL; no lock on
        # the hot path. The counter bump is likewise unguarded: a lost
        # increment under a rare interleave is acceptable for a
        # monotonic telemetry total, contention on every event is not.
        self._ring.append(evt)
        _EVENTS_TOTAL["count"] += 1

    def events(self, query_id: Optional[str] = None,
               kind: Optional[str] = None) -> List[dict]:
        """Snapshot of retained events, optionally filtered. Events
        without a queryId (process-wide decisions) are INCLUDED in a
        query-filtered view: they are context the post-mortem needs."""
        snap = list(self._ring)
        if kind is not None:
            snap = [e for e in snap if e["kind"] == kind]
        if query_id is not None:
            snap = [e for e in snap
                    if e.get("queryId") in (None, str(query_id))]
        return snap

    # -- dumping --------------------------------------------------------

    def dump_path(self, key: str) -> Optional[str]:
        """Path of the dump already written for `key`, if any (None
        while a dump is still mid-write, or when it was capped)."""
        with self._lock:
            p = self._dumped.get(key)
        return p if p and p != _PENDING else None

    def maybe_dump(self, key: str, reason: str,
                   extra: Optional[dict] = None) -> Optional[str]:
        """Write ONE JSONL dump for `key` (query/task id): a header
        line ``{dump: {...}}`` then every retained event relevant to
        the key. Idempotent per key -- the exactly-one-dump-per-query
        contract -- and counted per reason even when the file cap stops
        the write. Returns the path written (None if deduped/capped)."""
        with self._lock:
            if key in self._dumped:
                return None  # already dumped (exactly once per query)
            capped = len(self._dumped) >= self.max_dump_files
            self._dumped[key] = "" if capped else _PENDING
        with _COUNTERS_LOCK:
            _DUMPS_TOTAL[reason] = _DUMPS_TOTAL.get(reason, 0) + 1
        if capped or self.dump_dir is None:
            with self._lock:
                self._dumped[key] = ""
            return None
        path = os.path.join(self.dump_dir,
                            f"{_safe_name(key)}.{reason}.jsonl")
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            events = self.events(query_id=key)
            kernels = self._profile_of(key)
            datapath = self._datapath_of(key)
            accuracy = self._accuracy_of(key)
            timeline = self._timeline_of(key)
            with open(path, "w") as f:
                f.write(json.dumps(
                    {"dump": {"key": key, "reason": reason,
                              "tsUs": int(time.time() * 1_000_000),
                              "events": len(events),
                              **(extra or {})}}) + "\n")
                if kernels:
                    # the continuous profiler's view of THIS query's
                    # kernels (cross-linked by plan fingerprint): a
                    # slow-query dump answers "which kernel" offline,
                    # without a live /v1/profile to ask
                    f.write(json.dumps(
                        {"profile": {"queryId": key,
                                     "kernels": kernels}}) + "\n")
                if datapath:
                    # the data-path waterfall of THIS query (per-hop
                    # bytes/wall): a slow-query dump answers "which
                    # hop" offline, without a live /v1/datapath to ask
                    f.write(json.dumps(
                        {"datapath": {"queryId": key,
                                      "hops": datapath}}) + "\n")
                if accuracy:
                    # the estimate-vs-actual ledger of THIS query
                    # (per-node est/act): a misestimate dump answers
                    # "which node lied" offline, without a live
                    # /v1/accuracy to ask
                    f.write(json.dumps(
                        {"accuracy": {"queryId": key,
                                      "nodes": accuracy}}) + "\n")
                if timeline:
                    # the execution timeline of THIS query (lane/hop
                    # intervals + occupancy verdict): a slow-query dump
                    # answers "what was the device waiting on" offline,
                    # without a live /v1/timeline to ask
                    f.write(json.dumps(
                        {"timeline": {"queryId": key,
                                      **timeline}}) + "\n")
                for evt in events:
                    f.write(json.dumps(evt, default=str) + "\n")
        except Exception as e:  # noqa: BLE001 - a full disk must not
            # turn a slow query into a failed one; the miss is counted
            from .metrics import record_suppressed
            record_suppressed("flight_recorder", "dump", e)
            with self._lock:
                self._dumped[key] = ""
            return None
        with self._lock:
            self._dumped[key] = path
        self._evict_dumps(keep=path)
        return path

    def _evict_dumps(self, keep: Optional[str] = None) -> int:
        """Enforce the on-disk retention cap: delete *.jsonl dump files
        oldest-first (mtime, then name for determinism) beyond
        ``max_dump_dir_files``, never the dump just written. Counted;
        best-effort (a dir race is not an error). Returns the number
        evicted."""
        if self.max_dump_dir_files <= 0 or self.dump_dir is None:
            return 0
        try:
            names = [os.path.join(self.dump_dir, n)
                     for n in os.listdir(self.dump_dir)
                     if n.endswith(".jsonl")]
            names.sort(key=lambda p: (os.path.getmtime(p), p))
        except OSError:
            return 0
        excess = len(names) - self.max_dump_dir_files
        evicted = 0
        for path in names:
            if evicted >= excess:
                break
            if keep is not None and path == keep:
                continue
            try:
                os.remove(path)
                evicted += 1
            except OSError:
                continue  # raced another evictor / already gone
        if evicted:
            with _COUNTERS_LOCK:
                _EVICTED_TOTAL["count"] += evicted
        return evicted

    @staticmethod
    def _datapath_of(key: str) -> dict:
        """This query's per-hop ledger (best-effort, like the profile
        embed)."""
        try:
            from ..exec.datapath import datapath_for_query
            return datapath_for_query(key)
        except Exception as e:  # noqa: BLE001 - the dump must land
            # even when the ledger is broken; count the gap
            from .metrics import record_suppressed
            record_suppressed("flight_recorder", "datapath_snapshot", e)
            return {}

    @staticmethod
    def _accuracy_of(key: str) -> dict:
        """This query's per-node estimate-vs-actual records
        (best-effort, like the profile embed)."""
        try:
            from ..exec.accuracy import accuracy_for_query
            return accuracy_for_query(key)
        except Exception as e:  # noqa: BLE001 - the dump must land
            # even when the ledger is broken; count the gap
            from .metrics import record_suppressed
            record_suppressed("flight_recorder", "accuracy_snapshot", e)
            return {}

    @staticmethod
    def _timeline_of(key: str) -> dict:
        """This query's lane/hop interval ledger + occupancy verdict
        (best-effort, like the profile embed)."""
        try:
            from ..exec.timeline import timeline_for_query
            return timeline_for_query(key)
        except Exception as e:  # noqa: BLE001 - the dump must land
            # even when the ledger is broken; count the gap
            from .metrics import record_suppressed
            record_suppressed("flight_recorder", "timeline_snapshot", e)
            return {}

    @staticmethod
    def _profile_of(key: str) -> List[dict]:
        """Top device-time kernel rows the profiler attributed to this
        query/task id (best-effort: a dump with no profile beats no
        dump)."""
        try:
            from ..exec.profiler import profile_for_query
            return profile_for_query(key, top=8)
        except Exception as e:  # noqa: BLE001 - the dump must land even
            # when the profiler is broken; count the gap
            from .metrics import record_suppressed
            record_suppressed("flight_recorder", "profile_snapshot", e)
            return []


_recorder: Optional[FlightRecorder] = None
_recorder_lock = OrderedLock("flight_recorder._recorder_lock")


def get_flight_recorder() -> FlightRecorder:
    """The process recorder (created on first use -- always on)."""
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = FlightRecorder()
    return _recorder


def set_flight_recorder(recorder: Optional[FlightRecorder]) -> None:
    """Swap the process recorder (tests redirect the dump dir); None
    resets to a fresh default on next use."""
    global _recorder
    with _recorder_lock:
        _recorder = recorder


def record_event(kind: str, query_id: Optional[str] = None,
                 **fields) -> None:
    """Module-level convenience: record into the process recorder."""
    get_flight_recorder().record(kind, query_id=query_id, **fields)


def _safe_name(key: str) -> str:
    return "".join(c if c.isalnum() or c in "._-" else "_"
                   for c in str(key))[:120]
