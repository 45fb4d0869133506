"""Stuck-progress watchdog: the detector for wedged-but-alive queries.

Counterpart of presto_tpu/server/watchdog.py (same detector, firing
and side effects).

The slow-query threshold (flight_recorder + statement.py) fires on
total WALL time -- it cannot tell a genuinely big query from one whose
task stopped advancing 30 seconds ago. This watchdog is the orthogonal
detector: both tiers run one thread that scans the live-progress
registry (exec/progress.py) and fires when a non-terminal query/task's
**last-advance age** exceeds its ``stuck_query_threshold_ms`` (session
property; env fallback ``PRESTO_TPU_STUCK_MS``; 0/unset disables --
the default, so idle clusters pay one cheap scan per poll and nothing
else).

Firing is exactly-once per key and does three things:
  * bumps ``presto_tpu_stuck_queries_total`` (both tiers' /v1/metrics,
    via metrics.live_introspection_families);
  * records a flight-recorder ``stuck_progress`` event (ring + any
    later dump's timeline);
  * auto-dumps the flight ring with ``reason=stuck``, header
    cross-linking the query's trace id -- the same post-mortem
    artifact failed/slow queries get, for queries that are neither.

Determinism: the poll cadence adapts to the smallest armed threshold
(clamped [50ms, 1s]), so a `hang(ms)` failpoint longer than
``threshold + 2*poll`` is GUARANTEED to be caught -- the detector the
chaos harness's hang rounds audit.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional

from ..utils.locks import OrderedLock


__all__ = ["StuckCandidate", "StuckProgressWatchdog", "stuck_totals",
           "resolve_stuck_threshold_ms", "reset_stuck_totals"]

ENV_STUCK_MS = "PRESTO_TPU_STUCK_MS"

# process-lifetime firing counter (both tiers' watchdogs share it, like
# the flight-recorder totals next door)
_TOTALS_LOCK = OrderedLock("watchdog._TOTALS_LOCK")
_STUCK_TOTAL = {"count": 0}


def stuck_totals() -> int:
    with _TOTALS_LOCK:
        return _STUCK_TOTAL["count"]


def reset_stuck_totals() -> None:
    """Test isolation only; production counters are monotonic."""
    with _TOTALS_LOCK:
        _STUCK_TOTAL["count"] = 0


def resolve_stuck_threshold_ms(session=None) -> float:
    """``stuck_query_threshold_ms`` session property with the
    ``PRESTO_TPU_STUCK_MS`` env fallback; 0 / unparseable disables."""
    raw = None
    if session is not None:
        try:
            raw = session.get("stuck_query_threshold_ms")
        except (KeyError, TypeError):
            raw = None
    if raw in (None, ""):
        raw = os.environ.get(ENV_STUCK_MS, "0")
    try:
        return max(float(raw), 0.0)
    except (TypeError, ValueError):
        return 0.0


class StuckCandidate:
    """One non-terminal query/task the scan offers for evaluation."""

    def __init__(self, key: str, threshold_ms: float,
                 last_advance_ts: float,
                 trace_id: Optional[str] = None,
                 query_id: Optional[str] = None,
                 extra: Optional[dict] = None):
        self.key = str(key)
        self.threshold_ms = float(threshold_ms)
        self.last_advance_ts = float(last_advance_ts)
        self.trace_id = trace_id
        self.query_id = query_id or str(key)
        self.extra = extra or {}


class StuckProgressWatchdog:
    """One scan thread per tier. ``scan()`` returns the current
    StuckCandidate list (the tier decides thresholds and last-advance
    semantics); the watchdog owns pacing, exactly-once firing, and the
    counter/flight/dump side effects."""

    _GUARDED_BY = {"_lock": ("_fired",)}

    def __init__(self, scan: Callable[[], List[StuckCandidate]],
                 tier: str, poll_floor_s: float = 0.05,
                 poll_cap_s: float = 1.0):
        self._scan = scan
        self.tier = tier
        self.poll_floor_s = poll_floor_s
        self.poll_cap_s = poll_cap_s
        self._fired: Dict[str, float] = {}  # key -> fire ts (bounded)
        self._lock = OrderedLock("watchdog.StuckProgressWatchdog._lock")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "StuckProgressWatchdog":
        self._thread = threading.Thread(
            target=self._loop, name=f"stuck-watchdog-{self.tier}",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    # -- the scan loop --------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            delay = self.poll_cap_s
            try:
                delay = self.check_once()
            except Exception as e:  # noqa: BLE001 - a scan failure is
                # telemetry loss, never an engine failure; counted
                from .metrics import record_suppressed
                record_suppressed("watchdog", f"{self.tier}_scan", e)
            self._stop.wait(delay)

    def check_once(self) -> float:
        """One scan pass; returns the next poll delay. Public so tests
        (and the chaos driver) can step the detector deterministically
        without racing the background thread."""
        candidates = self._scan() or []
        armed = [c for c in candidates if c.threshold_ms > 0]
        now = time.time()
        for c in armed:
            age_ms = (now - c.last_advance_ts) * 1000.0
            if age_ms < c.threshold_ms:
                continue
            with self._lock:
                if c.key in self._fired:
                    continue
                self._fired[c.key] = now
                while len(self._fired) > 4096:  # bounded bookkeeping
                    self._fired.pop(next(iter(self._fired)))
            self._fire(c, age_ms)
        # adapt the cadence to the tightest armed threshold so a hang
        # of threshold + 2*poll is always caught
        if not armed:
            return self.poll_cap_s
        tight = min(c.threshold_ms for c in armed) / 1000.0
        return min(max(tight / 4.0, self.poll_floor_s), self.poll_cap_s)

    def _fire(self, c: StuckCandidate, age_ms: float) -> None:
        with _TOTALS_LOCK:
            _STUCK_TOTAL["count"] += 1
        from .flight_recorder import get_flight_recorder, record_event
        record_event("stuck_progress", query_id=c.query_id,
                     tier=self.tier, key=c.key,
                     ageMs=int(age_ms), thresholdMs=int(c.threshold_ms),
                     trace=c.trace_id)
        try:
            get_flight_recorder().maybe_dump(
                c.key, "stuck",
                extra={"tier": self.tier, "queryId": c.query_id,
                       "traceId": c.trace_id, "ageMs": int(age_ms),
                       "thresholdMs": int(c.threshold_ms), **c.extra})
        except Exception as e:  # noqa: BLE001 - the dump is best-effort
            # (full disk etc.); the counter + event already landed
            from .metrics import record_suppressed
            record_suppressed("watchdog", "stuck_dump", e)
