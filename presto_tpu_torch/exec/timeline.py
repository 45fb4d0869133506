"""Execution timeline & occupancy profiler: split-level interval
tracing with pipeline-bubble attribution.

Counterpart of presto_tpu/exec/timeline.py: the same lanes, slice
merge law, age-form JSON and occupancy engine. In the port the
``device`` lane's intervals are dispatch spans: the stream time
between CUDA event pairs around each dispatch, rebased onto
:func:`datapath.now_us` by an anchor event recorded after the run's
final fetch (exec/datapath.py::resolve_device_hops). A span includes
the stream idling while the host enqueues the dispatch's launches, so
the lane's busy time bounds the device's from above and its idle share
bounds the device's from below. On a mesh of one card the workers run
on one stream, so their dispatches interleave on the one device
lane.

Model -- three layers, one merge law (the datapath/accuracy template):

  * ``Interval`` -- one ``(lane, hop, split_id, t0_us, t1_us, bytes)``
    record on the per-process monotonic clock (``datapath.now_us``,
    the SAME clock the hop walls use, so hop sums and interval
    durations reconcile by construction). Lanes partition the engine's
    two execution streams: ``host`` (staging threads: connector read,
    decode, narrow cast, device put, serde, fetch, drain) and
    ``device`` (the compiled-program dispatch stream -- the ``kernel``
    hop). Hops within one lane may overlap (exchange_fetch CONTAINS
    decode, exactly as in the hop catalog); occupancy math unions
    them.
  * ``TimelineSlice`` -- one query's bounded interval ledger slice.
    The merge law: interval multisets union then keep the
    ``max_intervals`` earliest under a total sort order (keep-k-
    smallest is associative + commutative), dropped counts and per-hop
    totals add -- the empty slice is the identity -- so worker slices
    stitch through the existing task-status path
    (``QueryStats.timeline``, folded by ``QueryStats.merge``).
    Cross-process JSON ships AGES, never absolute timestamps
    (``endAgeUs`` + ``durUs``, the exec/progress.py trick): the
    receiver rebases onto its own clock, so clock skew can shift a
    remote slice but can never produce a negative interval.
  * process-lifetime registry: the ``GET /v1/timeline`` slice (worker
    serves it; the statement tier merges slices cluster-wide via
    server/client.pull_worker_docs, processId-deduped, stable zero
    shape), ``system.occupancy``, metrics.timeline_families(),
    flight-dump embeds and the Chrome trace export
    (:func:`to_chrome_trace`).

The occupancy engine is PURE (no clocks, no env -- perfgate-style, so
identical intervals always produce identical verdicts): per-lane busy
fractions over the execute wall, the overlap fraction (share of
device-busy wall during which host staging is concurrently busy --
the pipelining number), and the bubble verdict, which sweeps the
device-idle gaps and names the host hop the device was waiting on:
"device idle 71% of execute wall; bubbles attributed: connector_read
(54%), device_put (17%)". Deterministic tiebreak: attributed idle
desc, hop name asc.

Bounded and fail-open everywhere: per-query interval caps with
totals-only degradation (intervals drop, per-hop busy/bytes totals
keep counting -- counted, never failing the query), an LRU'd
per-query registry, a ``timeline.record`` failpoint proving the
degradation path, and a ``timeline`` session property /
``PRESTO_TPU_TIMELINE`` env gate (default on).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import uuid
from typing import Dict, List, Optional, Tuple

from .. import failpoints
from .datapath import HOPS, now_us
from ..utils.locks import OrderedLock

__all__ = ["LANES", "LANE_OF", "TIMELINE_ENV", "MAX_INTERVALS",
           "Interval", "TimelineSlice", "TimelineLedger", "recording",
           "record_interval", "split_scope", "current_split",
           "timeline_enabled", "occupancy", "bubble_verdict",
           "ascii_gantt", "to_chrome_trace", "note_query",
           "timeline_for_query", "last_occupancy", "timeline_totals",
           "clear_timeline", "timeline_doc", "merge_timeline_docs",
           "cluster_timeline_doc", "snapshot", "timeline_summary"]

TIMELINE_ENV = "PRESTO_TPU_TIMELINE"

# the lane catalog: ONE closed vocabulary every surface shares (the
# Gantt rows, /v1/timeline zero shape, system.occupancy rows, Chrome
# trace thread names). `device` is the compiled-program dispatch
# stream; everything else on the hop catalog is host-side staging.
LANES = ("host", "device")
LANE_OF = {hop: ("device" if hop == "kernel" else "host")
           for hop in HOPS}

# per-query interval cap: beyond it the slice degrades to totals-only
# (dropped counted). 4096 covers thousands of splits x hops; one
# Interval is ~100 bytes, so a full slice stays ~400 KB.
MAX_INTERVALS = 4096

# one id per process: the cluster merge deduplicates slices by it, so
# two server shells over one process (the test topology) count once
_PROCESS_ID = uuid.uuid4().hex


@dataclasses.dataclass(frozen=True)
class Interval:
    """One timed window on the per-process monotonic clock. Treated
    as immutable: slices share Interval objects freely across
    merges."""
    lane: str
    hop: str
    split_id: int = -1
    t0_us: int = 0
    t1_us: int = 0
    bytes: int = 0

    def sort_key(self) -> tuple:
        # a TOTAL order: keep-k-smallest truncation under it is
        # associative, which is what makes the slice merge a law
        return (self.t0_us, self.t1_us, self.lane, self.hop,
                self.split_id, self.bytes)


def _zero_hop_total() -> Dict[str, int]:
    return {"busyUs": 0, "bytes": 0, "count": 0}


@dataclasses.dataclass
class TimelineSlice:
    """One query's interval-ledger slice. Merges with the usual law:
    interval multisets union (truncated to the earliest
    ``MAX_INTERVALS`` under the total sort order, overflow counted in
    ``dropped``), dropped adds, per-hop totals add -- associative and
    commutative with the empty slice as identity, like QueryStats.
    ``totals`` keep counting after interval degradation: the
    totals-only floor every surface can still render."""
    intervals: List[Interval] = dataclasses.field(default_factory=list)
    dropped: int = 0
    totals: Dict[str, Dict[str, int]] = \
        dataclasses.field(default_factory=dict)

    def merge(self, other: "TimelineSlice") -> "TimelineSlice":
        ivs = sorted(self.intervals + other.intervals,
                     key=Interval.sort_key)
        dropped = self.dropped + other.dropped
        if len(ivs) > MAX_INTERVALS:
            dropped += len(ivs) - MAX_INTERVALS
            ivs = ivs[:MAX_INTERVALS]
        totals: Dict[str, Dict[str, int]] = {}
        for src in (self.totals, other.totals):
            for hop, t in src.items():
                out = totals.setdefault(hop, _zero_hop_total())
                for k in out:
                    out[k] += int(t.get(k, 0))
        return TimelineSlice(ivs, dropped, totals)

    def copy(self) -> "TimelineSlice":
        return TimelineSlice(list(self.intervals), self.dropped,
                             {h: dict(t) for h, t in self.totals.items()})

    def to_json(self, now: Optional[int] = None) -> dict:
        """Serialize for cross-process shipping. Absolute monotonic
        times are meaningless on another host, so each interval ships
        as (endAgeUs, durUs) relative to ``now`` -- the progress.py
        skew-free trick. ``now`` is injectable for deterministic
        tests; production callers take the ambient clock."""
        ref = now_us() if now is None else int(now)
        return {"intervals": [[iv.lane, iv.hop, iv.split_id,
                               max(ref - iv.t1_us, 0),
                               max(iv.t1_us - iv.t0_us, 0),
                               iv.bytes]
                              for iv in self.intervals],
                "dropped": self.dropped,
                "totals": {h: dict(t)
                           for h, t in self.totals.items()}}

    @classmethod
    def from_json(cls, doc: dict,
                  now: Optional[int] = None) -> "TimelineSlice":
        """Rebase a shipped slice onto THIS process's clock: t1 =
        now - endAge, t0 = t1 - dur, both deltas clamped >= 0 -- a
        skewed remote clock can shift a slice, never produce a
        negative interval. Old-doc tolerance: a missing/partial doc
        deserializes to the empty slice (merge identity); unknown
        keys are ignored."""
        ref = now_us() if now is None else int(now)
        ivs = []
        for row in (doc or {}).get("intervals") or ():
            lane, hop, split, end_age, dur = (str(row[0]), str(row[1]),
                                              int(row[2]), int(row[3]),
                                              int(row[4]))
            nbytes = int(row[5]) if len(row) > 5 else 0
            t1 = ref - max(end_age, 0)
            ivs.append(Interval(lane, hop, split, t1 - max(dur, 0),
                                t1, nbytes))
        ivs.sort(key=Interval.sort_key)
        totals = {str(h): {k: int(t.get(k, 0))
                           for k in _zero_hop_total()}
                  for h, t in ((doc or {}).get("totals") or {}).items()}
        return cls(ivs, int((doc or {}).get("dropped") or 0), totals)

    def rows(self) -> List[list]:
        """Raw in-process rows (t0/t1 on the local monotonic clock)
        for flight dumps and the Chrome export -- post-mortem surfaces
        on the SAME host, where absolute monotonic times align."""
        return [[iv.lane, iv.hop, iv.split_id, iv.t0_us, iv.t1_us,
                 iv.bytes] for iv in self.intervals]

    def is_empty(self) -> bool:
        return not (self.intervals or self.dropped or self.totals)


class TimelineLedger:
    """Per-query interval accumulator (the ambient collection target).
    Thread-safe: host staging threads and the device dispatch stream
    record concurrently. ``enabled=False`` makes every record a no-op
    (the session-property gate); ``degraded`` is the sticky totals-only
    floor a failed record path drops to."""


    def __init__(self, query_id: str = "", enabled: bool = True,
                 max_intervals: int = MAX_INTERVALS):
        self.query_id = query_id
        self.enabled = enabled
        self.max_intervals = int(max_intervals)
        self.intervals: List[Interval] = []
        self.dropped = 0
        self.totals: Dict[str, Dict[str, int]] = {}
        self.degraded = False
        self._lock = OrderedLock("timeline.TimelineLedger._lock")

    def record(self, hop: str, nbytes: int, t0_us: int, t1_us: int,
               split_id: int = -1) -> None:
        lane = LANE_OF.get(hop, "host")
        with self._lock:
            self._fold_total_locked(hop, nbytes, t1_us - t0_us)
            if self.degraded or len(self.intervals) >= \
                    self.max_intervals:
                self.dropped += 1
                return
            self.intervals.append(Interval(lane, hop, int(split_id),
                                           int(t0_us), int(t1_us),
                                           int(nbytes)))

    def degrade(self, hop: str, nbytes: int, t0_us: int,
                t1_us: int) -> bool:
        """Totals-only floor for a record that failed mid-flight: the
        observation still counts (busy/bytes totals), the interval is
        dropped, and the ledger stays degraded for the rest of the
        query. Returns True on the FIRST degradation (the caller
        emits one flight event per query, not per record)."""
        with self._lock:
            self._fold_total_locked(hop, nbytes, t1_us - t0_us)
            self.dropped += 1
            first = not self.degraded
            self.degraded = True
            return first

    def _fold_total_locked(self, hop: str, nbytes: int, dur_us: int) -> None:
        t = self.totals.get(hop)
        if t is None:
            t = self.totals[hop] = _zero_hop_total()
        t["busyUs"] += max(int(dur_us), 0)
        t["bytes"] += int(nbytes)
        t["count"] += 1

    def snapshot_slice(self) -> TimelineSlice:
        with self._lock:
            return TimelineSlice(
                list(self.intervals), self.dropped,
                {h: dict(t) for h, t in self.totals.items()})


# -- ambient (thread-local) attribution ---------------------------------

_tls = threading.local()


def _current_ledger() -> Optional[TimelineLedger]:
    return getattr(_tls, "ledger", None)


class recording:
    """Install `ledger` as this thread's ambient timeline target
    (exec/runner.py wraps each run_query; nested invocations shadow
    and restore, like datapath.recording and accuracy.recording)."""

    def __init__(self, ledger: TimelineLedger):
        self.ledger = ledger

    def __enter__(self):
        self.prev = _current_ledger()
        _tls.ledger = self.ledger
        return self.ledger

    def __exit__(self, *exc):
        _tls.ledger = self.prev
        return False


class split_scope:
    """Tag every interval recorded inside the block with `split_id`
    (the runner's staging loop wraps each scan split, so the
    connector_read/decode/narrow_cast/device_put seams attribute to
    their split without threading an index through every signature)."""

    def __init__(self, split_id: int):
        self.split_id = int(split_id)

    def __enter__(self):
        self.prev = current_split()
        _tls.split = self.split_id
        return self

    def __exit__(self, *exc):
        _tls.split = self.prev
        return False


def current_split() -> int:
    return getattr(_tls, "split", -1)


def record_interval(hop: str, nbytes: int, t0_us: int, t1_us: int,
                    split_id: int = -1) -> None:
    """Fold one timed window into the ambient ledger (when one is
    installed). Never raises: this sits on the staging/serde/dispatch
    hot paths. A failure inside the record path (including the
    ``timeline.record`` failpoint) degrades the ledger to counted
    totals -- the query keeps running and keeps counting."""
    try:
        ledger = _current_ledger()
        if ledger is None or not ledger.enabled:
            return
        sid = split_id if split_id >= 0 else current_split()
        try:
            if failpoints.ARMED:
                failpoints.hit("timeline.record")
            ledger.record(hop, nbytes, t0_us, t1_us, sid)
        except Exception as e:  # noqa: BLE001 - degrade, never fail
            first = ledger.degrade(hop, nbytes, t0_us, t1_us)
            _note_degraded(ledger.query_id if first else None, e)
    except Exception as e:  # noqa: BLE001 - attribution must never
        # fail the query it observes; leave the counted trace
        try:
            from ..server.metrics import record_suppressed
            record_suppressed("timeline", "record_interval", e)
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


def timeline_enabled(session) -> bool:
    """Session property ``timeline``; process default from
    PRESTO_TPU_TIMELINE (default ON -- the instrument is cheap and the
    occupancy baseline must exist before the pipeline work)."""
    import os
    env_on = os.environ.get("PRESTO_TPU_TIMELINE", "1") \
        not in ("0", "", "false")
    from ..utils.config import session_flag
    return session_flag(session, "timeline", env_on)


# -- occupancy engine (pure: no clocks, no env) --------------------------


def _as_interval(iv) -> Interval:
    """Interval or its raw row -> Interval (both shapes flow through
    the engine: QueryStats carries objects, flight dumps carry
    rows)."""
    if isinstance(iv, Interval):
        return iv
    lane, hop, split, t0, t1 = (str(iv[0]), str(iv[1]), int(iv[2]),
                                int(iv[3]), int(iv[4]))
    return Interval(lane, hop, split, t0, t1,
                    int(iv[5]) if len(iv) > 5 else 0)


def _merge_segments(segs: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Sorted (t0, t1) windows -> their disjoint union sweep."""
    out: List[Tuple[int, int]] = []
    for a, b in sorted(segs):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _span_us(segs: List[Tuple[int, int]]) -> int:
    return sum(b - a for a, b in segs)


def _intersect(xs: List[Tuple[int, int]],
               ys: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Two disjoint sorted segment lists -> their intersection."""
    out: List[Tuple[int, int]] = []
    i = j = 0
    while i < len(xs) and j < len(ys):
        a = max(xs[i][0], ys[j][0])
        b = min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] <= ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def _subtract(window: Tuple[int, int],
              segs: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The window's complement of a disjoint sorted segment list."""
    out: List[Tuple[int, int]] = []
    cur = window[0]
    for a, b in segs:
        if a > cur:
            out.append((cur, min(a, window[1])))
        cur = max(cur, b)
        if cur >= window[1]:
            break
    if cur < window[1]:
        out.append((cur, window[1]))
    return out


def occupancy(intervals) -> Optional[dict]:
    """The occupancy document of one interval set: per-lane busy
    fractions over the execute wall (min t0 .. max t1), the overlap
    fraction (|device-busy AND host-busy| / device-busy -- the
    pipelining number, ~0 on today's serial staging), the device-idle
    share, and the bubble attribution: per host hop, how much of the
    device-idle wall that hop was busy during (the hop the device was
    WAITING on). Pure function of its inputs -- no clocks, no env --
    so identical intervals always produce identical documents. None
    when no intervals were recorded (totals-only degradation leaves
    the per-hop totals, not an occupancy)."""
    ivs = [_as_interval(iv) for iv in intervals]
    if not ivs:
        return None
    w0 = min(iv.t0_us for iv in ivs)
    w1 = max(iv.t1_us for iv in ivs)
    wall = max(w1 - w0, 0)
    lane_segs = {
        lane: _merge_segments([(iv.t0_us, iv.t1_us) for iv in ivs
                               if iv.lane == lane
                               and iv.t1_us > iv.t0_us])
        for lane in LANES}
    lanes = {}
    for lane in LANES:
        busy = _span_us(lane_segs[lane])
        lanes[lane] = {"busyUs": busy,
                       "busyFraction": round(busy / wall, 4)
                       if wall else 0.0}
    dev_busy = lanes["device"]["busyUs"]
    overlap = _span_us(_intersect(lane_segs["device"],
                                  lane_segs["host"]))
    idle_segs = _subtract((w0, w1), lane_segs["device"])
    idle = _span_us(idle_segs)
    bubbles = []
    for hop in HOPS:
        if LANE_OF.get(hop) == "device":
            continue
        hop_segs = _merge_segments([(iv.t0_us, iv.t1_us) for iv in ivs
                                    if iv.hop == hop
                                    and iv.t1_us > iv.t0_us])
        attr = _span_us(_intersect(hop_segs, idle_segs))
        if attr > 0:
            bubbles.append({"hop": hop, "idleUs": attr,
                            "share": round(attr / wall, 4)
                            if wall else 0.0})
    # deterministic order: attributed idle desc, hop name asc
    bubbles.sort(key=lambda b: (-b["idleUs"], b["hop"]))
    return {"wallUs": wall,
            "lanes": lanes,
            "overlapUs": overlap,
            "overlapFraction": round(overlap / dev_busy, 4)
            if dev_busy else 0.0,
            "deviceIdleUs": idle,
            "deviceIdleFraction": round(idle / wall, 4)
            if wall else 0.0,
            "bubbles": bubbles}


def bubble_verdict(intervals, occ: Optional[dict] = None
                   ) -> Optional[dict]:
    """The named verdict: the host hop owning the largest share of the
    device-idle wall -- "device idle 71% of execute wall; bubbles
    attributed: connector_read (54%), device_put (17%)". Pure function
    of its inputs (``occ`` may be passed to reuse a computed occupancy
    document). Deterministic tiebreak rides the bubble ordering: idle
    desc, hop asc. None when no intervals were recorded."""
    if occ is None:
        occ = occupancy(intervals)
    if occ is None:
        return None
    idle_frac = occ["deviceIdleFraction"]
    bubbles = occ["bubbles"]
    if not bubbles:
        return {"hop": "", "idleUs": 0, "share": 0.0,
                "deviceIdleFraction": idle_frac,
                "overlapFraction": occ["overlapFraction"],
                "message": (f"device idle {idle_frac:.0%} of execute "
                            f"wall; no bubbles attributed")}
    top = bubbles[0]
    attributed = ", ".join(f"{b['hop']} ({b['share']:.0%})"
                           for b in bubbles[:3])
    return {"hop": top["hop"], "idleUs": top["idleUs"],
            "share": top["share"],
            "deviceIdleFraction": idle_frac,
            "overlapFraction": occ["overlapFraction"],
            "message": (f"device idle {idle_frac:.0%} of execute "
                        f"wall; bubbles attributed: {attributed}")}


def ascii_gantt(intervals, width: int = 48) -> List[str]:
    """One fixed-width Gantt row per lane ('#' busy, '.' idle), the
    EXPLAIN ANALYZE tail's rendering. Pure function of its inputs."""
    ivs = [_as_interval(iv) for iv in intervals]
    if not ivs:
        return []
    w0 = min(iv.t0_us for iv in ivs)
    w1 = max(iv.t1_us for iv in ivs)
    span = max(w1 - w0, 1)
    lines = []
    for lane in LANES:
        cells = ["."] * width
        for iv in ivs:
            if iv.lane != lane or iv.t1_us <= iv.t0_us:
                continue
            a = (iv.t0_us - w0) * width // span
            b = -((iv.t1_us - w0) * width // -span)  # ceil
            for c in range(max(a, 0), min(max(b, a + 1), width)):
                cells[c] = "#"
        lines.append(f"{lane:<7}[{''.join(cells)}]")
    return lines


# -- process registry ----------------------------------------------------

# request handlers (/v1/timeline, system tables), engine threads
# (note_query after each run, record_interval's degradation counter)
# and the flight recorder all touch these
_LOCK = OrderedLock("timeline._LOCK")
# query id -> merged slice (the flight-dump cross-link AND the
# /v1/timeline payload); bounded like datapath's query ledgers
_QUERY_SLICES: "collections.OrderedDict[str, TimelineSlice]" = \
    collections.OrderedDict()
_QUERY_SLICES_MAX = 256
# query id -> /v1/trace trace id (the Chrome export cross-link)
_QUERY_TRACE: Dict[str, str] = {}
# lifetime counters (stable zero shape from process start)
_TOTALS = {"intervals": 0, "dropped": 0, "queries": 0, "degraded": 0}
# the last finalized query's occupancy headline (metrics gauges +
# read this; {} until the first query lands)
_LAST: Dict[str, object] = {}


def _note_degraded(query_id: Optional[str], exc: Exception) -> None:
    """Count one totals-only degradation; on the FIRST per query
    (query_id non-None) leave the flight-recorder trace. Never
    raises."""
    try:
        with _LOCK:
            _TOTALS["degraded"] += 1
        from ..server.metrics import record_suppressed
        record_suppressed("timeline", "record_interval", exc)
        if query_id is not None:
            from ..server.flight_recorder import record_event
            record_event("timeline_degraded", query_id=query_id,
                         reason=str(exc)[:200])
    except Exception:  # noqa: BLE001 - interpreter teardown
        pass


def note_query(query_id: str, sl: TimelineSlice,
               trace_id: str = "") -> None:
    """Retain one query's slice for flight-dump embeds and the
    /v1/timeline payload (bounded); re-notes of the same query id
    merge (worker task slices stitch). Folds the lifetime counters
    and refreshes the last-query occupancy headline. Never raises --
    the runner calls this on every exit path."""
    if sl is None or sl.is_empty():
        return
    try:
        with _LOCK:
            _TOTALS["intervals"] += len(sl.intervals)
            _TOTALS["dropped"] += sl.dropped
            have = _QUERY_SLICES.get(query_id)
            if have is not None:
                merged = have.merge(sl)
                _QUERY_SLICES[query_id] = merged
                _QUERY_SLICES.move_to_end(query_id)
            else:
                _TOTALS["queries"] += 1
                merged = sl.copy()
                _QUERY_SLICES[query_id] = merged
                while len(_QUERY_SLICES) > _QUERY_SLICES_MAX:
                    old, _ = _QUERY_SLICES.popitem(last=False)
                    _QUERY_TRACE.pop(old, None)
            if trace_id:
                _QUERY_TRACE[query_id] = str(trace_id)
        # occupancy outside the lock: stored slices are replaced on
        # merge, never mutated, so reading `merged` unlocked is safe
        occ = occupancy(merged.intervals)
        if occ is not None:
            with _LOCK:
                _LAST.clear()
                _LAST.update({
                    "queryId": query_id,
                    "overlapFraction": occ["overlapFraction"],
                    "deviceIdleUs": occ["deviceIdleUs"]})
    except Exception as e:  # noqa: BLE001 - accounting must never
        # fail the query it observes
        try:
            from ..server.metrics import record_suppressed
            record_suppressed("timeline", "note_query", e)
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


def timeline_for_query(query_id: str) -> dict:
    """One query's slice as raw local-clock rows plus its occupancy
    and verdict (flight dumps -- same-host post-mortem, where
    monotonic times align)."""
    with _LOCK:
        sl = _QUERY_SLICES.get(query_id)
        tid = _QUERY_TRACE.get(query_id, "")
    if sl is None:
        return {}
    occ = occupancy(sl.intervals)
    return {"intervals": sl.rows(), "dropped": sl.dropped,
            "totals": {h: dict(t) for h, t in sl.totals.items()},
            "occupancy": occ,
            "verdict": bubble_verdict(sl.intervals, occ),
            "traceId": tid}


def last_occupancy() -> dict:
    """The last finalized query's occupancy headline (metrics gauges,
    the statement tier's summary); {} until a query with intervals
    lands."""
    with _LOCK:
        return dict(_LAST)


def timeline_totals() -> Dict[str, int]:
    """Lifetime counters, stable zero shape from process start."""
    with _LOCK:
        return dict(_TOTALS)


def clear_timeline() -> None:
    """Drop the process registry + per-query slices (tests isolate
    state)."""
    with _LOCK:
        _QUERY_SLICES.clear()
        _QUERY_TRACE.clear()
        _LAST.clear()
        for k in _TOTALS:
            _TOTALS[k] = 0


# -- surfaces ------------------------------------------------------------


def _query_entry(sl: TimelineSlice, trace_id: str,
                 now: Optional[int] = None) -> dict:
    occ = occupancy(sl.intervals)
    return {"slice": sl.to_json(now),
            "occupancy": occ,
            "verdict": bubble_verdict(sl.intervals, occ),
            "traceId": trace_id}


def timeline_doc() -> dict:
    """This process's /v1/timeline slice: lifetime counters (zeros
    included -- the shape is stable from the first request on), the
    retained per-query slices (age-form intervals, skew-free) with
    per-query occupancy/verdicts, and the process-lifetime verdict
    over every retained interval."""
    with _LOCK:
        queries = {qid: sl for qid, sl in _QUERY_SLICES.items()}
        traces = dict(_QUERY_TRACE)
    ref = now_us()
    merged_all = TimelineSlice()
    for sl in queries.values():
        merged_all = merged_all.merge(sl)
    return {"processId": _PROCESS_ID,
            "totals": timeline_totals(),
            "queries": {qid: _query_entry(sl, traces.get(qid, ""),
                                          now=ref)
                        for qid, sl in queries.items()},
            "verdict": bubble_verdict(merged_all.intervals)}


def merge_timeline_docs(docs: List[dict],
                        now: Optional[int] = None) -> dict:
    """Fold per-process slices into one cluster view. Slices sharing
    a processId count once (two server shells over one process report
    the same registry); per-query slices merge by the slice law after
    rebasing their age-form intervals onto ONE receiver clock (worker
    slices of the SAME query stitch, skew-free by construction);
    totals sum; every occupancy/verdict is recomputed over the merged
    intervals -- order-independent throughout."""
    ref = now_us() if now is None else int(now)
    seen = set()
    queries: Dict[str, TimelineSlice] = {}
    traces: Dict[str, str] = {}
    totals = {k: 0 for k in ("intervals", "dropped", "queries",
                             "degraded")}
    for doc in docs:
        pid = doc.get("processId") or f"anon-{id(doc):x}"
        if pid in seen:
            continue
        seen.add(pid)
        for qid, entry in (doc.get("queries") or {}).items():
            sl = TimelineSlice.from_json(entry.get("slice") or {},
                                         now=ref)
            queries[qid] = queries[qid].merge(sl) if qid in queries \
                else sl
            if entry.get("traceId") and qid not in traces:
                traces[qid] = str(entry["traceId"])
        for k in totals:
            totals[k] += int((doc.get("totals") or {}).get(k, 0))
    merged_all = TimelineSlice()
    for sl in queries.values():
        merged_all = merged_all.merge(sl)
    return {"totals": totals,
            "queries": {qid: _query_entry(sl, traces.get(qid, ""),
                                          now=ref)
                        for qid, sl in queries.items()},
            "verdict": bubble_verdict(merged_all.intervals)}


def cluster_timeline_doc(worker_urls=(), timeout: float = 3.0) -> dict:
    """The coordinator-side merge: this process's slice plus every
    reachable worker's ``GET /v1/timeline``, folded per query by the
    slice law. Pulls ride the shared best-effort helper
    (server/client.pull_worker_docs) so bearer/TLS/trace headers --
    and the skip-and-count-dead-workers contract -- stay identical to
    the /v1/datapath and /v1/accuracy merges'."""
    from ..server.client import pull_worker_docs
    pulled, workers_seen = pull_worker_docs(
        worker_urls, timeout, lambda c: c.timeline(), "timeline")
    merged = merge_timeline_docs([timeline_doc(), *pulled])
    return {"processId": _PROCESS_ID, "cluster": True,
            "workersPulled": workers_seen, **merged}


def snapshot() -> List[dict]:
    """Per-(query, lane) occupancy rows across the retained queries
    (the system.occupancy table): insertion order by query, catalog
    order within one query."""
    with _LOCK:
        queries = {qid: sl for qid, sl in _QUERY_SLICES.items()}
    rows = []
    for qid, sl in queries.items():
        occ = occupancy(sl.intervals)
        if occ is None:
            continue
        verdict = bubble_verdict(sl.intervals, occ)
        for lane in LANES:
            rows.append({
                "queryId": qid, "lane": lane,
                "busyUs": occ["lanes"][lane]["busyUs"],
                "busyFraction": occ["lanes"][lane]["busyFraction"],
                "wallUs": occ["wallUs"],
                "overlapFraction": occ["overlapFraction"],
                "deviceIdleUs": occ["deviceIdleUs"],
                "bubbleHop": verdict["hop"] if verdict else ""})
    return rows


def timeline_summary() -> dict:
    """The cheap statement-tier embed: lifetime interval counters and
    the last finalized query's occupancy headline -- no per-interval
    payload."""
    totals = timeline_totals()
    last = last_occupancy()
    return {"queries": totals["queries"],
            "intervals": totals["intervals"],
            "dropped": totals["dropped"],
            "overlapFraction": float(last.get("overlapFraction", 0.0)),
            "deviceIdleUs": int(last.get("deviceIdleUs", 0))}


# -- Chrome trace export -------------------------------------------------


def to_chrome_trace(doc: dict) -> dict:
    """A /v1/timeline document -> Chrome trace-event JSON (the
    Perfetto-loadable format): one ``pid`` per query, one ``tid`` per
    lane, one complete ``"ph": "X"`` span per interval, each span's
    ``args`` carrying the query's /v1/trace traceId (the cross-link).
    Age-form intervals rebase onto a shared zero so every ``ts`` is
    non-negative. Pure function of the document."""
    queries = doc.get("queries") or {}
    parsed = {}
    extent = 0
    for qid, entry in queries.items():
        sl = TimelineSlice.from_json(entry.get("slice") or {}, now=0)
        parsed[qid] = (sl, str(entry.get("traceId") or qid))
        for iv in sl.intervals:
            extent = max(extent, -iv.t0_us)
    events = []
    for pid, qid in enumerate(sorted(parsed), start=1):
        sl, tid = parsed[qid]
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": qid}})
        for li, lane in enumerate(LANES, start=1):
            events.append({"name": "thread_name", "ph": "M",
                           "pid": pid, "tid": li,
                           "args": {"name": lane}})
        for iv in sl.intervals:
            events.append({
                "name": iv.hop, "cat": iv.lane, "ph": "X",
                "ts": iv.t0_us + extent,
                "dur": max(iv.t1_us - iv.t0_us, 0),
                "pid": pid,
                "tid": LANES.index(iv.lane) + 1
                if iv.lane in LANES else 0,
                "args": {"queryId": qid, "traceId": tid,
                         "splitId": iv.split_id, "bytes": iv.bytes}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}
