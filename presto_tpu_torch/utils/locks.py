"""OrderedLock: an instrumented re-entrant lock + the process-wide
lock-order witness.

Counterpart of presto_tpu/utils/locks.py, pure Python and the same
records. Every lock of the port's server and exec tiers that the
reference makes an OrderedLock is one here, under the reference's
name, so the two packages' witnesses speak one node language. The
static proof that the declared order is acyclic (the reference's
tpulint C002 over LOCK_ORDER.json) is ROADMAP item 16b; this module
proves the *executed* order stays consistent at runtime -- the TSan
lock-order algorithm: every thread carries its held-set, every armed
acquire of lock B while holding A records the directed edge A -> B
into a process-wide order graph, and an acquire that would close a
cycle (B is already ordered before A somewhere else in the process's
history) is an inversion -- the interleaving that deadlocks under
load, caught deterministically on the FIRST inconsistent acquisition,
no unlucky schedule required.

Contract (mirrors failpoints.ARMED exactly):

  * ``ARMED`` is ONE module-level bool. Disarmed, ``acquire`` is a
    truth test plus the inner RLock -- no allocation, no thread-local
    touch, no witness lock.
  * Lock identity is the *name*, not the instance: every ``_Task.lock``
    shares one node -- an inversion between two different task
    instances' locks is still an inversion of the discipline.
  * Re-entrant acquires are silent (the name is already in the thread's
    held-set); consistent-order acquires are silent; only an order
    inversion counts.
  * Violations never raise into the server: they bump the process-
    lifetime counter (``presto_tpu_lock_order_violations_total`` on
    both tiers' /v1/metrics via metrics.lock_families), append a
    bounded violation record, and log a ``lock_order_violation``
    flight-recorder event cross-linked to both acquisition paths.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple

__all__ = ["ARMED", "OrderedLock", "arm_witness", "disarm_witness",
           "reset_witness", "witness_violations",
           "witness_violations_total", "witness_edges",
           "witness_held_now"]

# The one module-level bool every acquire reads. True iff the witness
# is armed; flipped only under the witness lock, read lock-free on the
# acquire hot path (a stale read costs one extra no-op or one late
# recording, never a corrupted witness: all witness state mutates under
# _WITNESS_LOCK).
ARMED: bool = False

# -- witness state (process-wide, like the failpoint registry) ----------

_WITNESS_LOCK = threading.Lock()
# established acquisition order: _EDGES[a] = {b: first-evidence} means
# "a was held while b was acquired" (a before b)
_EDGES: Dict[str, Dict[str, dict]] = {}
_VIOLATIONS: List[dict] = []
_MAX_VIOLATIONS = 256
# process-lifetime counter: survives reset_witness() so /v1/metrics
# stays monotonic (reset clears the graph and the record list only)
_TOTAL = {"count": 0}

_tls = threading.local()


def _held() -> List[str]:
    try:
        return _tls.held
    except AttributeError:
        _tls.held = []
        return _tls.held


def arm_witness() -> None:
    global ARMED
    with _WITNESS_LOCK:
        ARMED = True


def disarm_witness() -> None:
    global ARMED
    with _WITNESS_LOCK:
        ARMED = False


def reset_witness() -> None:
    """Clear the order graph and the violation records (tests, chaos
    round boundaries). The lifetime counter is NOT reset -- it feeds a
    monotonic /v1/metrics family."""
    with _WITNESS_LOCK:
        _EDGES.clear()
        del _VIOLATIONS[:]


def witness_violations() -> List[dict]:
    with _WITNESS_LOCK:
        return [dict(v) for v in _VIOLATIONS]


def witness_violations_total() -> int:
    with _WITNESS_LOCK:
        return _TOTAL["count"]


def witness_edges() -> Dict[str, List[str]]:
    """The established order graph, adjacency-list form (debugging and
    the lockgraph script's --witness mode)."""
    with _WITNESS_LOCK:
        return {a: sorted(bs) for a, bs in _EDGES.items()}


def witness_held_now() -> List[str]:
    """This thread's current held-set (outermost first)."""
    return list(_held())


def _site(depth: int = 2) -> str:
    """file:line of the acquiring frame (first frame outside this
    module). Armed-only cost."""
    import sys
    try:
        f = sys._getframe(depth)
        while f is not None and f.f_code.co_filename.endswith("locks.py"):
            f = f.f_back
        if f is None:
            return "?"
        return f"{f.f_code.co_filename}:{f.f_lineno}"
    except Exception:  # pragma: no cover - _getframe absent
        return "?"


def _reach_locked(src: str, dst: str) -> Optional[List[str]]:
    """Path src -> ... -> dst in the established-order graph, or None.
    Caller holds _WITNESS_LOCK."""
    if src not in _EDGES:
        return None
    prev: Dict[str, str] = {}
    stack = [src]
    seen: Set[str] = {src}
    while stack:
        node = stack.pop()
        for nxt in _EDGES.get(node, ()):
            if nxt in seen:
                continue
            prev[nxt] = node
            if nxt == dst:
                path = [dst]
                while path[-1] != src:
                    path.append(prev[path[-1]])
                path.reverse()
                return path
            seen.add(nxt)
            stack.append(nxt)
    return None


def _note_acquired(name: str) -> None:
    """Armed-path bookkeeping for one non-reentrant acquire of `name`
    by this thread: record order edges held -> name, detecting
    inversions BEFORE inserting (the TSan check: an existing
    name ~> held path means some thread acquired these locks in the
    opposite order)."""
    held = _held()
    thread = threading.current_thread().name
    site = _site(3)
    violations: List[dict] = []
    with _WITNESS_LOCK:
        for a in held:
            if a == name:
                continue
            bs = _EDGES.setdefault(a, {})
            if name in bs:
                continue  # consistent with history: silent
            rev = _reach_locked(name, a)
            if rev is None:
                bs[name] = {"site": site, "thread": thread}
                continue
            _TOTAL["count"] += 1
            first = _EDGES.get(rev[0], {}).get(rev[1], {})
            doc = {
                "held": a, "acquiring": name, "thread": thread,
                "site": site,
                # the OTHER acquisition path (the established reverse
                # order) so the report shows both sides of the race
                "reversePath": list(rev),
                "reverseSite": first.get("site", "?"),
                "reverseThread": first.get("thread", "?"),
            }
            if len(_VIOLATIONS) < _MAX_VIOLATIONS:
                _VIOLATIONS.append(doc)
            violations.append(doc)
    held.append(name)
    # flight events OUTSIDE the witness lock (the recorder takes its
    # own lock; the witness must never order itself under it)
    for v in violations:
        try:
            from ..server.flight_recorder import record_event
            record_event("lock_order_violation", held=v["held"],
                         acquiring=v["acquiring"], site=v["site"],
                         reverse=" -> ".join(v["reversePath"]),
                         reverse_site=v["reverseSite"])
        except Exception:
            # the witness must never take a server down; the counter
            # and the violation record already landed
            pass


class OrderedLock:
    """Drop-in re-entrant mutex for the server tier's ``threading.Lock``
    uses (no code in this repo relies on self-deadlock), named after
    its class-attribute identity so the runtime witness and the static
    C002 graph speak the same node language::

        self._tasks_lock = OrderedLock("worker.TaskManager._tasks_lock")

    Works as a ``with`` context manager and supports the
    acquire/release protocol (Condition-compatible: RLock's
    _release_save/_acquire_restore are not exposed, so Condition falls
    back to plain release/acquire -- each re-acquire passing through
    the witness, which is exactly what we want)."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str):
        self.name = str(name)
        self._lock = threading.RLock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got and ARMED:
            if self.name in _held():
                # re-entrant: already ordered at the outer acquire
                _held().append(self.name)
            else:
                _note_acquired(self.name)
        return got

    def release(self) -> None:
        # `getattr` (no allocation) instead of a bare ARMED test: a
        # thread that acquired while armed must shed its held-set entry
        # even if the witness disarmed in between, or a later re-arm
        # would see phantom held locks and report false inversions
        held = getattr(_tls, "held", None)
        if held:
            # remove the innermost occurrence (LIFO discipline is the
            # common case; out-of-order release still stays consistent)
            for i in range(len(held) - 1, -1, -1):
                if held[i] == self.name:
                    del held[i]
                    break
        self._lock.release()

    def __enter__(self) -> "OrderedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def _is_owned(self) -> bool:
        # threading.Condition probes ownership through this when given
        # a foreign lock; without it the fallback (`acquire(0)`) sees
        # the re-entrant inner RLock succeed and concludes NOT owned
        return self._lock._is_owned()

    def locked(self) -> bool:  # parity with threading.Lock
        if self._lock._is_owned():
            # a probing acquire(False) would re-enter the RLock and
            # report our OWN hold as "unlocked"
            return True
        if self._lock.acquire(False):
            self._lock.release()
            return False
        return True

    def __repr__(self) -> str:
        return f"OrderedLock({self.name!r})"
