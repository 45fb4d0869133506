"""The query state machine: QueryStateMachine.

Counterpart of presto_tpu/server/query_state.py (presto-main-base's
execution/QueryStateMachine.java): QUEUED -> PLANNING -> RUNNING ->
FINISHING -> FINISHED, with FAILED and CANCELED reachable from any
state that is not terminal. Transitions only go forward, terminal
states latch, listeners hear every transition (called outside the
lock) and each state's entry time is kept.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ..utils.locks import OrderedLock

__all__ = ["QueryState", "QueryStateMachine", "TERMINAL_STATES"]


class QueryState:
    QUEUED = "QUEUED"
    PLANNING = "PLANNING"
    RUNNING = "RUNNING"
    FINISHING = "FINISHING"
    FINISHED = "FINISHED"
    FAILED = "FAILED"
    CANCELED = "CANCELED"


_ORDER = [QueryState.QUEUED, QueryState.PLANNING, QueryState.RUNNING,
          QueryState.FINISHING, QueryState.FINISHED]
TERMINAL_STATES = (QueryState.FINISHED, QueryState.FAILED,
                   QueryState.CANCELED)


class QueryStateMachine:
    """A query's lifecycle with listeners and per-state entry times."""

    # transition state is written only under the machine lock; listener
    # CALLS happen outside it by contract (tpulint C001 checks writes)
    _GUARDED_BY = {"_lock": ("_state", "_entered", "_listeners",
                             "_error")}

    def __init__(self, query_id: str):
        self.query_id = query_id
        self._lock = OrderedLock("query_state.QueryStateMachine._lock")
        self._state = QueryState.QUEUED
        self._entered: Dict[str, float] = {QueryState.QUEUED: time.time()}
        self._listeners: List[Callable[[str, str], None]] = []
        self._error: Optional[dict] = None
        self._done = threading.Event()

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def error(self) -> Optional[dict]:
        with self._lock:
            return self._error

    def is_done(self) -> bool:
        return self.state in TERMINAL_STATES

    def add_listener(self, fn: Callable[[str, str], None]) -> None:
        """fn(old_state, new_state), called outside the lock."""
        with self._lock:
            self._listeners.append(fn)

    def _advance(self, new: str) -> bool:
        with self._lock:
            old = self._state
            if old in TERMINAL_STATES:
                return False
            if new in _ORDER and old in _ORDER and \
                    _ORDER.index(new) <= _ORDER.index(old):
                return False
            self._state = new
            self._entered[new] = time.time()
            listeners = list(self._listeners)
        for fn in listeners:
            fn(old, new)
        if new in TERMINAL_STATES:
            self._done.set()
        return True

    def to_planning(self) -> bool:
        return self._advance(QueryState.PLANNING)

    def to_running(self) -> bool:
        return self._advance(QueryState.RUNNING)

    def to_finishing(self) -> bool:
        return self._advance(QueryState.FINISHING)

    def to_finished(self) -> bool:
        return self._advance(QueryState.FINISHED)

    def to_failed(self, error: dict) -> bool:
        with self._lock:
            if self._state in TERMINAL_STATES:
                return False
            self._error = error
        return self._advance(QueryState.FAILED)

    def to_canceled(self) -> bool:
        return self._advance(QueryState.CANCELED)

    def wait_done(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def wait_past_queued(self, timeout: float) -> None:
        """The queued resource's long poll: wait up to `timeout` s for
        the query to leave QUEUED."""
        deadline = time.time() + timeout
        while self.state == QueryState.QUEUED and time.time() < deadline:
            time.sleep(0.01)

    def timings(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._entered)

    def elapsed_ms(self) -> int:
        with self._lock:
            start = self._entered[QueryState.QUEUED]
            end = self._entered[self._state] \
                if self._state in TERMINAL_STATES else time.time()
        return int((end - start) * 1000)
