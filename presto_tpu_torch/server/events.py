"""Event listeners: query lifecycle events fanned out to callables.

Counterpart of presto_tpu/server/events.py (presto-spi's
eventlistener package: QueryCreatedEvent, QueryCompletedEvent, task
completion; EventListenerManager). Events are plain dicts; listeners
register on the process-wide manager. The dispatcher fires
QueryCreated and QueryCompleted around each query and the worker
TaskCompleted. A listener that raises never fails a query: its error
is counted in `listener_errors` and as a suppressed error of
/v1/metrics (server/metrics.py::record_suppressed).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List

__all__ = ["EventListenerManager", "event_listeners"]


class EventListenerManager:
    def __init__(self):
        self._listeners: List[Callable[[str, Dict], None]] = []
        self._lock = threading.RLock()
        self.listener_errors = 0

    def register(self, listener: Callable[[str, Dict], None]):
        """listener(event_name, payload); returns its unregister."""
        with self._lock:
            self._listeners.append(listener)

        def unregister():
            with self._lock:
                try:
                    self._listeners.remove(listener)
                except ValueError:
                    pass
        return unregister

    def fire(self, name: str, payload: Dict):
        payload = dict(payload)
        payload.setdefault("timestampMs", int(time.time() * 1000))
        with self._lock:
            listeners = list(self._listeners)
        for cb in listeners:
            try:
                cb(name, payload)
            except Exception as e:  # noqa: BLE001 - observers never fail
                # queries
                with self._lock:
                    self.listener_errors += 1
                from .metrics import record_suppressed
                record_suppressed("events", name, e)

    def query_created(self, query_id: str, text: str = "", user: str = ""):
        self.fire("QueryCreated", {"queryId": query_id, "query": text,
                                   "user": user})

    def query_completed(self, query_id: str, state: str, rows: int = 0,
                        wall_s: float = 0.0, error: str = ""):
        self.fire("QueryCompleted", {"queryId": query_id, "state": state,
                                     "outputRows": rows,
                                     "wallTimeSeconds": wall_s,
                                     "error": error})

    def task_completed(self, task_id: str, state: str, rows: int = 0):
        self.fire("TaskCompleted", {"taskId": task_id, "state": state,
                                    "outputRows": rows})


_MANAGER = EventListenerManager()


def event_listeners() -> EventListenerManager:
    """The process-wide manager."""
    return _MANAGER
