"""Structured log correlation: every engine log record carries the
ambient trace/query identity.

Counterpart of presto_tpu/utils/log.py, the same record factory,
filter and JSON line shape; the engine logger is `presto_tpu_torch`.

Opt-in JSON logs (``PRESTO_TPU_LOG_JSON=1`` at server construction):
one JSON object per line on stderr -- ``{ts, level, logger, message,
trace_id, query_id}`` -- the shape a log pipeline joins against
``GET /v1/trace/{traceId}`` without a parse rule per format.

Everything here is idempotent and never raises: logging setup runs in
server constructors, including test suites that build hundreds.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Optional, Tuple

__all__ = ["ensure_log_context", "TraceContextFilter", "JsonFormatter",
           "ambient_ids", "LOG_JSON_ENV"]

LOG_JSON_ENV = "PRESTO_TPU_LOG_JSON"

_ENGINE_LOGGER = "presto_tpu_torch"

_install_lock = threading.Lock()
# the record factory this module installed last (None: not yet)
_factory = None
_json_handler: Optional[logging.Handler] = None
_prev_propagate = True


def ambient_ids() -> Tuple[str, str]:
    """(trace_id, query_id) of the calling thread's ambient query, empty
    strings when none: the tracing context covers coordinator/worker
    hops, the stats collector covers the engine's execution scope."""
    trace_id = query_id = ""
    try:
        from ..server.tracing import current_context
        ctx = current_context()
        if ctx is not None:
            trace_id = ctx.trace_id
    except Exception:  # noqa: BLE001 - log plumbing must never raise
        pass
    try:
        from ..exec.stats import current_collector
        c = current_collector()
        if c is not None:
            query_id = c.query_id
    except Exception:  # noqa: BLE001 - as above
        pass
    return trace_id, query_id


class TraceContextFilter(logging.Filter):
    """Handler-attachable variant of the same injection (for foreign
    handlers that want the fields without the process-wide factory)."""

    def filter(self, record: logging.LogRecord) -> bool:
        if not getattr(record, "trace_id", None):
            record.trace_id, record.query_id = ambient_ids()
        return True


class JsonFormatter(logging.Formatter):
    """One JSON object per line, correlation ids included."""

    def format(self, record: logging.LogRecord) -> str:
        doc = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
            "trace_id": getattr(record, "trace_id", "") or "",
            "query_id": getattr(record, "query_id", "") or "",
        }
        if record.exc_info:
            doc["exc"] = self.formatException(record.exc_info)
        return json.dumps(doc, default=str)


def ensure_log_context() -> None:
    """Install the correlating record factory (once per process) and,
    when ``PRESTO_TPU_LOG_JSON`` is set truthy, a JSON stderr handler on
    the engine's root logger. Idempotent; never raises."""
    global _factory, _json_handler, _prev_propagate
    try:
        with _install_lock:
            # (re)installed on top whenever another factory was set over
            # it: the reference's, in a process that runs both packages,
            # stamps its own (empty) ids over the port's
            if logging.getLogRecordFactory() is not _factory:
                prev = logging.getLogRecordFactory()

                def factory(*args, _prev=prev, **kwargs):
                    record = _prev(*args, **kwargs)
                    trace_id, query_id = ambient_ids()
                    # an id another factory below found stays when this
                    # package has none
                    record.trace_id = trace_id or \
                        getattr(record, "trace_id", "") or ""
                    record.query_id = query_id or \
                        getattr(record, "query_id", "") or ""
                    return record

                logging.setLogRecordFactory(factory)
                _factory = factory
            want_json = os.environ.get(LOG_JSON_ENV, "") \
                not in ("", "0", "false")
            logger = logging.getLogger(_ENGINE_LOGGER)
            if want_json and _json_handler is None:
                h = logging.StreamHandler()
                h.setFormatter(JsonFormatter())
                h.addFilter(TraceContextFilter())
                logger.addHandler(h)
                # stop propagation while the JSON handler owns the
                # stream: a configured root handler would otherwise
                # re-emit every engine record as plain text, breaking
                # the one-JSON-object-per-line contract
                _prev_propagate = logger.propagate
                logger.propagate = False
                _json_handler = h
            elif not want_json and _json_handler is not None:
                logger.removeHandler(_json_handler)
                logger.propagate = _prev_propagate
                _json_handler = None
    except Exception:  # noqa: BLE001 - logging setup must never take
        # down a server constructor; worst case logs stay uncorrelated
        pass
