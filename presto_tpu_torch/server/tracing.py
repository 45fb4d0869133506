"""Distributed tracer SPI: per-query span trees, cross-tier stitching.

Counterpart of presto_tpu/server/tracing.py: the same span documents,
header and W3C `traceparent` form, so a trace stitches across the
two packages' tiers.

Reference surface: presto-spi/.../spi/tracing/Tracer.java +
TracerProviderManager (default SimpleTracer), the OpenTelemetry plugin
(spans at query state transitions, tracing/QueryStateTracingListener),
and the W3C trace-context recommendation the OTel HTTP instrumentation
speaks (``traceparent: 00-<trace>-<span>-01``). This engine carries the
same shape on an ``X-Presto-Trace`` header: the statement client mints
a context per statement, the coordinator re-parents one child context
per plan fragment into each TaskUpdateRequest, and workers hang their
task + stage spans under it -- so a distributed query stitches into ONE
trace with valid parent edges, served at ``GET /v1/trace/{queryId}``.

Spans export as plain dicts (OTel file-exporter shape)::

    {"traceId", "spanId", "parentId", "name", "startUs", "endUs",
     "attributes"}

Every emission site routes through :func:`emit_span`, which delivers to
the installed process tracer AND any thread-local :class:`SpanBuffer`
(the worker's ship-spans-home piggyback), and NEVER raises: a broken
tracer is counted (``presto_tpu_trace_spans_dropped_total`` +
``suppressed_errors_total{component=tracing}``), the query survives.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import threading
import time
import uuid
from typing import Dict, List, Optional

from ..utils.locks import OrderedLock


__all__ = ["RecordingTracer", "set_tracer", "get_tracer",
           "spans_from_state_timings", "TraceContext", "TRACE_HEADER",
           "new_trace_id", "new_span_id", "parse_traceparent",
           "emit_span", "SpanBuffer", "span_buffer",
           "trace_context", "current_context", "tracing_totals"]

TRACE_HEADER = "X-Presto-Trace"


def new_trace_id() -> str:
    """32-hex trace id (the W3C trace-id width)."""
    return uuid.uuid4().hex


def new_span_id() -> str:
    """16-hex span id (the W3C parent-id width)."""
    return uuid.uuid4().hex[:16]


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One hop's identity: which trace, and which span is the parent of
    whatever the receiving tier records next."""
    trace_id: str
    span_id: str

    def child(self) -> "TraceContext":
        """Same trace, fresh span id -- the context a tier passes DOWN
        after recording its own span under ``span_id``."""
        return TraceContext(self.trace_id, new_span_id())

    def header(self) -> str:
        """W3C-traceparent-style header value."""
        return f"00-{self.trace_id}-{self.span_id}-01"


def parse_traceparent(value: Optional[str]) -> Optional[TraceContext]:
    """``00-<trace>-<span>-<flags>`` -> TraceContext, tolerantly: the
    trace id may be any dashless token (legacy ``query.<qid>`` ids ride
    the same header), and anything unparseable returns None rather than
    failing the request that carried it."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) < 4:
        return None
    trace_id = "-".join(parts[1:-2])  # tolerate future dashed trace ids
    span_id = parts[-2]
    if not trace_id or not span_id:
        return None
    return TraceContext(trace_id, span_id)


# -- process-lifetime counters (exported on /v1/metrics, both tiers) ----

_COUNTERS_LOCK = OrderedLock("tracing._COUNTERS_LOCK")
_COUNTERS = {"spans": 0, "evicted": 0, "dropped": 0}


def _count(name: str, delta: int = 1) -> None:
    with _COUNTERS_LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + delta


def tracing_totals() -> Dict[str, int]:
    """{spans, evicted, dropped} recorded since process start."""
    with _COUNTERS_LOCK:
        return dict(_COUNTERS)


class RecordingTracer:
    """SimpleTracer analog: keeps span trees per trace id in memory.

    Eviction is least-recently-UPDATED: a trace still receiving spans
    (a long distributed query whose tasks trickle in) is refreshed on
    every span, so the trace dropped at capacity is deterministically
    the one idle longest -- not whichever dict order happened to yield
    (a trace created early but still active used to be evictable)."""


    def __init__(self, max_traces: int = 256,
                 max_spans_per_trace: int = 4096):
        self.traces: "collections.OrderedDict[str, List[dict]]" = \
            collections.OrderedDict()
        self.max_traces = max_traces
        # trace ids are client-controlled (X-Presto-Trace): a client
        # reusing ONE traceparent across a whole session keeps its entry
        # hot (never the LRU victim), so per-trace growth needs its own
        # bound; overflow is counted as dropped
        self.max_spans_per_trace = max_spans_per_trace
        self._lock = OrderedLock("tracing.RecordingTracer._lock")

    def span(self, trace_id: str, name: str, start_s: float, end_s: float,
             attributes: Optional[dict] = None,
             span_id: Optional[str] = None,
             parent_id: Optional[str] = None) -> str:
        """Record one span; returns its span id (minted when absent)."""
        doc = {"traceId": trace_id,
               "spanId": span_id or new_span_id(),
               "parentId": parent_id,
               "name": name,
               "startUs": int(start_s * 1_000_000),
               "endUs": int(end_s * 1_000_000),
               "attributes": dict(attributes or {})}
        self._append(trace_id, [doc])
        return doc["spanId"]

    def add_spans(self, trace_id: str, docs: List[dict]) -> int:
        """Stitch pre-built span docs (a worker's shipped-home spans)
        into `trace_id`, deduplicating by spanId so the piggyback is
        idempotent when worker and coordinator share a process tracer.
        Returns the number of NEW spans added."""
        cleaned = []
        for d in docs:
            if not isinstance(d, dict) or "spanId" not in d:
                continue
            try:
                # a foreign-build span missing/garbling its timestamps
                # must not poison trace_doc's start-ordering later
                start, end = int(d["startUs"]), int(d["endUs"])
            except (KeyError, TypeError, ValueError):
                continue
            cleaned.append({**d, "traceId": trace_id,
                            "startUs": start, "endUs": end})
        return self._append(trace_id, cleaned, dedup=True)

    def _append(self, trace_id: str, docs: List[dict],
                dedup: bool = False) -> int:
        added = 0
        dropped = 0
        with self._lock:
            if trace_id in self.traces:
                self.traces.move_to_end(trace_id)
            elif len(self.traces) >= self.max_traces:
                self.traces.popitem(last=False)  # oldest-updated out
                _count("evicted")
            spans = self.traces.setdefault(trace_id, [])
            seen = {s["spanId"] for s in spans} if dedup else ()
            for doc in docs:
                if dedup and doc["spanId"] in seen:
                    continue
                if len(spans) >= self.max_spans_per_trace:
                    dropped += 1
                    continue
                spans.append(doc)
                added += 1
        if added:
            _count("spans", added)
        if dropped:
            _count("dropped", dropped)
        return added

    def spans(self, trace_id: str) -> List[dict]:
        with self._lock:
            return list(self.traces.get(trace_id, []))

    def trace_doc(self, trace_id: str) -> Optional[dict]:
        """The one-trace-per-query document ``GET /v1/trace/{queryId}``
        serves: every stitched span, start-ordered."""
        spans = self.spans(trace_id)
        if not spans:
            return None
        spans.sort(key=lambda s: (s["startUs"], -s["endUs"]))
        return {"traceId": trace_id, "spanCount": len(spans),
                "spans": spans}

    def export_jsonl(self, path: str) -> int:
        """Write every retained span as one JSON line ({traceId, spanId,
        parentId, name, startUs, endUs, attributes}) for offline
        inspection (OTel file-exporter shape); returns the span count
        written."""
        with self._lock:
            snapshot = [(tid, list(spans))
                        for tid, spans in self.traces.items()]
        n = 0
        with open(path, "w") as f:
            for tid, spans in snapshot:
                for doc in spans:
                    f.write(json.dumps({"traceId": tid, **doc},
                                       default=str) + "\n")
                    n += 1
        return n


_tracer: Optional[RecordingTracer] = None


def set_tracer(tracer) -> None:
    """Install the process tracer (None disables tracing)."""
    global _tracer
    _tracer = tracer


def get_tracer():
    return _tracer


def trace_doc_of(tracer, trace_id: str) -> Optional[dict]:
    """The stitched trace document for `trace_id`, or None. trace_doc
    is OPTIONAL on the tracer SPI (only span() is promised): a foreign
    span()-only exporter degrades to not-found everywhere — the
    /v1/trace endpoints' 404, cli --trace's no-spans message — instead
    of an AttributeError in a request handler."""
    fetch = getattr(tracer, "trace_doc", None) if tracer is not None \
        else None
    return fetch(trace_id) if fetch is not None else None


# -- thread-local span sinks + ambient trace context --------------------

_tls = threading.local()


class SpanBuffer:
    """Collects span docs emitted on this thread, independent of the
    process tracer -- the worker wraps task execution in one so its
    local spans can ship back to the coordinator on the final task
    status (the stitch's transport)."""

    def __init__(self):
        self.spans: List[dict] = []


class span_buffer:
    """Context manager: install a SpanBuffer as an additional sink for
    every emit_span on this thread."""

    def __init__(self, buf: Optional[SpanBuffer] = None):
        self.buf = buf or SpanBuffer()

    def __enter__(self) -> SpanBuffer:
        stack = getattr(_tls, "sinks", None)
        if stack is None:
            stack = _tls.sinks = []
        stack.append(self.buf)
        return self.buf

    def __exit__(self, *exc):
        _tls.sinks.pop()
        return False


class trace_context:
    """Context manager: install `ctx` as this thread's ambient trace
    context, so outbound HTTP (WorkerClient) stamps X-Presto-Trace on
    every hop it makes on the thread's behalf."""

    def __init__(self, ctx: Optional[TraceContext]):
        self.ctx = ctx

    def __enter__(self):
        self.prev = getattr(_tls, "ctx", None)
        _tls.ctx = self.ctx
        return self.ctx

    def __exit__(self, *exc):
        _tls.ctx = self.prev
        return False


def current_context() -> Optional[TraceContext]:
    return getattr(_tls, "ctx", None)


def emit_span(trace_id: str, name: str, start_s: float, end_s: float,
              attributes: Optional[dict] = None,
              span_id: Optional[str] = None,
              parent_id: Optional[str] = None) -> Optional[str]:
    """The one span-emission seam: deliver to the process tracer and
    any thread-local SpanBuffer. Returns the span id (None when nothing
    was recorded anywhere). Never raises -- a tracer that throws is
    counted (dropped + suppressed) and the query proceeds."""
    sid = span_id or new_span_id()
    doc = {"traceId": trace_id, "spanId": sid, "parentId": parent_id,
           "name": name,
           "startUs": int(start_s * 1_000_000),
           "endUs": int(end_s * 1_000_000),
           "attributes": dict(attributes or {})}
    delivered = False
    for buf in getattr(_tls, "sinks", ()) or ():
        buf.spans.append(doc)
        delivered = True
    t = get_tracer()
    if t is not None:
        try:
            t.span(trace_id, name, start_s, end_s, attributes,
                   span_id=sid, parent_id=parent_id)
            delivered = True
        except Exception as e:  # noqa: BLE001 - tracing must never fail
            # a query; a tracer that stops accepting spans shows up on
            # /v1/metrics as drops + a suppressed-error sample
            if isinstance(e, TypeError):
                # a pluggable tracer with the pre-span-id 5-argument
                # span() SPI: deliver without ids rather than dropping
                # every span of the deployment on the floor
                try:
                    t.span(trace_id, name, start_s, end_s, attributes)
                    return sid
                except Exception as legacy_e:  # noqa: BLE001
                    e = legacy_e
            _count("dropped")
            from .metrics import record_suppressed
            record_suppressed("tracing", "span", e)
    return sid if delivered else None


def spans_from_state_timings(trace_id: str, timings: Dict[str, float],
                             order: List[str],
                             attributes: Optional[dict] = None,
                             parent_id: Optional[str] = None) -> None:
    """State-machine enter-times -> one span per state (the
    QueryStateTracingListener shape): each state's span runs from its
    enter time to the next entered state's (or now). With `parent_id`,
    every state span hangs under that span (the query root)."""
    entered = [(s, timings[s]) for s in order if s in timings]
    entered.sort(key=lambda x: x[1])
    for i, (state, start) in enumerate(entered):
        end = entered[i + 1][1] if i + 1 < len(entered) else time.time()
        # span.kind=state: these ANNOTATE the query root's own window
        # (a second decomposition of the same time the work spans
        # cover), so critical-path attribution must not let them
        # shadow the real work tree (traceview skips state spans)
        emit_span(trace_id, f"query.{state.lower()}", start, end,
                  {**(attributes or {}), "span.kind": "state"},
                  parent_id=parent_id)
