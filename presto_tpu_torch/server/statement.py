"""The client statement protocol: POST /v1/statement and nextUri.

Counterpart of presto_tpu/server/statement.py (QueuedStatementResource
`POST /v1/statement` -> QueryResults with a `nextUri` into the queued
resource, then ExecutingStatementResource; StatementClientV1's
advance() follows `nextUri` until it is gone). The documents carry
{id, infoUri, nextUri, columns, data, stats, error, updateType,
updateCount}; session changes ride the response headers
(X-Presto-Set-Session, X-Presto-Started-Transaction-Id,
X-Presto-Clear-Transaction-Id).

Queries admit through the Dispatcher (resource groups and events),
run in a transaction of the TransactionManager, move through a
QueryStateMachine, and execute on a thread of their own through the
port's `sql()` on the server's device (CUDA unless the caller passes
device="cpu"). A statement first offers itself to the batching
executor (exec/batching.py): co-batchable statements that form a batch
run as one batched dispatch on the same device, and the rest run
serially. Results page out `page_rows` rows a nextUri
hop, rendered by the reference's JSON conventions (decimals, dates and
timestamps as strings).

  POST   /v1/statement                         a statement
  GET    /v1/statement/{queued|executing}/{id}/{slug}/{token}
  DELETE /v1/statement/.../{id}/{slug}/...     cancel
  GET    /v1/query, /v1/query/{id}             the queries' documents
  GET    /v1/info                              the coordinator's info
  GET    /v1/cluster                           the fleet overview
  GET    /v1/metrics                           Prometheus text (or
                                               OpenMetrics on Accept)
  GET    /v1/{profile,history,datapath,accuracy,timeline}
                                               the ledgers, this
                                               process's slice merged
                                               with every worker's of
                                               `profile_workers`
  GET    /v1/trace/{queryId}                   the stitched trace
  GET    /ui, /ui/query/{id}                   the web pages
  GET, POST, DELETE /v1/failpoint              the failpoint admin

EXPLAIN renders the plan as execution shapes it, each node tagged with
its pipeline region and the regions listed after it, EXPLAIN ANALYZE
runs it and annotates it (plan/explain.py), each as one varchar column. A
statement carries a trace: the client's `X-Presto-Trace` context when
one came, else the query id; the query's root span, its state spans,
the engine's stage spans and the client's fetch span hang in it. The
live progress of every statement (exec/progress.py) rides its `stats`
while it runs; a stuck-progress watchdog (server/watchdog.py) scans
the running ones. At its end each statement is accounted on
/v1/metrics, dumped by the flight recorder when it failed or ran past
`slow_query_threshold_ms`, and archived in the query history.

With `tls=(cert, key)` the server speaks https. For a standby
coordinator (server/resource_manager.py), `inflight_doc` lists the
statements not yet done (the manifest a ClusterStateSender heartbeats)
and `adopt_query` runs one of a lapsed primary's statements here under
its original id and slug, once.
"""

from __future__ import annotations

import html
import json
import re
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np

from .. import failpoints
from .. import types as T
from ..block import resolve_device
from ..transaction import TransactionManager
from .dispatcher import Dispatcher, QueryRejected
from .flight_recorder import get_flight_recorder, record_event
from .query_state import TERMINAL_STATES, QueryState, QueryStateMachine
from .tracing import TraceContext, new_span_id
from ..utils.locks import OrderedLock

__all__ = ["StatementServer", "render_value"]

# the cluster-merged ledger routes: path -> StatementServer method
_LEDGER_DOCS = {"profile": "profile_doc", "history": "history_doc",
                "datapath": "datapath_doc", "accuracy": "accuracy_doc",
                "timeline": "timeline_doc"}


def _max_q_error_of(query_id: str):
    """Worst finalized q-error of one query id, or None."""
    from ..exec.accuracy import query_max_q_error
    q = query_max_q_error(query_id)
    return round(q, 2) if q is not None else None


def render_value(v, null: bool, ty: T.Type):
    """An engine value -> client JSON (decimals and temporals as
    strings, as the reference renders them)."""
    if null or v is None:
        return None
    if ty.is_decimal:
        s = ty.scale
        v = int(v)
        if s == 0:
            return str(v)
        sign = "-" if v < 0 else ""
        a = abs(v)
        return f"{sign}{a // 10**s}.{a % 10**s:0{s}d}"
    if ty.base == "date":
        return str(np.datetime64("1970-01-01") + int(v))
    if ty.base == "timestamp":
        base = np.datetime64("1970-01-01T00:00:00") + \
            np.timedelta64(int(v), "us")
        return str(base).replace("T", " ")
    if ty.base == "array":
        return [render_value(e, e is None, ty.element_type) for e in v]
    if ty.is_floating:
        return float(v)
    if ty.base == "boolean":
        return bool(v)
    if ty.is_integral:
        return int(v)
    return str(v)


_ERROR_CODES = {
    "SYNTAX_ERROR": (1, "USER_ERROR"),
    "USER_CANCELED": (20000, "USER_ERROR"),
    "QUERY_QUEUE_FULL": (131075, "INSUFFICIENT_RESOURCES"),
    "GENERIC_INTERNAL_ERROR": (65536, "INTERNAL_ERROR"),
}


def _error_doc(name: str, message: str) -> dict:
    code, etype = _ERROR_CODES.get(name,
                                   _ERROR_CODES["GENERIC_INTERNAL_ERROR"])
    return {"message": message, "errorCode": code, "errorName": name,
            "errorType": etype,
            "failureInfo": {"type": name, "message": message}}


class _Query:
    """One statement's lifecycle and its rendered rows."""

    def __init__(self, query_id: str, slug: str, text: str,
                 session_values: Dict, user: str, txn_id: Optional[str],
                 client_ctx: Optional[TraceContext] = None):
        self.id = query_id
        self.slug = slug
        self.text = text
        self.session_values = session_values
        self.user = user
        self.txn_id = txn_id
        self.machine = QueryStateMachine(query_id)
        # the query's trace: the client's trace id when one came, else
        # the query id; span_id is the query's root span
        self.trace_ctx = TraceContext(
            client_ctx.trace_id if client_ctx else query_id, new_span_id())
        self.client_parent = client_ctx.span_id if client_ctx else None
        self.columns: Optional[List[dict]] = None
        self.rows: List[list] = []
        # the client's drain of the results (the trace's client.fetch)
        self.first_fetch_at: Optional[float] = None
        self.fetch_span_done = False
        self.update_type: Optional[str] = None
        self.update_count: Optional[int] = None
        # the engine's QueryStats and flat QueryResult.stats once it ran
        self.result_stats = None
        self.runtime_stats: Optional[Dict[str, float]] = None
        # the client-visible progress never goes back (its high-water
        # marks, per query)
        self.progress_hwm = {"pct": 0.0, "rows": 0, "bytes": 0,
                             "peak": 0}
        # response-header changes for the client to apply
        self.set_session: Dict[str, str] = {}
        self.started_txn: Optional[str] = None
        self.clear_txn = False
        # the resource group the dispatcher routed the query to
        self.resource_group = ""
        # the size of the batch that served it (0: it ran serially)
        self.batch_size = 0


_SESSION_STMT = re.compile(
    r"\s*(start\s+transaction|commit|rollback|set\s+session)\b",
    re.IGNORECASE)
_WRITE_STMT = re.compile(
    r"\s*(insert|create\s+table|drop\s+table|delete|update)\b",
    re.IGNORECASE)
_UPDATE_TYPES = {"INSERT": "INSERT", "CREATE TABLE": "CREATE TABLE AS",
                 "DROP TABLE": "DROP TABLE", "DELETE": "DELETE",
                 "UPDATE": "UPDATE"}


class StatementServer:
    """The coordinator's statement resource over the port's engine, or
    over any `executor(text, session_values, query_id, txn_id)` that
    returns a QueryResult; by default the statement runs through
    `sql()` on `device`. The server binds 127.0.0.1:`port` (0: a free
    port) and serves from a thread of its own after `start()`."""

    def __init__(self, port: int = 0, sf: float = 0.01,
                 dispatcher: Optional[Dispatcher] = None,
                 executor=None, page_rows: int = 1024,
                 queue_poll_s: float = 1.0, query_ttl_s: float = 600.0,
                 device=None, tls: Optional[tuple] = None,
                 profile_workers=None):
        """`profile_workers`: the worker base URLs (a list, or a
        callable that returns one) whose ledger slices the /v1/profile,
        /v1/history, /v1/datapath, /v1/accuracy and /v1/timeline routes
        merge with this process's, and whose /v1/status rows
        /v1/cluster probes; None serves this process alone."""
        self.sf = sf
        self.device = resolve_device(device)
        self._profile_workers = profile_workers
        # every engine log record carries the ambient trace/query ids
        from ..utils.log import ensure_log_context
        ensure_log_context()
        from ..sql.statements import PreparedStatements
        # prepared statements per user (the reference scopes them per
        # session)
        self._prepared: Dict[str, PreparedStatements] = {}
        self.page_rows = page_rows
        self.queue_poll_s = queue_poll_s
        self.query_ttl_s = query_ttl_s
        self.dispatcher = dispatcher or Dispatcher()
        self.transactions = TransactionManager()
        self._executor = executor or self._default_executor
        self._queries: Dict[str, _Query] = {}
        self._qlock = OrderedLock("statement.StatementServer._qlock")
        self._started_at = time.time()
        # lifetime roll-ups of terminal queries for /v1/metrics
        self._metrics_lock = OrderedLock("statement.StatementServer._metrics_lock")
        self._queries_by_state: Dict[str, int] = {}
        self._totals = {"rows": 0, "bytes": 0, "wall_us": 0,
                        "compile_us": 0, "execute_us": 0,
                        "peak_memory_bytes": 0}
        # the last /v1/cluster probe's view (None: never probed)
        self._workers_alive: Optional[int] = None
        self._workers_draining = 0
        from .watchdog import StuckProgressWatchdog
        self._watchdog = StuckProgressWatchdog(self._stuck_candidates,
                                               tier="statement")
        self._httpd = ThreadingHTTPServer(("127.0.0.1", port),
                                          _make_handler(self))
        scheme = "http"
        if tls is not None:
            from .tls import server_context
            self._httpd.socket = server_context(*tls).wrap_socket(
                self._httpd.socket, server_side=True)
            scheme = "https"
        self.port = self._httpd.server_address[1]
        self.url = f"{scheme}://127.0.0.1:{self.port}"
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "StatementServer":
        from ..connectors.system import register_statement_server
        register_statement_server(self)  # system.queries
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        self._watchdog.start()
        return self

    def stop(self) -> None:
        self._watchdog.stop()
        self._httpd.shutdown()
        self._httpd.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- execution ------------------------------------------------------

    def _default_executor(self, text: str, session_values: Dict,
                          query_id: str, txn_id: Optional[str]):
        from ..exec.runner import QueryResult
        from ..sql import sql as run_sql
        from ..sql.statements import PreparedStatements, preprocess
        sf = float(session_values.get("sf", self.sf))
        kwargs = {}
        if "max_groups" in session_values:
            kwargs["max_groups"] = int(session_values["max_groups"])
        if "join_capacity" in session_values:
            kwargs["join_capacity"] = int(session_values["join_capacity"])
        user = self._user_of(query_id)
        pre = preprocess(text, catalog=session_values.get("catalog", "tpch"),
                         prepared=self._prepared.setdefault(
                             user, PreparedStatements()))
        if pre.ack is not None:
            return QueryResult([], [], [pre.ack], 0)
        session = dict(session_values)
        session.setdefault("user", user)
        # the engine's stage spans hang under the query's root span
        ctx = self._trace_ctx_of(query_id)
        if ctx is not None:
            kwargs["trace_id"] = ctx
        # co-batchable statements that form a batch come back from the
        # batching executor; the rest (not batchable, batching off, no
        # batch formed) run the serial path below
        from ..exec.batching import get_batching_executor
        res = get_batching_executor().try_execute(
            pre.text, sf=sf, session=session, query_id=query_id,
            trace_id=kwargs.get("trace_id"),
            max_groups=kwargs.get("max_groups"),
            join_capacity=kwargs.get("join_capacity"),
            catalog=session_values.get("catalog", "tpch"),
            device=self.device)
        if res is not None:
            return res
        return run_sql(pre.text, sf=sf, device=self.device, session=session,
                       query_id=query_id, **kwargs)

    def _user_of(self, query_id: str) -> str:
        with self._qlock:
            q = self._queries.get(query_id)
        return q.user if q is not None else ""

    def _trace_ctx_of(self, query_id: str) -> Optional[TraceContext]:
        with self._qlock:
            q = self._queries.get(query_id)
        return q.trace_ctx if q is not None else None

    def _emit_trace(self, q: _Query) -> None:
        """The terminal-state hook of the trace: the query's root span
        (queued -> terminal) and one span per state under it."""
        from .tracing import emit_span, get_tracer, spans_from_state_timings
        if get_tracer() is None:
            return
        timings = q.machine.timings()
        start = timings.get(QueryState.QUEUED, time.time())
        end = timings.get(q.machine.state, time.time())
        emit_span(q.trace_ctx.trace_id, "query", start, end,
                  {"queryId": q.id, "user": q.user,
                   "state": q.machine.state, "query": q.text[:200]},
                  span_id=q.trace_ctx.span_id, parent_id=q.client_parent)
        spans_from_state_timings(
            q.trace_ctx.trace_id, timings,
            ["QUEUED", "PLANNING", "RUNNING", "FINISHING", "FINISHED",
             "FAILED"], {"user": q.user}, parent_id=q.trace_ctx.span_id)

    def _reap_locked(self) -> None:
        """Drop terminal queries, and their rows, older than
        query_ttl_s."""
        cutoff = time.time() - self.query_ttl_s
        for qid in [qid for qid, q in self._queries.items()
                    if q.machine.is_done()
                    and q.machine.timings().get(q.machine.state, 0) < cutoff]:
            del self._queries[qid]

    def create_query(self, text: str, user: str, session_values: Dict,
                     txn_id: Optional[str],
                     client_ctx: Optional[TraceContext] = None) -> _Query:
        """Register a statement and start running it."""
        # rule-based defaults under, the client's values over
        from .session_properties import get_session_property_manager
        mgr = get_session_property_manager()
        if mgr is not None:
            session_values = {**mgr.defaults_for(
                user, session_values.get("source", ""),
                session_values.get("clientTags")), **session_values}
        q = _Query(f"{time.strftime('%Y%m%d')}_{uuid.uuid4().hex[:12]}",
                   uuid.uuid4().hex[:12], text, session_values, user, txn_id,
                   client_ctx=client_ctx)
        # every state transition lands in the flight recorder's ring
        q.machine.add_listener(
            lambda old, new, qid=q.id: record_event(
                "query_state", query_id=qid, frm=old, to=new))
        with self._qlock:
            self._reap_locked()
            self._queries[q.id] = q
        threading.Thread(target=self._run, args=(q,), daemon=True).start()
        return q

    def inflight_doc(self) -> List[dict]:
        """One entry for each statement not yet done: the failover
        manifest a ClusterStateSender heartbeats to the resource
        manager, for a StandbyCoordinator to adopt."""
        with self._qlock:
            queries = list(self._queries.values())
        out = []
        for q in queries:
            state = q.machine.state
            if state in TERMINAL_STATES:
                continue
            out.append({"queryId": q.id, "slug": q.slug, "query": q.text,
                        "user": q.user, "state": state,
                        "sessionProperties": q.session_values})
        return out

    def adopt_query(self, query_id: str, slug: str, text: str,
                    user: str, session_values: Dict) -> _Query:
        """Run `text` here under the original query id and slug, so that
        a client that polls this server (through the router, or its url)
        drains the same statement. Idempotent per query id: a failover
        fired again never runs an adopted statement twice."""
        q = _Query(query_id, slug, text, dict(session_values or {}), user,
                   None)
        with self._qlock:
            existing = self._queries.get(query_id)
            if existing is not None:
                return existing
            self._reap_locked()
            self._queries[query_id] = q
        threading.Thread(target=self._run, args=(q,), daemon=True).start()
        return q

    def _run(self, q: _Query):
        try:
            self._run_inner(q)
        finally:
            if q.machine.is_done():
                self._emit_trace(q)
                self._account_query(q)
                self._maybe_flight_dump(q)
                self._record_history(q)

    def _slow_threshold_ms(self, q: _Query) -> float:
        """slow_query_threshold_ms session property, env fallback
        PRESTO_TPU_SLOW_QUERY_MS; 0 or unset: no slow dumps."""
        import os
        raw = q.session_values.get(
            "slow_query_threshold_ms",
            os.environ.get("PRESTO_TPU_SLOW_QUERY_MS", "0"))
        try:
            return float(raw)
        except (TypeError, ValueError):
            return 0.0

    def _maybe_flight_dump(self, q: _Query) -> None:
        """One flight-recorder dump of a failed or slow statement."""
        state = q.machine.state
        reason = None
        if state == QueryState.FAILED:
            reason = "failed"
        else:
            thresh = self._slow_threshold_ms(q)
            if thresh > 0 and q.machine.elapsed_ms() >= thresh:
                reason = "slow"
        if reason is not None:
            get_flight_recorder().maybe_dump(
                q.id, reason,
                extra={"state": state, "user": q.user,
                       "elapsedMs": q.machine.elapsed_ms(),
                       "traceId": q.trace_ctx.trace_id,
                       "query": q.text[:200]})

    def _record_history(self, q: _Query) -> None:
        """Archive the terminal statement (server/history.py), after
        the flight-dump check so a failed or slow dump keeps the
        query's one dump."""
        from ..exec.batching import template_fp_of
        from .history import QueryHistoryArchive, get_history_archive
        session = dict(q.session_values)
        session.setdefault("sf", self.sf)
        record = QueryHistoryArchive.record_of(
            q.id, q.machine.state, q.user, q.text, q.machine.elapsed_ms(),
            q.trace_ctx.trace_id, query_stats=q.result_stats,
            session=session)
        # the batch template's fingerprint rides the record, so that the
        # archive's count of it seeds the formation window's hotness
        # after a restart
        bfp = template_fp_of(q.id)
        if bfp:
            record["batchFingerprint"] = bfp
            record["batchSize"] = q.batch_size
        get_history_archive().add(record)

    def _account_query(self, q: _Query) -> None:
        """Roll the terminal statement into the /v1/metrics totals, once,
        and feed its end-to-end and per-state latency histograms."""
        from .metrics import observe_histogram
        tid = q.trace_ctx.trace_id
        observe_histogram("presto_tpu_query_latency_seconds",
                          q.machine.elapsed_ms() / 1e3, trace_id=tid)
        entered = sorted(q.machine.timings().items(), key=lambda x: x[1])
        for i, (state, start) in enumerate(entered):
            if state not in ("QUEUED", "PLANNING", "RUNNING", "FINISHING"):
                continue
            end = entered[i + 1][1] if i + 1 < len(entered) else time.time()
            observe_histogram("presto_tpu_query_state_seconds",
                              max(end - start, 0.0),
                              labels={"state": state}, trace_id=tid)
        qs = q.result_stats
        with self._metrics_lock:
            st = q.machine.state
            self._queries_by_state[st] = self._queries_by_state.get(st, 0) + 1
            self._totals["rows"] += len(q.rows)
            self._totals["wall_us"] += q.machine.elapsed_ms() * 1000
            if qs is not None:
                self._totals["bytes"] += qs.output_bytes
                self._totals["compile_us"] += qs.compile_us
                self._totals["execute_us"] += qs.stage_us("execute")
                self._totals["peak_memory_bytes"] = max(
                    self._totals["peak_memory_bytes"], qs.peak_memory_bytes)

    def _run_inner(self, q: _Query):
        m = _SESSION_STMT.match(q.text)
        try:
            if m:
                self._run_session_statement(q, m.group(1).lower())
                return
            session = {"user": q.user, **q.session_values}
            q.resource_group = self.dispatcher.select_group(session)
            # the `failpoints` session property arms a schedule for this
            # query's dispatch and execution
            with failpoints.session_scope(
                    q.session_values.get("failpoints")):
                self.dispatcher.submit(
                    lambda qid: self._run_engine(q), session=session,
                    query_text=q.text, query_id=q.id,
                    queue_timeout=float(q.session_values.get(
                        "queue_timeout_s", 60.0)))
        except QueryRejected as e:
            q.machine.to_failed(_error_doc("QUERY_QUEUE_FULL", str(e)))
        except Exception as e:  # noqa: BLE001 - a query's failure is its document
            name = "SYNTAX_ERROR" if "parse" in type(e).__name__.lower() \
                or "Syntax" in str(e) else "GENERIC_INTERNAL_ERROR"
            q.machine.to_failed(_error_doc(name, f"{type(e).__name__}: {e}"))

    def _run_engine(self, q: _Query):
        if failpoints.ARMED:
            # hang: a wedged statement tier; error: a failure before
            # planning
            failpoints.hit("statement.execute")
        q.machine.to_planning()
        m = re.match(r"\s*explain(\s+analyze)?\b", q.text, re.IGNORECASE)
        if m:
            self._run_explain(q, q.text[m.end():].strip(), bool(m.group(1)))
            return None
        q.machine.to_running()
        wm = _WRITE_STMT.match(q.text)
        if q.txn_id is not None:
            self.transactions.get(q.txn_id)  # validates and touches
            if wm:
                # checkConnectorWrite: a read-only transaction refuses
                self.transactions.access_check_write(q.txn_id, "memory")
            res = self._executor(q.text, q.session_values, q.id, q.txn_id)
        else:
            res = self.transactions.run_autocommit(
                lambda tid: self._executor(q.text, q.session_values, q.id,
                                           tid))
        q.machine.to_finishing()
        if wm:
            q.update_type = _UPDATE_TYPES[" ".join(wm.group(1).upper()
                                                   .split())]
            if res.types and res.types[0].base == "bigint" and \
                    res.row_count == 1:
                q.update_count = int(res.columns[0][0])
        q.result_stats = getattr(res, "query_stats", None)
        from ..exec.batching import batch_size_of
        q.batch_size = batch_size_of(q.id)
        q.runtime_stats = {k: (v.item() if hasattr(v, "item") else v)
                           for k, v in (getattr(res, "stats", None)
                                        or {}).items()}
        q.columns = [{"name": n, "type": str(t)}
                     for n, t in zip(res.names, res.types)]
        q.rows = [[render_value(res.columns[c][i], bool(res.nulls[c][i]),
                                res.types[c])
                   for c in range(len(res.types))]
                  for i in range(res.row_count)]
        q.machine.to_finished()
        return res

    def _run_explain(self, q: _Query, inner: str, analyze: bool) -> None:
        """EXPLAIN [ANALYZE] as one varchar column of plan text: the
        plan as execution shapes it, or run and annotated."""
        from ..plan.explain import explain, explain_analyze
        from ..sql import plan_sql
        sf = float(q.session_values.get("sf", self.sf))
        session = {"user": q.user, **q.session_values}
        q.machine.to_running()
        if analyze:
            text = explain_analyze(plan_sql(inner), sf=sf, session=session,
                                   device=self.device, query_id=q.id,
                                   trace_id=q.trace_ctx)
        else:
            text = explain(plan_sql(inner), regions=True, session=session,
                           sf=sf)
        q.columns = [{"name": "Query Plan", "type": "varchar"}]
        q.rows = [[line] for line in text.splitlines()]
        q.machine.to_finishing()
        q.machine.to_finished()

    def _run_session_statement(self, q: _Query, kind: str):
        q.machine.to_planning()
        q.machine.to_running()
        kind = " ".join(kind.split())
        if kind == "start transaction":
            if q.txn_id is not None:
                raise RuntimeError("already in a transaction")
            read_only = bool(re.search(r"read\s+only", q.text, re.I))
            q.started_txn = self.transactions.begin(read_only=read_only)
            q.update_type = "START TRANSACTION"
        elif kind in ("commit", "rollback"):
            if q.txn_id is None:
                raise RuntimeError(f"{kind.upper()} outside a transaction")
            if kind == "commit":
                self.transactions.commit(q.txn_id)
            else:
                self.transactions.rollback(q.txn_id)
            q.clear_txn = True
            q.update_type = kind.upper()
        else:  # SET SESSION k = v
            m = re.match(r"\s*set\s+session\s+([A-Za-z_][\w.]*)\s*=\s*(.+?)"
                         r"\s*$", q.text, re.IGNORECASE)
            if not m:
                raise ValueError(f"cannot parse SET SESSION: {q.text!r}")
            key, raw = m.group(1), m.group(2).strip().rstrip(";").strip()
            if raw.startswith("'") and raw.endswith("'"):
                raw = raw[1:-1]
            q.set_session[key] = raw
            q.update_type = "SET SESSION"
        q.columns = [{"name": "result", "type": "boolean"}]
        q.rows = [[True]]
        q.machine.to_finishing()
        q.machine.to_finished()

    # -- documents ------------------------------------------------------

    def get_query(self, query_id: str, slug: str) -> Optional[_Query]:
        with self._qlock:
            q = self._queries.get(query_id)
        if q is None or q.slug != slug:
            return None
        return q

    def _uri(self, kind: str, q: _Query, token: int) -> str:
        return f"{self.url}/v1/statement/{kind}/{q.id}/{q.slug}/{token}"

    def _failed(self, q: _Query) -> dict:
        return q.machine.error or _error_doc("USER_CANCELED",
                                             "query was canceled")

    def queued_doc(self, q: _Query, token: int) -> dict:
        state = q.machine.state
        doc = self._base_doc(q, state)
        if state == QueryState.QUEUED:
            doc["nextUri"] = self._uri("queued", q, token + 1)
        elif state in (QueryState.FAILED, QueryState.CANCELED):
            doc["error"] = self._failed(q)
        else:
            doc["nextUri"] = self._uri("executing", q, 0)
        return doc

    def executing_doc(self, q: _Query, token: int) -> dict:
        state = q.machine.state
        doc = self._base_doc(q, state)
        if state in (QueryState.FAILED, QueryState.CANCELED):
            doc["error"] = self._failed(q)
            return doc
        if state != QueryState.FINISHED:
            # no rows yet: poll the same token
            doc["nextUri"] = self._uri("executing", q, token)
            return doc
        doc["columns"] = q.columns
        if q.first_fetch_at is None:
            q.first_fetch_at = time.time()
        lo = token * self.page_rows
        hi = lo + self.page_rows
        page = q.rows[lo:hi]
        if page:
            doc["data"] = page
        if q.update_type:
            doc["updateType"] = q.update_type
        if q.update_count is not None:
            doc["updateCount"] = q.update_count
        if hi < len(q.rows):
            doc["nextUri"] = self._uri("executing", q, token + 1)
        elif not q.fetch_span_done:
            # the last page is out: the client-drain leg of the trace
            q.fetch_span_done = True
            from .tracing import emit_span
            emit_span(q.trace_ctx.trace_id, "client.fetch",
                      q.first_fetch_at or time.time(), time.time(),
                      {"rows": len(q.rows), "pages": token + 1},
                      parent_id=q.trace_ctx.span_id)
        return doc

    def _progress_doc(self, q: _Query) -> Optional[dict]:
        """The statement's live progress: its own engine entry and every
        remote task entry tagged with its trace id (exec/progress.py)."""
        from ..exec.progress import aggregate_query_progress
        return aggregate_query_progress({q.id, q.trace_ctx.trace_id})

    def _base_doc(self, q: _Query, state: str) -> dict:
        doc = {
            "id": q.id,
            "infoUri": f"{self.url}/v1/query/{q.id}",
            "stats": {
                "state": state,
                "queued": state == QueryState.QUEUED,
                "scheduled": state not in (QueryState.QUEUED,
                                           QueryState.PLANNING),
                "elapsedTimeMillis": q.machine.elapsed_ms(),
            },
        }
        stats = doc["stats"]
        prog = self._progress_doc(q)
        hwm = q.progress_hwm
        if prog is not None:
            # live counters, clamped to the query's high-water marks so
            # that what a client sees never goes back
            hwm["rows"] = max(hwm["rows"], prog["rows"])
            hwm["bytes"] = max(hwm["bytes"], prog["bytes"])
            hwm["peak"] = max(hwm["peak"], prog["peakMemoryBytes"])
            hwm["pct"] = max(hwm["pct"], prog["progressPercent"])
            stats["stage"] = prog["stage"]
            stats["lastAdvanceAgeMs"] = prog["lastAdvanceAgeMs"]
            stats["liveTasks"] = prog["runningTasks"]
            stats["splitsDone"] = prog["splitsDone"]
            stats["splitsPlanned"] = prog["splitsPlanned"]
        stats["processedRows"] = max(len(q.rows), hwm["rows"])
        stats["processedBytes"] = hwm["bytes"]
        stats["peakMemoryBytes"] = hwm["peak"]
        stats["progressPercent"] = 100.0 \
            if state == QueryState.FINISHED else round(hwm["pct"], 1)
        qs = q.result_stats
        if qs is not None:
            stats["processedBytes"] = max(stats["processedBytes"],
                                          qs.output_bytes)
            stats["peakMemoryBytes"] = max(stats["peakMemoryBytes"],
                                           qs.peak_memory_bytes)
            stats["compileTimeMicros"] = qs.compile_us
            stats["executeTimeMicros"] = qs.stage_us("execute")
            stats["queryStats"] = qs.to_json()
        return doc

    def cancel(self, q: _Query) -> None:
        q.machine.to_canceled()

    def admin_doc(self, query_id: str) -> Optional[dict]:
        with self._qlock:
            q = self._queries.get(query_id)
        if q is None:
            return None
        return {"queryId": q.id, "state": q.machine.state,
                "query": q.text, "user": q.user,
                "sessionProperties": q.session_values,
                "timings": q.machine.timings(),
                "elapsedTimeMillis": q.machine.elapsed_ms(),
                "errorInfo": q.machine.error,
                "resourceGroup": q.resource_group,
                "batchSize": q.batch_size,
                "progress": self._progress_doc(q),
                "queryStats": q.result_stats.to_json()
                if q.result_stats is not None else None,
                # QueryResult.stats, the port's flat counters
                "runtimeStats": q.runtime_stats}

    def queries_doc(self) -> List[dict]:
        with self._qlock:
            ids = list(self._queries)
        return [d for d in (self.admin_doc(i) for i in ids) if d is not None]

    def trace_doc(self, query_or_trace_id: str) -> Optional[dict]:
        """The stitched trace of GET /v1/trace/{id}: a query id (its
        trace) or a raw trace id."""
        from .tracing import get_tracer, trace_doc_of
        with self._qlock:
            q = self._queries.get(query_or_trace_id)
        tid = q.trace_ctx.trace_id if q is not None else query_or_trace_id
        doc = trace_doc_of(get_tracer(), tid)
        if doc is not None and q is not None:
            doc["queryId"] = q.id
            doc["state"] = q.machine.state
        return doc

    def _stuck_candidates(self):
        """The running statements offered to the stuck-progress
        watchdog: threshold from the session (env fallback), last
        advance the freshest of the state transitions and the progress
        heartbeats."""
        from ..exec.progress import aggregate_query_progress
        from .watchdog import StuckCandidate, resolve_stuck_threshold_ms
        with self._qlock:
            queries = list(self._queries.values())
        out = []
        now = time.time()
        for q in queries:
            state = q.machine.state
            if state == QueryState.QUEUED or state in TERMINAL_STATES:
                continue
            thr = resolve_stuck_threshold_ms(q.session_values)
            if thr <= 0:
                continue
            last = max(q.machine.timings().values())
            prog = aggregate_query_progress({q.id, q.trace_ctx.trace_id})
            if prog is not None:
                last = max(last, now - prog["lastAdvanceAgeMs"] / 1000.0)
            out.append(StuckCandidate(
                q.id, thr, last, trace_id=q.trace_ctx.trace_id,
                extra={"state": state, "user": q.user,
                       "query": q.text[:200]}))
        return out

    def cluster_doc(self) -> dict:
        """GET /v1/cluster, the fleet overview (ClusterStatsResource
        analog), in the reference's shape: live queries with their
        progress, one /v1/status row per worker of `profile_workers`
        (DEAD where it does not answer), throughput, resource-group
        queues, the batching executor's live snapshot, the watchdog's
        total and the ledgers' cheap summaries."""
        from ..exec.accuracy import accuracy_summary
        from ..exec.batching import batching_snapshot
        from ..exec.datapath import staging_summary
        from ..exec.progress import live_snapshots, live_task_count
        from ..exec.timeline import timeline_summary
        from .client import pull_worker_docs
        from .discovery import recently_unannounced
        from .watchdog import stuck_totals
        now = time.time()
        with self._qlock:
            queries = list(self._queries.values())
        queued = running = 0
        running_docs = []
        for q in queries:
            state = q.machine.state
            if state in TERMINAL_STATES:
                continue
            if state == QueryState.QUEUED:
                queued += 1
            else:
                running += 1
            running_docs.append({
                "queryId": q.id, "user": q.user, "state": state,
                "elapsedMs": q.machine.elapsed_ms(), "query": q.text[:120],
                "traceId": q.trace_ctx.trace_id,
                "progress": self._progress_doc(q),
                "maxQError": _max_q_error_of(q.id)})
        groups = self.dispatcher.group_stats()
        blocked = sum(int(g.get("queued", 0)) for g in groups.values())
        all_urls = self._worker_urls()
        # a worker that said goodbye leaves the probed set at once
        gone = set(recently_unannounced())
        urls = [u for u in all_urls if str(u).rstrip("/") not in gone]
        workers, alive = pull_worker_docs(
            urls, 2.0, lambda c: {**c.status(), "uri": c.base},
            "statement", "cluster_status", parallel=True,
            placeholder=lambda u: {"uri": u, "nodeId": u, "state": "DEAD",
                                   "fleetState": "DEAD", "memory": {}})
        for w in workers:
            w.setdefault("fleetState",
                         "DRAINING" if w.get("state") == "SHUTTING_DOWN"
                         else str(w.get("state", "ACTIVE")))
        draining = sum(1 for w in workers
                       if w.get("fleetState") == "DRAINING")
        with self._metrics_lock:
            self._workers_alive = alive
            self._workers_draining = draining
            by_state = dict(self._queries_by_state)
            totals = dict(self._totals)
        live = live_snapshots()
        rows_per_s = sum(e["rows"] / max(e["elapsedMs"] / 1000.0, 1e-3)
                         for e in live)
        return {
            "tsUs": int(now * 1e6),
            "nodeVersion": {"version": "presto-tpu-0.4"},
            "uptimeSeconds": round(now - self._started_at, 1),
            "queries": {"queued": queued, "running": running,
                        "blocked": blocked,
                        "finishedTotal": by_state.get("FINISHED", 0),
                        "failedTotal": by_state.get("FAILED", 0),
                        "canceledTotal": by_state.get("CANCELED", 0)},
            "runningQueries": running_docs,
            "liveTasks": live_task_count(),
            "rowsPerSecond": round(rows_per_s, 1),
            "totals": {"rows": totals["rows"], "bytes": totals["bytes"],
                       "wallSeconds": round(totals["wall_us"] / 1e6, 3)},
            "resourceGroups": groups,
            "batching": batching_snapshot(),
            "workers": workers,
            "workersAlive": alive,
            "workersConfigured": len(all_urls),
            "workersDraining": draining,
            "workersDead": sum(1 for w in workers
                               if w.get("fleetState") == "DEAD"),
            "workersUnannounced": len(all_urls) - len(urls),
            "stuckQueriesTotal": stuck_totals(),
            "datapath": staging_summary(),
            "accuracy": accuracy_summary(),
            "timeline": timeline_summary(),
        }

    def _workers_alive_view(self) -> int:
        """The workers-alive gauge: the last /v1/cluster probe's count,
        the configured count before any probe."""
        with self._metrics_lock:
            alive = self._workers_alive
        return len(self._worker_urls()) if alive is None else alive

    def metric_families(self):
        """The coordinator's /v1/metrics families, in the reference's
        order, less the two whose sources are not ported (see
        server/metrics.py)."""
        from . import metrics as M
        MF = M.MetricFamily
        with self._qlock:
            live = [q.machine.state for q in self._queries.values()]
        queued = sum(1 for st in live if st == QueryState.QUEUED)
        running = sum(1 for st in live
                      if st not in (QueryState.QUEUED, *TERMINAL_STATES))
        with self._metrics_lock:
            by_state = dict(self._queries_by_state)
            totals = dict(self._totals)
            draining = self._workers_draining
        fam_q = MF("presto_tpu_queries_total", "counter",
                   "terminal queries by final state")
        for st in sorted(by_state):
            fam_q.add(by_state[st], {"state": st})
        if not by_state:
            fam_q.add(0, {"state": "FINISHED"})
        fams = [
            fam_q,
            MF("presto_tpu_queries_queued", "gauge",
               "queries currently QUEUED").add(queued),
            MF("presto_tpu_queries_running", "gauge",
               "queries currently executing").add(running),
            MF("presto_tpu_query_rows_total", "counter",
               "result rows returned to clients").add(totals["rows"]),
            MF("presto_tpu_query_bytes_total", "counter",
               "result bytes produced").add(totals["bytes"]),
            MF("presto_tpu_query_wall_seconds_total", "counter",
               "wall time of terminal queries").add(
                   totals["wall_us"] / 1e6),
            MF("presto_tpu_query_compile_seconds_total", "counter",
               "compile time across queries (plan lowering and kernel "
               "builds)").add(totals["compile_us"] / 1e6),
            MF("presto_tpu_query_execute_seconds_total", "counter",
               "execute stage time across queries").add(
                   totals["execute_us"] / 1e6),
            MF("presto_tpu_query_peak_memory_bytes", "gauge",
               "largest per-query peak memory seen").add(
                   totals["peak_memory_bytes"]),
            M.uptime_family(self._started_at, "coordinator"),
        ]
        fams.extend(M.live_introspection_families(
            workers_alive=self._workers_alive_view()))
        fams.extend(M.fleet_families(workers_draining=draining))
        for build in (M.plan_cache_families, M.narrowing_families,
                      M.datapath_families, M.accuracy_families,
                      M.batching_families, M.suppressed_error_families,
                      M.tracing_families, M.flight_recorder_families,
                      M.failpoint_families, M.timeline_families,
                      M.kernel_audit_families, M.donation_families,
                      M.lock_families, M.query_history_families,
                      M.histogram_families):
            fams.extend(build())
        return fams

    def profile_doc(self) -> dict:
        from ..exec.profiler import cluster_profile_doc
        return cluster_profile_doc(self._worker_urls())

    def history_doc(self) -> dict:
        from .history import cluster_history_doc
        return cluster_history_doc(self._worker_urls())

    def datapath_doc(self) -> dict:
        from ..exec.datapath import cluster_datapath_doc
        return cluster_datapath_doc(self._worker_urls())

    def accuracy_doc(self) -> dict:
        from ..exec.accuracy import cluster_accuracy_doc
        return cluster_accuracy_doc(self._worker_urls())

    def timeline_doc(self) -> dict:
        from ..exec.timeline import cluster_timeline_doc
        return cluster_timeline_doc(self._worker_urls())

    def _worker_urls(self) -> list:
        pw = self._profile_workers
        return list(pw() if callable(pw) else (pw or ()))


def _render_ui(server: StatementServer, parts: List[str]) -> str:
    """The coordinator's web pages: /ui lists the queries, /ui/query/<id>
    shows one (presto-ui's QueryList and QueryDetail, rendered here)."""
    esc = html.escape
    style = ("<style>body{font-family:monospace;margin:2em}"
             "table{border-collapse:collapse}"
             "td,th{border:1px solid #999;padding:4px 8px;text-align:left}"
             "th{background:#eee}.FINISHED{color:#080}"
             ".FAILED{color:#b00}.RUNNING{color:#06c}</style>")
    if len(parts) == 2 and parts[0] == "query":
        doc = server.admin_doc(parts[1])
        if doc is None:
            return f"{style}<h2>query {esc(parts[1])} not found</h2>"
        rows = "".join(
            f"<tr><th>{esc(str(k))}</th>"
            f"<td><pre>{esc(json.dumps(v, indent=1, default=str))}"
            f"</pre></td></tr>" for k, v in doc.items())
        return (f"{style}<h2>query {esc(parts[1])}</h2>"
                f"<p><a href='/ui'>&larr; queries</a></p>"
                f"<table>{rows}</table>")
    docs = sorted(server.queries_doc(),
                  key=lambda d: d.get("timings", {}).get("QUEUED", 0),
                  reverse=True)
    rows = "".join(
        f"<tr><td><a href='/ui/query/{esc(d['queryId'])}'>"
        f"{esc(d['queryId'])}</a></td>"
        f"<td class='{esc(d['state'])}'>{esc(d['state'])}</td>"
        f"<td>{esc(d['user'])}</td>"
        f"<td>{d.get('elapsedTimeMillis', 0)} ms</td>"
        f"<td>{esc(d['query'][:120])}</td></tr>" for d in docs)
    return (f"{style}<h2>presto-tpu coordinator</h2>"
            f"<p>{len(docs)} queries (TTL {server.query_ttl_s:.0f}s)</p>"
            f"<table><tr><th>query</th><th>state</th><th>user</th>"
            f"<th>elapsed</th><th>sql</th></tr>{rows}</table>")


def _parse_session_header(value: str) -> Dict[str, str]:
    out = {}
    for part in value.split(","):
        part = part.strip()
        if part and "=" in part:
            k, v = part.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def _make_handler(server: StatementServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # TCP_NODELAY, as on the port's worker: without it a response's
        # body waits for the client's delayed ACK of its headers
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):
            pass

        def _send(self, doc, code=200, headers: Optional[Dict] = None):
            body = json.dumps(doc).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send_html(self, page: str, code: int = 200):
            body = page.encode()
            self.send_response(code)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> bytes:
            length = int(self.headers.get("Content-Length", "0") or 0)
            return self.rfile.read(length)

        def do_POST(self):  # noqa: N802
            parts = [p for p in self.path.split("/") if p]
            if parts == ["v1", "failpoint"]:
                doc, code = failpoints.admin_post(
                    json.loads(self._body() or b"{}"))
                self._send(doc, code)
                return
            if self.path.rstrip("/") != "/v1/statement":
                self._send({"error": "not found"}, 404)
                return
            text = self._body().decode("utf-8", "replace")
            if not text.strip():
                self._send(_error_doc("SYNTAX_ERROR", "empty statement"),
                           400)
                return
            user = self.headers.get("X-Presto-User", "anonymous")
            session_values = _parse_session_header(
                self.headers.get("X-Presto-Session", ""))
            src = self.headers.get("X-Presto-Source")
            if src:
                session_values.setdefault("source", src)
            tags = self.headers.get("X-Presto-Client-Tags")
            if tags:
                session_values.setdefault(
                    "clientTags", [t.strip() for t in tags.split(",")
                                   if t.strip()])
            txn = self.headers.get("X-Presto-Transaction-Id")
            if txn in (None, "", "NONE"):
                txn = None
            from .tracing import TRACE_HEADER, parse_traceparent
            client_ctx = parse_traceparent(self.headers.get(TRACE_HEADER))
            q = server.create_query(text, user, session_values, txn,
                                    client_ctx=client_ctx)
            # a fast statement leaves QUEUED within a beat: one poll saved
            q.machine.wait_past_queued(0.05)
            self._send(server.queued_doc(q, 0))

        def do_GET(self):  # noqa: N802
            parts = [p for p in self.path.split("/") if p]
            if len(parts) == 6 and parts[:2] == ["v1", "statement"] and \
                    parts[2] in ("queued", "executing"):
                q = server.get_query(parts[3], parts[4])
                if q is None:
                    self._send({"error": "query not found"}, 404)
                    return
                token = int(parts[5])
                headers = {}
                if parts[2] == "queued":
                    q.machine.wait_past_queued(server.queue_poll_s)
                    doc = server.queued_doc(q, token)
                else:
                    q.machine.wait_done(server.queue_poll_s)
                    doc = server.executing_doc(q, token)
                    if q.machine.is_done():
                        for k, v in q.set_session.items():
                            headers["X-Presto-Set-Session"] = f"{k}={v}"
                        if q.started_txn:
                            headers["X-Presto-Started-Transaction-Id"] = \
                                q.started_txn
                        if q.clear_txn:
                            headers["X-Presto-Clear-Transaction-Id"] = "true"
                self._send(doc, headers=headers)
                return
            if parts == ["v1", "cluster"]:
                self._send(server.cluster_doc())
                return
            if len(parts) == 2 and parts[0] == "v1" and \
                    parts[1] in _LEDGER_DOCS:
                self._send(getattr(server, _LEDGER_DOCS[parts[1]])())
                return
            if len(parts) == 3 and parts[:2] == ["v1", "trace"]:
                doc = server.trace_doc(parts[2])
                self._send(doc if doc else
                           {"error": f"no trace for {parts[2]} (is a "
                                     f"tracer installed?)"},
                           200 if doc else 404)
                return
            if parts == ["v1", "metrics"]:
                from .metrics import negotiate_exposition, render_prometheus
                om, ctype = negotiate_exposition(self.headers.get("Accept"))
                body = render_prometheus(server.metric_families(),
                                         openmetrics=om)
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if parts == ["v1", "failpoint"]:
                self._send(failpoints.admin_get_doc())
                return
            if len(parts) == 3 and parts[:2] == ["v1", "query"]:
                doc = server.admin_doc(parts[2])
                self._send(doc if doc else {"error": "not found"},
                           200 if doc else 404)
                return
            if parts == ["v1", "query"]:
                self._send(server.queries_doc())
                return
            if parts == ["v1", "info"]:
                self._send({"nodeVersion": {"version": "presto-tpu-0.4"},
                            "coordinator": True, "starting": False,
                            "uptime": "0m"})
                return
            if parts[:1] == ["ui"]:
                self._send_html(_render_ui(server, parts[1:]))
                return
            self._send({"error": "not found"}, 404)

        def do_DELETE(self):  # noqa: N802
            parts = [p for p in self.path.split("/") if p]
            if parts[:2] == ["v1", "failpoint"] and len(parts) in (2, 3):
                self._send(failpoints.admin_delete(
                    parts[2] if len(parts) == 3 else None))
                return
            if len(parts) >= 5 and parts[:2] == ["v1", "statement"]:
                q = server.get_query(parts[3], parts[4])
                if q is None:
                    self._send({"error": "query not found"}, 404)
                    return
                server.cancel(q)
                self._send({"id": q.id, "canceled": True}, 200)
                return
            self._send({"error": "not found"}, 404)

    return Handler
