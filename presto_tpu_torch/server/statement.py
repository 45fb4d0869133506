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
device="cpu"), serially: the reference's batching of concurrent
statements is item 12.4. Results page out `page_rows` rows a nextUri
hop, rendered by the reference's JSON conventions (decimals, dates and
timestamps as strings).

  POST   /v1/statement                         a statement
  GET    /v1/statement/{queued|executing}/{id}/{slug}/{token}
  DELETE /v1/statement/.../{id}/{slug}/...     cancel
  GET    /v1/query, /v1/query/{id}             the queries' documents
  GET    /v1/info                              the coordinator's info
  GET    /ui, /ui/query/{id}                   the web pages
  GET, POST, DELETE /v1/failpoint              the failpoint admin

Not here yet, and answered with a refusal naming their ROADMAP queue 1
item: EXPLAIN and EXPLAIN ANALYZE, /v1/cluster, /v1/metrics,
/v1/profile, /v1/history, /v1/datapath, /v1/accuracy, /v1/timeline and
/v1/trace (item 15, the observability ledgers: the reference's trace
spans and flight recorder have no stand-in, since no document of the
protocol reads them); TLS, the stuck-query watchdog and a standby's
adoption of queries (item 14e).
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
from .query_state import QueryState, QueryStateMachine

__all__ = ["StatementServer", "render_value"]

_ITEM_15 = "ROADMAP queue 1 item 15"
# the GET routes of the reference that read item 15's ledgers
_LEDGER_ROUTES = ("cluster", "metrics", "profile", "history", "datapath",
                  "accuracy", "timeline", "trace")


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
                 session_values: Dict, user: str, txn_id: Optional[str]):
        self.id = query_id
        self.slug = slug
        self.text = text
        self.session_values = session_values
        self.user = user
        self.txn_id = txn_id
        self.machine = QueryStateMachine(query_id)
        self.columns: Optional[List[dict]] = None
        self.rows: List[list] = []
        self.update_type: Optional[str] = None
        self.update_count: Optional[int] = None
        # the engine's QueryResult.stats once it ran
        self.result_stats: Optional[Dict[str, float]] = None
        # response-header changes for the client to apply
        self.set_session: Dict[str, str] = {}
        self.started_txn: Optional[str] = None
        self.clear_txn = False
        # the resource group the dispatcher routed the query to
        self.resource_group = ""


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
                 device=None, tls: Optional[tuple] = None):
        if tls is not None:
            raise NotImplementedError(
                "TLS is not ported yet (ROADMAP queue 1 item 14e: "
                "cluster operations)")
        self.sf = sf
        self.device = resolve_device(device)
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
        self._qlock = threading.RLock()
        self._httpd = ThreadingHTTPServer(("127.0.0.1", port),
                                          _make_handler(self))
        self.port = self._httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "StatementServer":
        from ..connectors.system import register_statement_server
        register_statement_server(self)  # system.queries
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
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
        return run_sql(pre.text, sf=sf, device=self.device, session=session,
                       query_id=query_id, **kwargs)

    def _user_of(self, query_id: str) -> str:
        with self._qlock:
            q = self._queries.get(query_id)
        return q.user if q is not None else ""

    def _reap_locked(self) -> None:
        """Drop terminal queries, and their rows, older than
        query_ttl_s."""
        cutoff = time.time() - self.query_ttl_s
        for qid in [qid for qid, q in self._queries.items()
                    if q.machine.is_done()
                    and q.machine.timings().get(q.machine.state, 0) < cutoff]:
            del self._queries[qid]

    def create_query(self, text: str, user: str, session_values: Dict,
                     txn_id: Optional[str]) -> _Query:
        """Register a statement and start running it."""
        # rule-based defaults under, the client's values over
        from .session_properties import get_session_property_manager
        mgr = get_session_property_manager()
        if mgr is not None:
            session_values = {**mgr.defaults_for(
                user, session_values.get("source", ""),
                session_values.get("clientTags")), **session_values}
        q = _Query(f"{time.strftime('%Y%m%d')}_{uuid.uuid4().hex[:12]}",
                   uuid.uuid4().hex[:12], text, session_values, user, txn_id)
        with self._qlock:
            self._reap_locked()
            self._queries[q.id] = q
        threading.Thread(target=self._run, args=(q,), daemon=True).start()
        return q

    def _run(self, q: _Query):
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
        if re.match(r"\s*explain\b", q.text, re.IGNORECASE):
            raise NotImplementedError(
                f"EXPLAIN is not ported yet ({_ITEM_15}: plan/explain.py)")
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
        q.result_stats = {k: (v.item() if hasattr(v, "item") else v)
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
        return doc

    def _base_doc(self, q: _Query, state: str) -> dict:
        return {
            "id": q.id,
            "infoUri": f"{self.url}/v1/query/{q.id}",
            "stats": {
                "state": state,
                "queued": state == QueryState.QUEUED,
                "scheduled": state not in (QueryState.QUEUED,
                                           QueryState.PLANNING),
                "elapsedTimeMillis": q.machine.elapsed_ms(),
                "processedRows": len(q.rows),
                "processedBytes": 0,
                "peakMemoryBytes": 0,
                "progressPercent": 100.0
                if state == QueryState.FINISHED else 0.0,
            },
        }

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
                "batchSize": 0,  # every statement runs serially
                "queryStats": q.result_stats}

    def queries_doc(self) -> List[dict]:
        with self._qlock:
            ids = list(self._queries)
        return [d for d in (self.admin_doc(i) for i in ids) if d is not None]


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
            q = server.create_query(text, user, session_values, txn)
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
            if len(parts) >= 2 and parts[0] == "v1" and \
                    parts[1] in _LEDGER_ROUTES:
                self._send({"error": f"/v1/{parts[1]} is not ported yet "
                                     f"({_ITEM_15}: the observability "
                                     "ledgers)"}, 501)
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
