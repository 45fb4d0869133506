"""Resource manager: the shared cluster state of several coordinators.

Counterpart of presto_tpu/server/resource_manager.py
(presto-main-base/.../resourcemanager/: coordinators heartbeat their
resource-group state to a resource manager, which aggregates it, so
that N coordinators enforce cluster-wide resource-group limits):

  * ResourceManager        -- the HTTP service (PUT or POST
                              /v1/resourcemanager/{coordinator}
                              heartbeats in, GET /v1/resourcemanager
                              the aggregated view out); a heartbeat
                              older than its ttl stops counting
  * ClusterStateSender     -- a coordinator's periodic heartbeat of its
                              dispatcher's group stats and its
                              in-flight statements (the failover
                              manifest); failpoint site
                              coordinator.heartbeat_lapse
  * remote_group_load      -- a group's running count across the OTHER
                              coordinators (the dispatcher's gate)
  * StandbyCoordinator     -- a standby statement server's monitor of
                              the primary's heartbeat: when it lapses,
                              the standby adopts the primary's
                              in-flight statements, once
  * failover_totals        -- the failovers of this process

The locks are `OrderedLock`s under the reference's names
(utils/locks.py). A failover is a
`coordinator_failover` flight event and counts in the
`presto_tpu_coordinator_failovers_total` family; survived errors are
counted (server/metrics.py::record_suppressed).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from .. import failpoints
from ..utils.locks import OrderedLock

__all__ = ["ResourceManager", "ClusterStateSender", "remote_group_load",
           "StandbyCoordinator", "failover_totals",
           "reset_failover_totals"]

# failovers, process-wide (metrics.fleet_families exports them)
_FAILOVER_LOCK = OrderedLock("resource_manager._FAILOVER_LOCK")
_FAILOVER = {"count": 0}


def failover_totals() -> int:
    with _FAILOVER_LOCK:
        return _FAILOVER["count"]


def reset_failover_totals() -> None:
    """Test isolation only; production counters are monotonic."""
    with _FAILOVER_LOCK:
        _FAILOVER["count"] = 0


class _State:
    """Each coordinator's last heartbeat; `coordinators` is written
    under `lock`."""

    def __init__(self, heartbeat_ttl_s: float):
        self.lock = OrderedLock("resource_manager._State.lock")
        self.ttl = heartbeat_ttl_s
        # coordinator_id -> {"at": ts, "groups": {name: stats}}
        self.coordinators: Dict[str, dict] = {}

    def heartbeat(self, cid: str, doc: dict) -> None:
        with self.lock:
            self.coordinators[cid] = {"at": time.time(),
                                      "groups": doc.get("groups", {}),
                                      "queries": doc.get("queries", {})}

    def view(self) -> dict:
        now = time.time()
        with self.lock:
            live = {cid: st for cid, st in self.coordinators.items()
                    if now - st["at"] <= self.ttl}
            totals: Dict[str, dict] = {}
            for st in live.values():
                for g, gs in st["groups"].items():
                    agg = totals.setdefault(
                        g, {"running": 0, "queued": 0,
                            "memoryUsedBytes": 0})
                    agg["running"] += int(gs.get("running", 0))
                    agg["queued"] += int(gs.get("queued", 0))
                    agg["memoryUsedBytes"] += int(
                        gs.get("memoryUsedBytes", 0))
            return {"coordinators": {
                        cid: {"ageSeconds": round(now - st["at"], 3),
                              "groups": st["groups"],
                              "queries": st.get("queries", {})}
                        for cid, st in live.items()},
                    "groupTotals": totals}


def _make_handler(state: _State):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # TCP_NODELAY, as on the port's other servers
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):
            pass

        def _send(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_PUT(self):  # noqa: N802
            parts = [p for p in self.path.split("/") if p]
            if len(parts) == 3 and \
                    parts[:2] == ["v1", "resourcemanager"]:
                n = int(self.headers.get("Content-Length", "0") or 0)
                doc = json.loads(self.rfile.read(n) or b"{}")
                state.heartbeat(parts[2], doc)
                return self._send({"ok": True})
            return self._send({"error": "not found"}, 404)

        do_POST = do_PUT  # noqa: N815 - either verb heartbeats

        def do_GET(self):  # noqa: N802
            if self.path.rstrip("/") == "/v1/resourcemanager":
                return self._send(state.view())
            return self._send({"error": "not found"}, 404)

    return Handler


class ResourceManager:
    def __init__(self, port: int = 0, heartbeat_ttl_s: float = 10.0):
        self._state = _State(heartbeat_ttl_s)
        self._httpd = ThreadingHTTPServer(("127.0.0.1", port),
                                          _make_handler(self._state))
        self.port = self._httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ResourceManager":
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


class ClusterStateSender:
    """Coordinator-side periodic heartbeat of dispatcher group stats
    (ClusterStatusSender analog). `inflight_fn` (zero-arg callable ->
    list of in-flight statement docs, e.g. StatementServer.inflight_doc)
    rides each heartbeat as the failover manifest: the statements a
    standby re-dispatches when this coordinator's heartbeat lapses."""

    def __init__(self, rm_url: str, coordinator_id: str, dispatcher,
                 interval_s: float = 0.5, timeout: float = 5.0,
                 inflight_fn=None):
        self.rm_url = rm_url.rstrip("/")
        self.coordinator_id = coordinator_id
        self.dispatcher = dispatcher
        self.interval = interval_s
        self.timeout = timeout
        self.inflight_fn = inflight_fn
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def send_once(self) -> None:
        if failpoints.ARMED:
            # a lost heartbeat: enough consecutive losses age this
            # coordinator out of the RM view and the standby takes over
            failpoints.hit("coordinator.heartbeat_lapse")
        doc = {"groups": self.dispatcher.group_stats()}
        if self.inflight_fn is not None:
            doc["queries"] = self.inflight_fn()
        req = urllib.request.Request(
            f"{self.rm_url}/v1/resourcemanager/{self.coordinator_id}",
            data=json.dumps(doc).encode(), method="PUT",
            headers={"Content-Type": "application/json"})
        urllib.request.urlopen(req, timeout=self.timeout).read()

    def start(self) -> "ClusterStateSender":
        def loop():
            while not self._stop.is_set():
                try:
                    self.send_once()
                except Exception as e:  # noqa: BLE001 - RM outage: keep
                    # trying, counted
                    from .metrics import record_suppressed
                    record_suppressed("resource_manager", "heartbeat", e)
                self._stop.wait(self.interval)
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(self.timeout + 1)


class StandbyCoordinator:
    """Multi-coordinator failover monitor (the promotion of router.py +
    resource_manager.py the elastic fleet needs): a STANDBY statement
    tier watches the PRIMARY's heartbeat through the resource manager's
    aggregated view and, when the heartbeat lapses past `ttl_s`, takes
    over statement execution for the queries the primary last reported
    queued/running -- each one re-dispatched on the standby under its
    ORIGINAL query id + slug (StatementServer.adopt_query), so a client
    (or the router fronting both coordinators) re-resolves its polls
    against the standby and drains the same statement to completion.

    The handshake, in order:
      1. while the primary heartbeats, the monitor only caches its
         in-flight manifest (the last heartbeat's ``queries`` list);
      2. heartbeat age > ttl  ->  exactly-once failover: the counter
         (failover_totals) bumps, and every non-terminal manifest
         entry is adopted onto the standby;
      3. the router's health checks drop the dead primary on their own
         cadence, steering NEW statements at the standby (kind=
         "standby" clusters serve only while no primary is healthy);
      4. a primary that comes BACK (restart) simply resumes
         heartbeating -- the monitor re-arms for the next lapse
         (adoption is idempotent per query id: a re-fired failover
         never double-runs an adopted statement).

    Driven either by start() (background thread) or check_once() (the
    deterministic test/chaos surface, like the watchdog's)."""

    def __init__(self, rm_url: str, primary_id: str, statement_server,
                 ttl_s: float = 3.0, poll_s: float = 0.5,
                 timeout: float = 5.0):
        self.rm_url = rm_url.rstrip("/")
        self.primary_id = primary_id
        self.statement_server = statement_server
        self.ttl_s = ttl_s
        self.poll_s = poll_s
        self.timeout = timeout
        self.is_primary = False     # True after takeover
        self._manifest: List[dict] = []  # last-seen in-flight snapshot
        self._seen_primary = False
        self._fired = False
        # guards _manifest, _seen_primary, _fired and is_primary
        self._lock = OrderedLock("resource_manager.StandbyCoordinator._lock")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def check_once(self) -> bool:
        """One monitor pass; returns True iff failover fired THIS pass.
        Public so tests and a chaos harness can step the handshake
        deterministically."""
        with urllib.request.urlopen(
                f"{self.rm_url}/v1/resourcemanager",
                timeout=self.timeout) as r:
            view = json.loads(r.read())
        live = view.get("coordinators", {})
        primary = live.get(self.primary_id)
        if primary is not None and \
                float(primary.get("ageSeconds", 0.0)) <= self.ttl_s:
            with self._lock:
                self._seen_primary = True
                self._fired = False  # primary is back: re-arm
                queries = primary.get("queries")
                if isinstance(queries, list):
                    self._manifest = list(queries)
            return False
        with self._lock:
            if self._fired or not self._seen_primary:
                return False  # never saw it alive, or already took over
            self._fired = True
            self.is_primary = True
            manifest = list(self._manifest)
        self._take_over(manifest)
        return True

    def _take_over(self, manifest: List[dict]) -> None:
        with _FAILOVER_LOCK:
            _FAILOVER["count"] += 1
        adoptable = [q for q in manifest
                     if q.get("state") not in ("FINISHED", "FAILED",
                                               "CANCELED")]
        from .flight_recorder import record_event
        record_event("coordinator_failover", queries=len(adoptable))
        for q in adoptable:
            try:
                self.statement_server.adopt_query(
                    q["queryId"], q.get("slug", ""), q.get("query", ""),
                    q.get("user", "failover"),
                    q.get("sessionProperties") or {})
            except Exception as e:  # noqa: BLE001 - one unadoptable
                # statement must not strand the rest of the manifest
                from .metrics import record_suppressed
                record_suppressed("resource_manager", "adopt_query", e)

    def start(self) -> "StandbyCoordinator":
        def loop():
            while not self._stop.is_set():
                try:
                    self.check_once()
                except Exception as e:  # noqa: BLE001 - RM outage: the
                    # monitor keeps watching, counted
                    from .metrics import record_suppressed
                    record_suppressed("resource_manager", "standby_check",
                                      e)
                self._stop.wait(self.poll_s)
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(self.timeout + 1)


def remote_group_load(rm_url: str, group: str,
                      exclude_coordinator: Optional[str] = None,
                      timeout: float = 5.0) -> int:
    """Cluster-wide RUNNING count for `group` across coordinators
    (excluding the caller's own, which it accounts locally)."""
    with urllib.request.urlopen(f"{rm_url.rstrip('/')}/v1/resourcemanager",
                                timeout=timeout) as r:
        view = json.loads(r.read())
    total = 0
    for cid, st in view["coordinators"].items():
        if cid == exclude_coordinator:
            continue
        gs = st["groups"].get(group)
        if gs:
            total += int(gs.get("running", 0))
    return total
