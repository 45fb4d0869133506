"""Discovery service, announcer and failure detection.

Counterpart of presto_tpu/server/discovery.py: the discovery service
a coordinator embeds (workers announce with periodic PUTs: Java
DiscoveryNodeManager, native Announcer.cpp) and the
HeartbeatFailureDetector whose decayed failure rate gates scheduling.

DiscoveryServer: an HTTP service holding node announcements.
Announcer: a worker-side thread re-announcing on an interval.
HeartbeatProber: probes each node's /v1/info and keeps its failure rate.
alive_nodes(): the nodes announced within `max_age_s`, the
scheduler's eligible set. An announcement carries the node's fleet
state, ACTIVE or DRAINING: a DRAINING node stays announced while its
pages are served or migrated, and the Coordinator places no new task
on it.

The fleet's membership is process-wide: every discovery server and
announcer of the process counts joins, leaves and announce retries
(`fleet_membership_totals`, `announce_retry_totals`), and a graceful
goodbye marks the node's url in the goodbye registry
(`note_unannounced`), cleared when it announces again. With a
`shared_secret` (or the process-wide one of server/auth.py) every
request carries and every server checks the internal bearer; with
`tls=(cert, key)` the server speaks https. Survived errors are counted
(server/metrics.py::record_suppressed), and the counters are metric
families of both tiers' /v1/metrics (metrics.fleet_families).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from .. import failpoints
from ..utils.backoff import Backoff
from .auth import authorize_request, bearer_headers, make_authenticator
from ..utils.locks import OrderedLock

__all__ = ["DiscoveryServer", "Announcer", "HeartbeatProber", "alive_nodes",
           "fleet_membership_totals", "announce_retry_totals",
           "note_unannounced", "clear_unannounced", "recently_unannounced",
           "reset_fleet_state"]

# the process-wide fleet membership, under one lock
_FLEET_LOCK = OrderedLock("discovery._FLEET_LOCK")
_FLEET = {"joined": 0, "left": 0, "announce_retries": 0}
# url -> the time of its goodbye; cleared when the node announces again
# and forgotten after the ttl, so that a new process reusing the port
# later does not inherit the goodbye
_UNANNOUNCED: Dict[str, float] = {}
_UNANNOUNCED_TTL_S = 60.0


def fleet_membership_totals() -> Dict[str, int]:
    with _FLEET_LOCK:
        return {"joined": _FLEET["joined"], "left": _FLEET["left"]}


def announce_retry_totals() -> int:
    with _FLEET_LOCK:
        return _FLEET["announce_retries"]


def _count_fleet(key: str, delta: int = 1) -> None:
    with _FLEET_LOCK:
        _FLEET[key] += delta


def note_unannounced(uri: Optional[str]) -> None:
    """Record a graceful goodbye of the worker at `uri`."""
    if not uri:
        return
    with _FLEET_LOCK:
        _UNANNOUNCED[uri.rstrip("/")] = time.time()


def clear_unannounced(uri: Optional[str]) -> None:
    """Drop the goodbye mark of `uri`: a node announcing again clears
    its own, and a new worker server bound to the same url clears a
    drained predecessor's."""
    if not uri:
        return
    with _FLEET_LOCK:
        _UNANNOUNCED.pop(uri.rstrip("/"), None)


def recently_unannounced() -> Dict[str, float]:
    """{url: the time of its goodbye} of the workers that said goodbye
    within the ttl and have not announced since."""
    now = time.time()
    with _FLEET_LOCK:
        for uri in [u for u, ts in _UNANNOUNCED.items()
                    if now - ts > _UNANNOUNCED_TTL_S]:
            del _UNANNOUNCED[uri]
        return dict(_UNANNOUNCED)


def reset_fleet_state() -> None:
    """Counters and goodbye registry back to empty (test isolation)."""
    with _FLEET_LOCK:
        _FLEET.update({"joined": 0, "left": 0, "announce_retries": 0})
        _UNANNOUNCED.clear()


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # TCP_NODELAY: a response's headers and body go out in two writes,
    # and with Nagle's algorithm the second waits for the client's
    # delayed ACK (~40 ms a request on Linux)
    disable_nagle_algorithm = True
    nodes: Dict[str, dict] = {}  # set per server on the bound subclass
    lock = OrderedLock("discovery._Handler.lock")
    authenticator = None  # an InternalAuthenticator when a secret is set

    def log_message(self, fmt, *args):
        pass

    def _authorized(self) -> bool:
        return authorize_request(self, self.authenticator, self._json)

    def _json(self, obj, code=200):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _announcement(self):
        parts = [p for p in self.path.split("/") if p]
        if len(parts) == 3 and parts[:2] == ["v1", "announcement"]:
            return parts[2]
        return None

    def do_PUT(self):  # noqa: N802  /v1/announcement/{node_id}
        if not self._authorized():
            return
        node = self._announcement()
        if node is None:
            return self._json({"error": "bad path"}, 404)
        length = int(self.headers.get("Content-Length", "0"))
        body = json.loads(self.rfile.read(length) or b"{}")
        with self.lock:
            joined = node not in self.nodes
            self.nodes[node] = {**body, "nodeId": node,
                                "lastSeen": time.time()}
        if joined:
            _count_fleet("joined")
        # an announcing node is back in the fleet
        clear_unannounced(body.get("uri"))
        return self._json({"announced": True}, 202)

    def do_GET(self):  # noqa: N802  /v1/service/presto-tpu
        if not self._authorized():
            return
        parts = [p for p in self.path.split("/") if p]
        if len(parts) >= 2 and parts[:2] == ["v1", "service"]:
            now = time.time()
            with self.lock:
                services = [{**n, "ageSeconds": round(now - n["lastSeen"], 3)}
                            for n in self.nodes.values()]
            return self._json({"services": services})
        return self._json({"error": "bad path"}, 404)

    def do_DELETE(self):  # noqa: N802  a graceful goodbye
        if not self._authorized():
            return
        node = self._announcement()
        if node is None:
            return self._json({"error": "bad path"}, 404)
        with self.lock:
            gone = self.nodes.pop(node, None)
        if gone is not None:
            _count_fleet("left")
            note_unannounced(gone.get("uri"))
        return self._json({"removed": True})


class DiscoveryServer:
    """The discovery service on 127.0.0.1:`port` (0: a free port);
    `shared_secret` requires the internal bearer on every request,
    `tls=(cert, key)` serves https."""

    def __init__(self, port: int = 0, shared_secret: Optional[str] = None,
                 tls: Optional[tuple] = None):
        handler = type("BoundDiscovery", (_Handler,), {
            "nodes": {}, "lock": OrderedLock("discovery._Handler.lock"),
            "authenticator": make_authenticator(shared_secret,
                                                "discovery")})
        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), handler)
        scheme = "http"
        if tls is not None:
            from .tls import server_context
            self.httpd.socket = server_context(*tls).wrap_socket(
                self.httpd.socket, server_side=True)
            scheme = "https"
        self.port = self.httpd.server_address[1]
        self.url = f"{scheme}://127.0.0.1:{self.port}"

    def start(self):
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


class Announcer:
    """Worker-side periodic announcement (Announcer.cpp analog). A
    failed announcement retries on a seeded backoff instead of waiting
    out a whole interval, and counts as an announce retry."""

    def __init__(self, discovery_url: str, node_id: str, worker_url: str,
                 interval_s: float = 1.0, environment: str = "tpu",
                 shared_secret: Optional[str] = None,
                 ttl_epoch_s: Optional[float] = None):
        self.discovery_url = discovery_url.rstrip("/")
        self.node_id = node_id
        self.worker_url = worker_url
        self._body_doc = {"uri": worker_url, "environment": environment,
                          "coordinator": False, "state": "ACTIVE"}
        if ttl_epoch_s is not None:
            # the instant this node expects to leave the cluster
            self._body_doc["ttlEpochSeconds"] = float(ttl_epoch_s)
        self.interval = interval_s
        self._auth = make_authenticator(shared_secret, node_id)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def body(self) -> bytes:
        return json.dumps(self._body_doc).encode()

    def set_state(self, state: str) -> None:
        """The announced fleet state, ACTIVE or DRAINING, from the next
        announcement on."""
        self._body_doc["state"] = str(state)

    def _url(self) -> str:
        return f"{self.discovery_url}/v1/announcement/{self.node_id}"

    def _headers(self) -> dict:
        return {"Content-Type": "application/json",
                **bearer_headers(self._auth)}

    def announce_once(self):
        if failpoints.ARMED:
            # an injected error is a discovery outage for this node
            failpoints.hit("discovery.announce")
        req = urllib.request.Request(
            self._url(), data=self.body, method="PUT",
            headers=self._headers())
        urllib.request.urlopen(req, timeout=5).read()

    def start(self):
        def loop():
            backoff = Backoff(base_s=0.05, cap_s=min(self.interval, 2.0),
                              seed=self.node_id)
            while not self._stop.is_set():
                try:
                    self.announce_once()
                    backoff.attempt = 0
                    self._stop.wait(self.interval)
                except Exception as e:  # noqa: BLE001 - discovery is
                    # down: keep trying, as airlift does, and count it
                    from .metrics import record_suppressed
                    record_suppressed("discovery", "announce", e)
                    _count_fleet("announce_retries")
                    self._stop.wait(backoff.next_delay())
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def unannounce_once(self):
        """One goodbye DELETE; raises when it fails."""
        if failpoints.ARMED:
            # a lost goodbye: the node lingers in discovery until its
            # announcement ages out
            failpoints.hit("discovery.unannounce_lost")
        req = urllib.request.Request(self._url(), method="DELETE",
                                     headers=self._headers())
        urllib.request.urlopen(req, timeout=5).read()

    def stop(self, unannounce: bool = True):
        self._stop.set()
        if self._thread:
            # past announce_once's timeout: a PUT landing after the
            # DELETE would announce a ghost
            self._thread.join(timeout=6)
        if unannounce:
            try:
                self.unannounce_once()
            except Exception as e:  # noqa: BLE001 - a best-effort
                # goodbye; the announcement ages out otherwise
                from .metrics import record_suppressed
                record_suppressed("discovery", "unannounce", e)


class HeartbeatProber:
    """Active prober (HeartbeatFailureDetector.java:76 analog): GETs
    each node's /v1/info every `interval_s` and keeps an exponentially
    decayed failure rate per node; healthy() is the subset at or below
    `threshold`. It notices a wedged worker that still announces."""

    def __init__(self, urls_fn, interval_s: float = 0.5,
                 decay: float = 0.7, threshold: float = 0.5,
                 probe_timeout_s: float = 2.0,
                 shared_secret: Optional[str] = None):
        self._auth = make_authenticator(shared_secret, "prober") \
            if shared_secret is not None else None
        self._urls_fn = urls_fn if callable(urls_fn) else (lambda: urls_fn)
        self.interval = interval_s
        self.decay = decay
        self.threshold = threshold
        self.probe_timeout = probe_timeout_s
        self._rates: Dict[str, float] = {}
        self._lock = OrderedLock("discovery.HeartbeatProber._lock")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _probe(self, url: str) -> bool:
        try:
            if failpoints.ARMED:
                # an injected failure counts as a missed probe
                failpoints.hit("discovery.probe")
            req = urllib.request.Request(f"{url.rstrip('/')}/v1/info",
                                         headers=bearer_headers(self._auth))
            with urllib.request.urlopen(req, timeout=self.probe_timeout):
                return True
        except Exception:  # noqa: BLE001 - any failure counts
            return False

    def probe_all_once(self) -> None:
        # in parallel: one black-holed node must not delay the others'
        urls = [u.rstrip("/") for u in self._urls_fn()]
        results: Dict[str, bool] = {}

        def one(u):
            results[u] = self._probe(u)

        threads = [threading.Thread(target=one, args=(u,), daemon=True)
                   for u in urls]
        for t in threads:
            t.start()
        for t in threads:
            t.join(self.probe_timeout + 1)
        with self._lock:
            for u in urls:
                self._rates[u] = self._rates.get(u, 0.0) * self.decay + \
                    (0.0 if results.get(u, False) else 1.0) * (1 - self.decay)
            for gone in [u for u in self._rates if u not in urls]:
                del self._rates[gone]

    def failure_rate(self, url: str) -> float:
        with self._lock:
            return self._rates.get(url.rstrip("/"), 0.0)

    def healthy(self) -> List[str]:
        urls = [u.rstrip("/") for u in self._urls_fn()]
        with self._lock:
            return [u for u in urls
                    if self._rates.get(u, 0.0) <= self.threshold]

    def start(self):
        def loop():
            while not self._stop.is_set():
                self.probe_all_once()
                self._stop.wait(self.interval)
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=self.probe_timeout + 1)


def alive_nodes(discovery_url: str, max_age_s: float = 5.0,
                shared_secret: Optional[str] = None) -> List[dict]:
    """The failure detector's view: the nodes announced within
    `max_age_s` (a stale node has failed), each with its announced
    `state` (ACTIVE or DRAINING). Without `shared_secret` the request
    carries the process-wide secret's bearer, if there is one."""
    auth = make_authenticator(shared_secret, "detector") \
        if shared_secret is not None else None
    req = urllib.request.Request(
        f"{discovery_url.rstrip('/')}/v1/service/presto-tpu",
        headers=bearer_headers(auth))
    with urllib.request.urlopen(req, timeout=5) as resp:
        services = json.loads(resp.read())["services"]
    return [s for s in services if s["ageSeconds"] <= max_age_s]
