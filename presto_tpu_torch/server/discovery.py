"""Discovery service, announcer and failure detection.

Counterpart of presto_tpu/server/discovery.py: the discovery service
a coordinator embeds (workers announce with periodic PUTs: Java
DiscoveryNodeManager, native Announcer.cpp) and the
HeartbeatFailureDetector whose decayed failure rate gates scheduling.

DiscoveryServer: an HTTP service holding node announcements.
Announcer: a worker-side thread re-announcing on an interval.
HeartbeatProber: probes each node's /v1/info and keeps its failure rate.
alive_nodes(): the nodes announced within `max_age_s`, the
scheduler's eligible set.
The reference's fleet-membership counters, goodbye registry and
authentication come with the cluster operations (ROADMAP queue 1 item
14e).
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

__all__ = ["DiscoveryServer", "Announcer", "HeartbeatProber", "alive_nodes"]


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # TCP_NODELAY: a response's headers and body go out in two writes,
    # and with Nagle's algorithm the second waits for the client's
    # delayed ACK (~40 ms a request on Linux)
    disable_nagle_algorithm = True
    nodes: Dict[str, dict] = {}  # set per server on the bound subclass
    lock = threading.Lock()

    def log_message(self, fmt, *args):
        pass

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
        node = self._announcement()
        if node is None:
            return self._json({"error": "bad path"}, 404)
        length = int(self.headers.get("Content-Length", "0"))
        body = json.loads(self.rfile.read(length) or b"{}")
        with self.lock:
            self.nodes[node] = {**body, "nodeId": node,
                                "lastSeen": time.time()}
        return self._json({"announced": True}, 202)

    def do_GET(self):  # noqa: N802  /v1/service/presto-tpu
        parts = [p for p in self.path.split("/") if p]
        if len(parts) >= 2 and parts[:2] == ["v1", "service"]:
            now = time.time()
            with self.lock:
                services = [{**n, "ageSeconds": round(now - n["lastSeen"], 3)}
                            for n in self.nodes.values()]
            return self._json({"services": services})
        return self._json({"error": "bad path"}, 404)

    def do_DELETE(self):  # noqa: N802  a graceful goodbye
        node = self._announcement()
        if node is None:
            return self._json({"error": "bad path"}, 404)
        with self.lock:
            self.nodes.pop(node, None)
        return self._json({"removed": True})


class DiscoveryServer:
    def __init__(self, port: int = 0):
        handler = type("BoundDiscovery", (_Handler,),
                       {"nodes": {}, "lock": threading.Lock()})
        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), handler)
        self.port = self.httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"

    def start(self):
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


class Announcer:
    """Worker-side periodic announcement (Announcer.cpp analog). A
    failed announcement retries on a seeded backoff instead of waiting
    out a whole interval."""

    def __init__(self, discovery_url: str, node_id: str, worker_url: str,
                 interval_s: float = 1.0, environment: str = "tpu"):
        self.discovery_url = discovery_url.rstrip("/")
        self.node_id = node_id
        self.worker_url = worker_url
        self.body = json.dumps({"uri": worker_url, "environment": environment,
                                "coordinator": False,
                                "state": "ACTIVE"}).encode()
        self.interval = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _url(self) -> str:
        return f"{self.discovery_url}/v1/announcement/{self.node_id}"

    def announce_once(self):
        if failpoints.ARMED:
            # an injected error is a discovery outage for this node
            failpoints.hit("discovery.announce")
        req = urllib.request.Request(
            self._url(), data=self.body, method="PUT",
            headers={"Content-Type": "application/json"})
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
                except Exception:  # noqa: BLE001 - discovery is down:
                    # keep trying, as airlift does
                    self._stop.wait(backoff.next_delay())
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self, unannounce: bool = True):
        self._stop.set()
        if self._thread:
            # past announce_once's timeout: a PUT landing after the
            # DELETE would announce a ghost
            self._thread.join(timeout=6)
        if unannounce:
            try:
                urllib.request.urlopen(urllib.request.Request(
                    self._url(), method="DELETE"), timeout=5).read()
            except Exception:  # noqa: BLE001 - a best-effort goodbye;
                # the announcement ages out otherwise
                pass


class HeartbeatProber:
    """Active prober (HeartbeatFailureDetector.java:76 analog): GETs
    each node's /v1/info every `interval_s` and keeps an exponentially
    decayed failure rate per node; healthy() is the subset at or below
    `threshold`. It notices a wedged worker that still announces."""

    def __init__(self, urls_fn, interval_s: float = 0.5,
                 decay: float = 0.7, threshold: float = 0.5,
                 probe_timeout_s: float = 2.0):
        self._urls_fn = urls_fn if callable(urls_fn) else (lambda: urls_fn)
        self.interval = interval_s
        self.decay = decay
        self.threshold = threshold
        self.probe_timeout = probe_timeout_s
        self._rates: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _probe(self, url: str) -> bool:
        try:
            if failpoints.ARMED:
                # an injected failure counts as a missed probe
                failpoints.hit("discovery.probe")
            with urllib.request.urlopen(f"{url.rstrip('/')}/v1/info",
                                        timeout=self.probe_timeout):
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


def alive_nodes(discovery_url: str, max_age_s: float = 5.0) -> List[dict]:
    """The failure detector's view: the nodes announced within
    `max_age_s` (a stale node has failed)."""
    with urllib.request.urlopen(
            f"{discovery_url.rstrip('/')}/v1/service/presto-tpu",
            timeout=5) as resp:
        services = json.loads(resp.read())["services"]
    return [s for s in services if s["ageSeconds"] <= max_age_s]
