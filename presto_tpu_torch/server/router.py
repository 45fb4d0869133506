"""Query router: statement traffic across clusters.

Counterpart of presto_tpu/server/router.py (presto-router's
RouterResource, which redirects /v1/statement to a scheduled cluster,
and presto-plan-checker-router-plugin, which dry-runs the native plan
validator to send a query the engine cannot take to a Java cluster).
The router fronts N coordinator urls:

  * scheduling: smooth weighted round robin over the clusters whose
    /v1/info answers (an unhealthy one drops out until it answers);
  * plan-checker routing: a statement the port's planner cannot plan
    (sql/planner.py::plan_sql fails) goes to the cluster registered
    with kind="fallback";
  * failover: a kind="standby" cluster serves only while no primary
    answers;
  * transport: a 307 redirect to the chosen cluster's /v1/statement
    (the client POSTs again; StatementClient follows it).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional

from ..utils.locks import OrderedLock


__all__ = ["RouterServer", "tpu_plan_checker"]


def tpu_plan_checker(text: str) -> bool:
    """Dry-run the engine's planner (VeloxPlanValidator dry-run analog):
    True = the TPU engine can take this statement."""
    from ..sql.planner import plan_sql
    try:
        plan_sql(text)
        return True
    except Exception:  # noqa: BLE001 - any planning failure = route away
        return False


class _Cluster:
    def __init__(self, url: str, weight: int = 1, kind: str = "tpu"):
        self.url = url.rstrip("/")
        self.weight = max(1, int(weight))
        self.kind = kind
        self.current = 0  # smooth-WRR accumulator


class RouterServer:
    def __init__(self, clusters: List[Dict], port: int = 0,
                 checker: Optional[Callable[[str], bool]] = None,
                 health_ttl_s: float = 2.0):
        self.clusters = [_Cluster(**c) for c in clusters]
        self.checker = checker if checker is not None else tpu_plan_checker
        self.health_ttl = health_ttl_s
        self._health: Dict[str, tuple] = {}  # url -> (ok, checked_at)
        self._lock = OrderedLock("router.RouterServer._lock")
        self._httpd = ThreadingHTTPServer(("127.0.0.1", port),
                                          _make_handler(self))
        self.port = self._httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- scheduling -----------------------------------------------------

    def _healthy(self, c: _Cluster) -> bool:
        now = time.time()
        with self._lock:
            hit = self._health.get(c.url)
            if hit is not None and now - hit[1] < self.health_ttl:
                return hit[0]
        ok = False
        try:
            with urllib.request.urlopen(f"{c.url}/v1/info", timeout=2):
                ok = True
        except Exception:  # noqa: BLE001
            ok = False
        with self._lock:
            self._health[c.url] = (ok, now)
        return ok

    def pick(self, text: str) -> Optional[_Cluster]:
        if not self.checker(text):
            # plan-checker fallback: the primary engine cannot take it
            for c in self.clusters:
                if c.kind == "fallback" and self._healthy(c):
                    return c
            return None
        primaries = [c for c in self.clusters
                     if c.kind not in ("fallback", "standby")
                     and self._healthy(c)]
        if not primaries:
            # coordinator failover: standby clusters serve statement
            # traffic only while NO primary answers -- the router half
            # of the StandbyCoordinator handshake (the standby is
            # meanwhile adopting the dead primary's in-flight queries)
            primaries = [c for c in self.clusters
                         if c.kind == "standby" and self._healthy(c)]
        if not primaries:
            # degraded: a healthy fallback beats failing the query
            primaries = [c for c in self.clusters if self._healthy(c)]
        if not primaries:
            return None
        # smooth weighted round-robin (nginx algorithm)
        with self._lock:
            total = sum(c.weight for c in primaries)
            for c in primaries:
                c.current += c.weight
            best = max(primaries, key=lambda c: c.current)
            best.current -= total
            return best


def _make_handler(router: RouterServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # TCP_NODELAY, as on the port's other servers
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):
            pass

        def _json(self, doc, code=200, headers=None):
            body = json.dumps(doc).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):  # noqa: N802
            if self.path.rstrip("/") != "/v1/statement":
                self._json({"error": "not found"}, 404)
                return
            length = int(self.headers.get("Content-Length", "0") or 0)
            text = self.rfile.read(length).decode("utf-8", "replace")
            target = router.pick(text)
            if target is None:
                self._json({"error": {
                    "message": "no healthy cluster can take this query",
                    "errorCode": 131072,
                    "errorName": "NO_CLUSTER_AVAILABLE",
                    "errorType": "INSUFFICIENT_RESOURCES",
                    "failureInfo": {"type": "NO_CLUSTER_AVAILABLE",
                                    "message": text[:200]}}}, 503)
                return
            # 307 preserves the POST (RouterResource redirect contract)
            self._json({"redirect": f"{target.url}/v1/statement"}, 307,
                       {"Location": f"{target.url}/v1/statement"})

        def do_GET(self):  # noqa: N802
            if self.path.rstrip("/") == "/v1/info":
                self._json({"router": True, "clusters": [
                    {"url": c.url, "kind": c.kind, "weight": c.weight,
                     "healthy": router._healthy(c)}
                    for c in router.clusters]})
                return
            self._json({"error": "not found"}, 404)

    return Handler
