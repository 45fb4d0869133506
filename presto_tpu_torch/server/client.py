"""Worker HTTP client: the remote-task and exchange-client consumer side.

Counterpart of presto_tpu/server/client.py (`WorkerClient`;
HttpRemoteTaskWithEventLoop.sendUpdate:981 and
ExchangeClient.java:255): task submission and polls, and the
token/ack SerializedPage pull, over one keep-alive HTTP/1.1
connection per client and thread. A stale keep-alive socket is
retried once on a fresh connection after a short seeded backoff.
Every request carries the internal bearer of `shared_secret` (else of
the process-wide secret, server/auth.py); an https url connects with
the trusted cluster CA (server/tls.py). The results pull follows a
drained worker's redirect (`X-Presto-Task-Moved`) to the peer that
adopted its pages and resumes there at the same absolute token. The
reference's cluster-document pulls (profile, history, datapath) come
with ROADMAP queue 1 item 15.
"""

from __future__ import annotations

import http.client
import io
import json
import threading
import time
import urllib.error
import urllib.parse
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import failpoints
from .. import types as T
from ..plan import nodes as N
from ..serde import PageCodec, deserialize_page
from ..utils.backoff import Backoff
from .auth import bearer_headers, make_authenticator

__all__ = ["WorkerClient"]


class _HttpStatusError(urllib.error.HTTPError):
    """An HTTP error status, with urllib's `.code`."""

    def __init__(self, status: int, data: bytes, path: str):
        super().__init__(path, status,
                         data.decode("utf-8", "replace")[:500], None,
                         io.BytesIO(data))


class WorkerClient:
    """One keep-alive connection per (client, thread), reused across
    the pull loop and task polls (the reference's pooled
    PageBufferClient)."""

    def __init__(self, base_url: str, timeout: float = 30.0,
                 shared_secret: Optional[str] = None):
        self.base = base_url.rstrip("/")
        self.timeout = timeout
        self._secret = shared_secret  # the clients of a moved task's peer
        self._auth = make_authenticator(shared_secret, "client")
        u = urllib.parse.urlsplit(self.base)
        self._scheme = u.scheme or "http"
        self._host, self._port = u.hostname, u.port
        self._prefix = u.path.rstrip("/")
        self._local = threading.local()
        # pages and bytes pulled by fetch_results, and its seconds spent
        # in requests and in decoding (the exchange's per-task numbers)
        self.pulled = {"pages": 0, "bytes": 0, "request_s": 0.0,
                       "decode_s": 0.0}

    def _connect(self) -> http.client.HTTPConnection:
        if self._scheme == "https":
            from .tls import client_ssl_context
            return http.client.HTTPSConnection(
                self._host, self._port, timeout=self.timeout,
                context=client_ssl_context())
        return http.client.HTTPConnection(self._host, self._port,
                                          timeout=self.timeout)

    def _request(self, method: str, path: str, body: Optional[bytes] = None):
        headers = dict(bearer_headers(self._auth))
        if body is not None:
            headers["Content-Type"] = "application/json"
        for attempt in (0, 1):
            conn = getattr(self._local, "conn", None)
            if conn is None:
                conn = self._connect()
                self._local.conn = conn
            try:
                if failpoints.ARMED:
                    # drop_conn here is an injected stale keep-alive
                    # socket: the retry below handles it
                    failpoints.hit("client.request")
                conn.request(method, self._prefix + path, body=body,
                             headers=headers)
                resp = conn.getresponse()
                data = resp.read()
                if resp.status >= 400:
                    raise _HttpStatusError(resp.status, data, path)
                return data, dict(resp.getheaders())
            except (http.client.HTTPException, ConnectionError,
                    TimeoutError):
                self._local.conn = None
                conn.close()
                if attempt == 1:
                    raise
                Backoff(base_s=0.02, cap_s=0.25, seed=path).sleep()

    def info(self) -> dict:
        data, _ = self._request("GET", "/v1/info")
        return json.loads(data)

    def status(self) -> dict:
        data, _ = self._request("GET", "/v1/status")
        return json.loads(data)

    def submit(self, task_id: str, plan: N.PlanNode, sf: float = 0.01,
               session: Optional[dict] = None) -> dict:
        return self.submit_body(task_id, {"plan": N.to_json(plan), "sf": sf,
                                          "session": session or {}})

    def submit_body(self, task_id: str, body: dict) -> dict:
        """A raw task body (scanRanges, remoteSources and the rest pass
        through as given)."""
        data, _ = self._request("POST", f"/v1/task/{task_id}",
                                json.dumps(body).encode())
        return json.loads(data)

    def migrate(self, task_id: str, doc: dict) -> dict:
        """Offer a finished task's buffered pages for adoption (a
        draining worker's migration hop: POST /v1/task/{id}/migrate)."""
        data, _ = self._request("POST", f"/v1/task/{task_id}/migrate",
                                json.dumps(doc).encode())
        return json.loads(data)

    def drain(self, migrate_to: Optional[str] = None,
              timeout_ms: Optional[float] = None) -> dict:
        """Start the worker's graceful drain (POST /v1/worker/drain);
        returns its drain document."""
        body = {}
        if migrate_to:
            body["migrateTo"] = migrate_to
        if timeout_ms is not None:
            body["timeoutMs"] = float(timeout_ms)
        data, _ = self._request("POST", "/v1/worker/drain",
                                json.dumps(body).encode())
        return json.loads(data)

    def drain_status(self) -> dict:
        data, _ = self._request("GET", "/v1/worker/drain")
        return json.loads(data)

    def task_info(self, task_id: str) -> dict:
        data, _ = self._request("GET", f"/v1/task/{task_id}")
        return json.loads(data)

    def wait(self, task_id: str, timeout: float = 60.0) -> dict:
        deadline = time.time() + timeout
        info = None
        while time.time() < deadline:
            info = self.task_info(task_id)
            if info["state"] in ("FINISHED", "FAILED", "ABORTED"):
                return info
            time.sleep(0.02)
        state = info["state"] if info else "<never polled>"
        raise TimeoutError(f"task {task_id} still {state}")

    def fetch_results(self, task_id: str, types: Sequence[T.Type],
                      codec: PageCodec = PageCodec(), buffer_id: int = 0,
                      ack: bool = True
                      ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """The token/ack pull until the buffer says complete; the
        columns of its pages concatenated, (values, nulls) each. Raises
        on the deadline and on HTTP 410 (pages acked away by an
        earlier consumer). A drained worker's answer names the peer
        that adopted the task (`X-Presto-Task-Moved`): the pull goes on
        there from the same absolute token, so each page is read once
        across the migration."""
        token = 0
        pages = []
        target = self  # another client once the task's pages moved
        moves = 0
        last_move = None
        peer_misses = 0  # 404s in a row from the peer of a move
        deadline = time.time() + self.timeout
        while True:
            if time.time() > deadline:
                raise TimeoutError(
                    f"results of {task_id}/{buffer_id} not complete after "
                    f"{self.timeout}s")
            t0 = time.perf_counter()
            try:
                data, headers = target._request(
                    "GET", f"/v1/task/{task_id}/results/{buffer_id}/{token}")
            except urllib.error.HTTPError as e:
                if e.code == 404 and target is not self:
                    # the peer's adoption may still be in flight, or it
                    # failed and the origin serves the pages again: try
                    # the peer a few times, then the origin
                    peer_misses += 1
                    if peer_misses >= 10:
                        peer_misses = 0
                        target = self
                        continue
                    time.sleep(0.05)
                    continue
                raise
            finally:
                self.pulled["request_s"] += time.perf_counter() - t0
            peer_misses = 0
            moved = headers.get("X-Presto-Task-Moved")
            if moved:
                # only a move to a new target counts toward the cap: the
                # same move followed again after a fallback to the
                # origin is the wait for a slow adoption
                if moved.rstrip("/") != last_move:
                    moves += 1
                    if moves >= 8:
                        raise RuntimeError(
                            f"task {task_id} pages moved too many times "
                            f"(a migration loop?)")
                    last_move = moved.rstrip("/")
                target = WorkerClient(moved, self.timeout,
                                      shared_secret=self._secret)
                continue
            complete = headers.get("X-Presto-Buffer-Complete") == "true"
            next_token = int(headers.get("X-Presto-Page-Next-Token", token))
            if data:
                t1 = time.perf_counter()
                pages.append(deserialize_page(data, types, codec))
                self.pulled["decode_s"] += time.perf_counter() - t1
                self.pulled["pages"] += 1
                self.pulled["bytes"] += len(data)
                if ack:
                    target._request(
                        "GET", f"/v1/task/{task_id}/results/{buffer_id}/"
                        f"{next_token}/acknowledge")
                token = next_token
            elif complete:
                break
            else:
                time.sleep(0.02)
        if not pages:
            return [(np.array([]), np.array([], dtype=bool)) for _ in types]
        return [(np.concatenate([p[c][0] for p in pages]),
                 np.concatenate([p[c][1] for p in pages]))
                for c in range(len(types))]

    def abort(self, task_id: str) -> dict:
        data, _ = self._request("DELETE", f"/v1/task/{task_id}")
        return json.loads(data)

