"""Worker HTTP client: the remote-task and exchange-client consumer side.

Counterpart of presto_tpu/server/client.py (`WorkerClient`;
HttpRemoteTaskWithEventLoop.sendUpdate:981 and
ExchangeClient.java:255): task submission and polls, and the
token/ack SerializedPage pull, over one keep-alive HTTP/1.1
connection per client and thread. A stale keep-alive socket is
retried once on a fresh connection after a short seeded backoff.
The reference's authentication, TLS, drain redirects and the
cluster-document pulls (profile, history, datapath) come with their
tiers (ROADMAP queue 1 items 14e and 15).
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

    def __init__(self, base_url: str, timeout: float = 30.0):
        self.base = base_url.rstrip("/")
        self.timeout = timeout
        u = urllib.parse.urlsplit(self.base)
        self._host, self._port = u.hostname, u.port
        self._prefix = u.path.rstrip("/")
        self._local = threading.local()
        # pages and bytes pulled by fetch_results, and its seconds spent
        # in requests and in decoding (the exchange's per-task numbers)
        self.pulled = {"pages": 0, "bytes": 0, "request_s": 0.0,
                       "decode_s": 0.0}

    def _request(self, method: str, path: str, body: Optional[bytes] = None):
        headers = {"Content-Type": "application/json"} \
            if body is not None else {}
        for attempt in (0, 1):
            conn = getattr(self._local, "conn", None)
            if conn is None:
                conn = http.client.HTTPConnection(self._host, self._port,
                                                  timeout=self.timeout)
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
        earlier consumer)."""
        token = 0
        pages = []
        deadline = time.time() + self.timeout
        while True:
            if time.time() > deadline:
                raise TimeoutError(
                    f"results of {task_id}/{buffer_id} not complete after "
                    f"{self.timeout}s")
            t0 = time.perf_counter()
            data, headers = self._request(
                "GET", f"/v1/task/{task_id}/results/{buffer_id}/{token}")
            self.pulled["request_s"] += time.perf_counter() - t0
            complete = headers.get("X-Presto-Buffer-Complete") == "true"
            next_token = int(headers.get("X-Presto-Page-Next-Token", token))
            if data:
                t1 = time.perf_counter()
                pages.append(deserialize_page(data, types, codec))
                self.pulled["decode_s"] += time.perf_counter() - t1
                self.pulled["pages"] += 1
                self.pulled["bytes"] += len(data)
                if ack:
                    self._request(
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

