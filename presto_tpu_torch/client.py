"""The statement-protocol client: StatementClientV1.

Counterpart of presto_tpu/client.py (presto-client's StatementClientV1:
the constructor POSTs /v1/statement, advance() follows `nextUri` until
it is gone, gathering the data pages; the X-Presto-Set-Session,
X-Presto-Started-Transaction-Id and X-Presto-Clear-Transaction-Id
response headers change the client's session). Standard-library HTTP
only and no engine import, so it drives the port's statement server
(server/statement.py) or the reference's, which speak one protocol.
"""

from __future__ import annotations

import json
import os
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Tuple

__all__ = ["StatementClient", "QueryError", "execute",
           "DEFAULT_DEADLINE_S"]

# the whole statement's deadline: past it the poll loop cancels (as it
# can) and raises CLIENT_POLL_TIMEOUT. The server answers each poll
# promptly even while the engine is wedged, so the per-request timeout
# never fires; without this a hung tier would block the caller forever.
# PRESTO_TPU_CLIENT_DEADLINE_S overrides it.
DEFAULT_DEADLINE_S = 3600.0


class QueryError(RuntimeError):
    def __init__(self, error: dict):
        super().__init__(error.get("message", "query failed"))
        self.error = error
        self.error_name = error.get("errorName", "GENERIC_INTERNAL_ERROR")
        self.error_type = error.get("errorType", "INTERNAL_ERROR")


def _wire_error(message: str) -> dict:
    return {"message": str(message), "errorCode": 16,
            "errorName": "PROTOCOL_ERROR", "errorType": "EXTERNAL"}


class StatementClient:
    """One statement's lifecycle: the POST, then advance() until done."""

    def __init__(self, server_url: str, text: str, user: str = "presto",
                 session: Optional[Dict[str, str]] = None,
                 transaction_id: Optional[str] = None,
                 timeout: float = 120.0,
                 deadline_s: Optional[float] = None):
        """`timeout` bounds each HTTP request, `deadline_s` the whole
        statement (None: PRESTO_TPU_CLIENT_DEADLINE_S, else
        DEFAULT_DEADLINE_S; 0: no bound)."""
        self.server_url = server_url.rstrip("/")
        self.timeout = timeout
        if deadline_s is None:
            try:
                deadline_s = float(os.environ.get(
                    "PRESTO_TPU_CLIENT_DEADLINE_S", DEFAULT_DEADLINE_S))
            except ValueError:
                deadline_s = DEFAULT_DEADLINE_S
        self.deadline_s = deadline_s
        self._deadline = (time.time() + deadline_s) if deadline_s else None
        self.columns: Optional[List[dict]] = None
        self.data: List[list] = []
        self.stats: Dict = {}
        self.update_type: Optional[str] = None
        self.set_session: Dict[str, str] = {}
        self.started_transaction_id: Optional[str] = None
        self.clear_transaction = False
        self.query_id: Optional[str] = None
        self._error: Optional[dict] = None

        headers = {"X-Presto-User": user, "Content-Type": "text/plain"}
        if session:
            headers["X-Presto-Session"] = ",".join(
                f"{k}={v}" for k, v in session.items())
        if transaction_id:
            headers["X-Presto-Transaction-Id"] = transaction_id
        doc, _ = self._request(f"{self.server_url}/v1/statement",
                               method="POST", body=text.encode(),
                               headers=headers, follow_307=True)
        self._absorb(doc, {})
        self._next_uri = doc.get("nextUri")

    def _request(self, url: str, method: str = "GET",
                 body: Optional[bytes] = None,
                 headers: Optional[Dict] = None,
                 follow_307: bool = False) -> Tuple[dict, Dict]:
        req = urllib.request.Request(url, data=body, method=method,
                                     headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read().decode()), dict(resp.headers)
        except urllib.error.HTTPError as e:
            if e.code == 307 and follow_307 and e.headers.get("Location"):
                # a router sent the statement on: POST it there
                return self._request(e.headers["Location"], method=method,
                                     body=body, headers=headers)
            # an error status still carries the protocol's JSON document
            try:
                doc = json.loads(e.read().decode())
            except ValueError:
                doc = {}
            if isinstance(doc.get("error"), dict):
                raise QueryError(doc["error"]) from None
            raise QueryError(_wire_error(
                doc.get("error") or f"HTTP {e.code}: {e.reason}")) from None

    def _absorb(self, doc: dict, headers: Dict) -> None:
        self.query_id = doc.get("id", self.query_id)
        if doc.get("columns") and self.columns is None:
            self.columns = doc["columns"]
        if doc.get("data"):
            self.data.extend(doc["data"])
        if doc.get("stats"):
            self.stats = doc["stats"]
        if doc.get("updateType"):
            self.update_type = doc["updateType"]
        if doc.get("error"):
            self._error = doc["error"]
        for k, v in headers.items():
            lk = k.lower()
            if lk == "x-presto-set-session" and "=" in v:
                sk, sv = v.split("=", 1)
                self.set_session[sk] = sv
            elif lk == "x-presto-started-transaction-id":
                self.started_transaction_id = v
            elif lk == "x-presto-clear-transaction-id":
                self.clear_transaction = True

    def advance(self) -> bool:
        """Fetch the next results document; False when finished. Past
        the deadline, cancel and raise CLIENT_POLL_TIMEOUT."""
        if self._next_uri is None:
            return False
        if self._deadline is not None and time.time() > self._deadline:
            self.cancel()
            raise QueryError({
                "message": f"statement {self.query_id or '<unknown>'} "
                           f"did not complete within {self.deadline_s}s "
                           f"(client poll deadline)",
                "errorCode": 16, "errorName": "CLIENT_POLL_TIMEOUT",
                "errorType": "EXTERNAL"})
        doc, headers = self._request(self._next_uri)
        self._absorb(doc, headers)
        self._next_uri = doc.get("nextUri")
        return self._next_uri is not None

    def drain(self) -> "StatementClient":
        while self.advance():
            pass
        if self._error is not None:
            raise QueryError(self._error)
        return self

    def cancel(self) -> None:
        """DELETE the statement's next URI, as far as the server can be
        reached."""
        if self._next_uri is not None:
            try:
                self._request(self._next_uri, method="DELETE")
            except (QueryError, OSError):
                pass
            self._next_uri = None


def execute(server_url: str, text: str, user: str = "presto",
            session: Optional[Dict[str, str]] = None,
            transaction_id: Optional[str] = None,
            timeout: float = 120.0,
            deadline_s: Optional[float] = None) -> StatementClient:
    """POST and drain: the finished client (columns, data, stats)."""
    return StatementClient(server_url, text, user=user, session=session,
                           transaction_id=transaction_id, timeout=timeout,
                           deadline_s=deadline_s).drain()
