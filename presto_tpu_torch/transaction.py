"""Transaction management: the TransactionManager.

Counterpart of presto_tpu/transaction.py (presto-main-base's
InMemoryTransactionManager: begin, commit and rollback, per-connector
handles made on first access, single-statement auto-commit contexts
and idle reaping). The statement server runs every statement inside a
transaction (START TRANSACTION ... COMMIT, or an auto-commit context),
and the DB-API's connections begin one implicitly.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import uuid
from typing import Dict

__all__ = ["TransactionManager", "TransactionInfo", "IsolationLevel",
           "NotInTransaction", "ISOLATION_LEVELS"]

# the SQL standard levels (spi/transaction/IsolationLevel)
ISOLATION_LEVELS = ("READ UNCOMMITTED", "READ COMMITTED",
                    "REPEATABLE READ", "SERIALIZABLE")
IsolationLevel = str


class NotInTransaction(RuntimeError):
    """An unknown, finished or reaped transaction id."""


@dataclasses.dataclass
class TransactionInfo:
    transaction_id: str
    isolation: IsolationLevel
    read_only: bool
    auto_commit: bool
    created_at: float
    # connector name -> its transaction handle, made on first access
    connector_handles: Dict[str, dict] = dataclasses.field(
        default_factory=dict)
    last_access: float = 0.0
    # set while run_autocommit runs the statement: never reaped then
    in_use: bool = False

    def to_json(self) -> dict:
        return {"transactionId": self.transaction_id,
                "isolationLevel": self.isolation,
                "readOnly": self.read_only,
                "autoCommitContext": self.auto_commit,
                "catalogs": sorted(self.connector_handles)}


class TransactionManager:
    """begin, commit and rollback; auto-commit contexts; idle reaping
    (on begin) of transactions untouched for `idle_timeout_s`."""

    def __init__(self, idle_timeout_s: float = 300.0):
        self._lock = threading.Lock()
        self._txns: Dict[str, TransactionInfo] = {}
        self.idle_timeout_s = idle_timeout_s

    def begin(self, isolation: IsolationLevel = "READ UNCOMMITTED",
              read_only: bool = False, auto_commit: bool = False) -> str:
        if isolation not in ISOLATION_LEVELS:
            raise ValueError(f"unknown isolation level {isolation!r}")
        tid = f"tx_{uuid.uuid4().hex[:16]}"
        now = time.time()
        with self._lock:
            self._reap_locked(now)
            self._txns[tid] = TransactionInfo(tid, isolation, read_only,
                                              auto_commit, now,
                                              last_access=now)
        return tid

    def get(self, tid: str) -> TransactionInfo:
        with self._lock:
            info = self._txns.get(tid)
            if info is None:
                raise NotInTransaction(f"unknown transaction {tid}")
            info.last_access = time.time()
            return info

    def connector_handle(self, tid: str, connector: str) -> dict:
        """The transaction's handle for `connector`, made on first
        access; looked up and made under one lock, so that no commit
        or rollback can race a handle onto a finished transaction."""
        with self._lock:
            info = self._txns.get(tid)
            if info is None:
                raise NotInTransaction(f"unknown transaction {tid}")
            info.last_access = time.time()
            handle = info.connector_handles.get(connector)
            if handle is None:
                handle = {"connector": connector, "transactionId": tid,
                          "readOnly": info.read_only,
                          "isolation": info.isolation}
                info.connector_handles[connector] = handle
            return handle

    def access_check_write(self, tid: str, connector: str) -> None:
        """Refuse a write in a read-only transaction (the reference's
        checkConnectorWrite)."""
        if self.get(tid).read_only:
            raise RuntimeError(f"transaction {tid} is read-only; cannot "
                               f"write to {connector}")

    def _end(self, tid: str) -> None:
        with self._lock:
            if self._txns.pop(tid, None) is None:
                raise NotInTransaction(f"unknown transaction {tid}")

    def commit(self, tid: str) -> None:
        self._end(tid)

    def rollback(self, tid: str) -> None:
        self._end(tid)

    def active(self) -> list:
        with self._lock:
            return [t.to_json() for t in self._txns.values()]

    def run_autocommit(self, fn, *, read_only: bool = True):
        """Run `fn(tid)` in a single-statement auto-commit transaction:
        commit on success, roll back on error."""
        tid = self.begin(read_only=read_only, auto_commit=True)
        with self._lock:
            self._txns[tid].in_use = True
        try:
            out = fn(tid)
        except BaseException:
            self.rollback(tid)
            raise
        self.commit(tid)
        return out

    def _reap_locked(self, now: float) -> None:
        # an abandoned auto-commit transaction is reaped too; one that
        # run_autocommit is running is not
        cutoff = now - self.idle_timeout_s
        for tid in [t for t, info in self._txns.items()
                    if info.last_access < cutoff and not info.in_use]:
            del self._txns[tid]
