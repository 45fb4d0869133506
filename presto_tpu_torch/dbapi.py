"""PEP 249 DB-API over the port: the presto-jdbc analog for Python.

Counterpart of presto_tpu/dbapi.py. In local mode the statements run in
this process through `sql()` on the connection's device (CUDA unless
`device` names another); `connect(server="http://host:port")` speaks
the client statement protocol (client.py) to a statement server
instead. A connection begins a transaction implicitly at its first
statement (PEP 249), which commit() and rollback() end; it is read-only
unless `read_only=False`.

    import presto_tpu_torch.dbapi as db
    conn = db.connect(sf=0.1)
    cur = conn.cursor()
    cur.execute("SELECT custkey, count(*) FROM orders GROUP BY custkey")
    print(cur.fetchmany(5))
"""

from __future__ import annotations

import datetime
import decimal
from typing import Any, List, Optional, Sequence

apilevel = "2.0"
threadsafety = 1
paramstyle = "qmark"

__all__ = ["connect", "Connection", "Cursor", "HttpConnection",
           "HttpCursor", "Error", "ProgrammingError"]


class Error(Exception):
    pass


class ProgrammingError(Error):
    pass


def connect(sf: float = 0.01, mesh=None, max_groups: int = 1 << 16,
            server: Optional[str] = None, user: str = "presto",
            **kwargs):
    """A local connection, or with `server` one over the statement
    protocol (the jdbc:presto://host URL)."""
    if server is not None:
        session = dict(kwargs.pop("session", None) or {})
        session.setdefault("sf", str(sf))
        return HttpConnection(server, user=user, session=session, **kwargs)
    return Connection(sf=sf, mesh=mesh, max_groups=max_groups, **kwargs)


class Connection:
    def __init__(self, sf: float, mesh=None, max_groups: int = 1 << 16,
                 read_only: bool = True, device=None, **kwargs):
        from .transaction import TransactionManager
        self.sf = sf
        self.mesh = mesh
        self.max_groups = max_groups
        self.read_only = read_only
        self.device = device
        self.kwargs = kwargs
        self._closed = False
        self._txn_manager = TransactionManager()
        self._txn_id = None

    def cursor(self) -> "Cursor":
        if self._closed:
            raise ProgrammingError("connection is closed")
        return Cursor(self)

    def close(self):
        if self._txn_id is not None:
            self._txn_manager.rollback(self._txn_id)
            self._txn_id = None
        self._closed = True

    def _current_txn(self) -> str:
        if self._txn_id is None:
            self._txn_id = self._txn_manager.begin(read_only=self.read_only)
        return self._txn_id

    def _end_txn(self, end) -> None:
        if self._closed:
            raise ProgrammingError("connection is closed")
        if self._txn_id is not None:
            end(self._txn_id)
            self._txn_id = None

    def commit(self):
        self._end_txn(self._txn_manager.commit)

    def rollback(self):
        self._end_txn(self._txn_manager.rollback)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Cursor:
    arraysize = 1

    def __init__(self, conn):
        self.conn = conn
        self._rows: Optional[List[tuple]] = None
        self._pos = 0
        self.description = None
        self.rowcount = -1

    def execute(self, sql_text: str, parameters: Sequence[Any] = ()):
        if self.conn._closed:
            raise ProgrammingError("connection is closed")
        self.conn._current_txn()
        if parameters:
            sql_text = _bind(sql_text, parameters)
        from .sql import sql as run_sql
        kw = dict(self.conn.kwargs)
        if self.conn.mesh is not None:
            kw["mesh"] = self.conn.mesh
        try:
            res = run_sql(sql_text, sf=self.conn.sf, device=self.conn.device,
                          max_groups=self.conn.max_groups, **kw)
        except Error:
            raise
        except Exception as e:  # noqa: BLE001 - the DB-API's error contract
            raise ProgrammingError(str(e)) from e
        self._rows = res.rows()
        self._pos = 0
        self.rowcount = res.row_count
        self.description = [
            (res.names[i], str(res.types[i]) if res.types else None,
             None, None, None, None, None)
            for i in range(len(res.names))]
        return self

    def executemany(self, sql_text: str, seq_of_params):
        for p in seq_of_params:
            self.execute(sql_text, p)
        return self

    def fetchone(self) -> Optional[tuple]:
        self._check()
        if self._pos >= len(self._rows):
            return None
        row = self._rows[self._pos]
        self._pos += 1
        return row

    def fetchmany(self, size: Optional[int] = None) -> List[tuple]:
        self._check()
        size = size or self.arraysize
        out = self._rows[self._pos:self._pos + size]
        self._pos += len(out)
        return out

    def fetchall(self) -> List[tuple]:
        self._check()
        out = self._rows[self._pos:]
        self._pos = len(self._rows)
        return out

    def close(self):
        self._rows = None

    def _check(self):
        if self._rows is None:
            raise ProgrammingError("no result set; call execute() first")

    def __iter__(self):
        self._check()
        while True:
            row = self.fetchone()
            if row is None:
                return
            yield row


def _bind(sql_text: str, parameters: Sequence[Any]) -> str:
    """qmark substitution; a '?' inside a string literal stays."""
    out = []
    pi = 0
    in_str = False
    i = 0
    while i < len(sql_text):
        ch = sql_text[i]
        if in_str:
            out.append(ch)
            if ch == "'":
                if i + 1 < len(sql_text) and sql_text[i + 1] == "'":
                    out.append("'")
                    i += 1  # an escaped quote stays in the literal
                else:
                    in_str = False
        elif ch == "'":
            in_str = True
            out.append(ch)
        elif ch == "?":
            if pi >= len(parameters):
                raise ProgrammingError(
                    f"more placeholders than parameters ({len(parameters)})")
            out.append(_quote(parameters[pi]))
            pi += 1
        else:
            out.append(ch)
        i += 1
    if pi != len(parameters):
        raise ProgrammingError(
            f"{pi} placeholders but {len(parameters)} parameters")
    return "".join(out)


def _quote(v: Any) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, (int, float)):
        return repr(v)
    s = str(v).replace("'", "''")
    return f"'{s}'"


# -- the statement protocol ------------------------------------------------


def _parse_wire_value(v, type_sig: str):
    """A wire value -> Python (decimals as Decimal, dates and timestamps
    as datetime objects, as the reference's clients read them)."""
    if v is None:
        return None
    base = type_sig.split("(", 1)[0].strip()
    if base == "decimal":
        return decimal.Decimal(v)
    if base == "date":
        return datetime.date.fromisoformat(v)
    if base == "timestamp":
        return datetime.datetime.fromisoformat(v)
    if base == "array":
        inner = type_sig.split("(", 1)[1].rsplit(")", 1)[0]
        return [_parse_wire_value(e, inner) for e in v]
    return v


class HttpConnection:
    """A PEP 249 connection over the client statement protocol."""

    def __init__(self, server: str, user: str = "presto",
                 session: Optional[dict] = None, **kwargs):
        self.server = server.rstrip("/")
        self.user = user
        self.session = dict(session or {})
        self._txn_id: Optional[str] = None
        self._closed = False

    def cursor(self) -> "HttpCursor":
        if self._closed:
            raise ProgrammingError("connection is closed")
        return HttpCursor(self)

    def _run(self, text: str):
        from .client import QueryError, execute
        try:
            client = execute(self.server, text, user=self.user,
                             session=self.session,
                             transaction_id=self._txn_id)
        except QueryError as e:
            raise ProgrammingError(str(e)) from e
        # the server's session and transaction changes
        self.session.update(client.set_session)
        if client.started_transaction_id:
            self._txn_id = client.started_transaction_id
        if client.clear_transaction:
            self._txn_id = None
        return client

    def _ensure_txn(self):
        if self._txn_id is None:
            self._run("START TRANSACTION")

    def commit(self):
        if self._closed:
            raise ProgrammingError("connection is closed")
        if self._txn_id is not None:
            self._run("COMMIT")

    def rollback(self):
        if self._closed:
            raise ProgrammingError("connection is closed")
        if self._txn_id is not None:
            self._run("ROLLBACK")

    def close(self):
        if self._txn_id is not None:
            try:
                self._run("ROLLBACK")
            except (ProgrammingError, OSError):
                pass  # closing is as far as the server can be reached
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class HttpCursor(Cursor):
    """A cursor whose execute() goes over the wire."""

    def execute(self, sql_text: str, parameters: Sequence[Any] = ()):
        if self.conn._closed:
            raise ProgrammingError("connection is closed")
        if parameters:
            sql_text = _bind(sql_text, parameters)
        self.conn._ensure_txn()
        client = self.conn._run(sql_text)
        cols = client.columns or []
        self.description = [(c["name"], c["type"], None, None, None,
                             None, None) for c in cols]
        types = [c["type"] for c in cols]
        self._rows = [tuple(_parse_wire_value(v, types[i])
                            for i, v in enumerate(row))
                      for row in client.data]
        self._pos = 0
        self.rowcount = len(self._rows)
        return self
