"""The lake connectors' shared writer sink (ConnectorPageSink).

Counterpart of presto_tpu/connectors/lake_sink.py: one staged-insert
state machine (create and drop, begin_insert, append, finish_insert,
abort_insert, replace_table, the warehouse directory) bound to a
format's primitives (write_table, register_table, row counts, full
reads). The parquet and ORC connectors each bind one `LakeSink`, so
their commit semantics are one: a staged file atomically
`os.replace`d over the table's file, then the table registered again,
which advances its data_version. The runner's write roots
(exec/runner.py::_run_write_root) drive it as they drive the memory
connector.
"""

from __future__ import annotations

import os
import tempfile
import threading
import uuid
from typing import Callable, Dict, Optional, Sequence

import numpy as np

__all__ = ["LakeSink"]


def _concat(chunks) -> np.ndarray:
    """One column's chunks end to end: at their dtype where the
    non-empty chunks share one, else as Python objects."""
    chunks = [np.asarray(x) for x in chunks if len(x)]
    if not chunks:
        return np.array([], dtype=object)
    if len({x.dtype for x in chunks}) == 1:
        return np.concatenate(chunks)
    return np.concatenate([x.astype(object) for x in chunks])


class LakeSink:
    def __init__(self, kind: str, extension: str,
                 tables: Dict[str, dict], lock,
                 write_table: Callable,
                 register_table: Callable,
                 table_row_count: Callable,
                 read_all: Callable):
        """`read_all(table, columns)` -> {col: (values, nulls)} over the
        whole table (the existing rows merged into a commit)."""
        self.kind = kind
        self.extension = extension
        self._tables = tables
        self._lock = lock
        self._write_table = write_table
        self._register_table = register_table
        self._table_row_count = table_row_count
        self._read_all = read_all
        self._warehouse: Optional[str] = None
        self._write_locks: Dict[str, threading.Lock] = {}
        self._pending: Dict[str, dict] = {}

    # -- warehouse ---------------------------------------------------------

    def warehouse_dir(self) -> str:
        """Where created tables' files go: the directory set by
        `set_warehouse`, else one under the temporary directory."""
        d = self._warehouse or os.path.join(tempfile.gettempdir(),
                                            "presto_tpu_warehouse")
        os.makedirs(d, exist_ok=True)
        return d

    def set_warehouse(self, path: Optional[str]) -> None:
        self._warehouse = path

    def write_lock(self, table: str):
        with self._lock:
            return self._write_locks.setdefault(table, threading.Lock())

    # -- DDL ---------------------------------------------------------------

    def create_table(self, name: str, columns: Sequence[str], types,
                     if_not_exists: bool = False) -> None:
        with self._lock:
            if name in self._tables:
                if if_not_exists:
                    return
                raise KeyError(f"{self.kind} table {name!r} already exists")
        path = os.path.join(self.warehouse_dir(), f"{name}{self.extension}")
        self._write_table(path,
                          {c: np.array([], dtype=object) for c in columns},
                          dict(zip(columns, types)))
        self._register_table(name, path)

    def drop_table(self, name: str, if_exists: bool = False) -> None:
        with self._lock:
            ent = self._tables.pop(name, None)
        if ent is None:
            if if_exists:
                return
            raise KeyError(f"no {self.kind} table {name!r}")
        # only the warehouse's own files are removed; a registered
        # outside file is the user's
        if ent["path"].startswith(self.warehouse_dir()):
            try:
                os.remove(ent["path"])
            except OSError:
                pass

    # -- staged insert -----------------------------------------------------

    def begin_insert(self, table: str,
                     create_columns: Optional[Sequence[str]] = None,
                     create_types=None) -> str:
        created = False
        if create_columns is not None:
            self.create_table(table, create_columns, create_types)
            created = True
        with self._lock:
            if table not in self._tables:
                raise KeyError(f"no {self.kind} table {table!r}")
            schema = self._tables[table]["schema"]
        h = f"{self.kind}_ins_{uuid.uuid4().hex[:12]}"
        self._pending[h] = {"table": table, "created": created,
                            "columns": list(schema),
                            "values": [[] for _ in schema],
                            "nulls": [[] for _ in schema]}
        return h

    def append(self, handle: str, columns, nulls=None) -> int:
        st = self._pending[handle]
        if len(columns) != len(st["columns"]):
            raise ValueError(f"insert arity {len(columns)} != table arity "
                             f"{len(st['columns'])}")
        n = len(columns[0]) if len(columns) else 0
        for i, col in enumerate(columns):
            st["values"][i].append(np.asarray(col))
            st["nulls"][i].append(np.asarray(nulls[i], dtype=bool)
                                  if nulls is not None
                                  else np.zeros(n, dtype=bool))
        return n

    def _commit(self, table: str, merged: Dict, merged_nulls: Dict,
                schema: Dict, path: str) -> None:
        """Write the new contents beside the file, swap it in, and
        register the table again."""
        tmp = path + ".staged"
        self._write_table(tmp, merged, schema, nulls=merged_nulls)
        os.replace(tmp, path)
        self._register_table(table, path)

    def finish_insert(self, handle: str) -> int:
        """Commit: the existing rows and the staged ones become a new
        file; returns the rows inserted."""
        st = self._pending.pop(handle)
        table = st["table"]
        with self.write_lock(table):
            with self._lock:
                path = self._tables[table]["path"]
                schema = dict(self._tables[table]["schema"])
            cols = list(schema)
            old = self._read_all(table, cols) \
                if self._table_row_count(table) else \
                {c: (np.array([], dtype=object), np.array([], dtype=bool))
                 for c in cols}
            merged, merged_nulls = {}, {}
            for i, c in enumerate(cols):
                merged[c] = _concat([old[c][0]] + st["values"][i])
                merged_nulls[c] = np.concatenate(
                    [np.asarray(x, dtype=bool)
                     for x in [old[c][1]] + st["nulls"][i]])
            self._commit(table, merged, merged_nulls, schema, path)
        return sum(len(x) for x in st["values"][0]) if st["values"] else 0

    def abort_insert(self, handle: str) -> None:
        st = self._pending.pop(handle, None)
        if st and st["created"]:
            self.drop_table(st["table"], if_exists=True)

    def replace_table(self, table: str, columns, nulls) -> None:
        """DELETE and UPDATE: the rewritten contents become the file."""
        with self._lock:
            path = self._tables[table]["path"]
            schema = dict(self._tables[table]["schema"])
        cols = list(schema)
        self._commit(table,
                     {c: np.asarray(v) for c, v in zip(cols, columns)},
                     {c: np.asarray(n, dtype=bool)
                      for c, n in zip(cols, nulls)}, schema, path)
