"""Writable in-memory connector: the presto-memory analog.

Counterpart of presto_tpu/connectors/memory.py, with a store of its
own. Tables are numpy column vectors and null masks on the host; a scan
stages them on the device like the generated tables, through the same
staging path (exec/runner.py::stage_scan_split, which reads
`generate_nulls`), so dynamic filtering, split streaming and the
narrow-width annotation (`column_range`) treat a written table as they
treat tpch or tpcds.

Write protocol (the TableWriter/TableFinish contract):
    h = begin_insert(table[, create_columns=...])   # per query
    append(h, columns, nulls)                       # per chunk
    finish_insert(h) -> rows                        # atomic publish
    abort_insert(h)                                 # rollback
Appends stage into the handle and stay invisible to readers until
finish_insert.
"""

from __future__ import annotations

import threading
import uuid
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import types as T
from ..block import batch_from_numpy

__all__ = ["SCHEMA", "create_table", "drop_table", "reset",
           "table_row_count", "generate_columns", "generate_nulls",
           "generate_batch", "column_type", "column_range",
           "begin_insert", "append", "finish_insert", "abort_insert",
           "replace_table", "write_lock", "table_version", "table_names",
           "data_version"]


class _Table:
    def __init__(self, columns: List[str], types: List[T.Type]):
        self.columns = list(columns)
        self.types = list(types)
        # one array and null mask per column: object arrays for strings,
        # long decimals and nested values, the type's dtype otherwise
        self.values: List[np.ndarray] = [
            np.array([], dtype=_storage_dtype(t)) for t in types]
        self.nulls: List[np.ndarray] = [
            np.array([], dtype=bool) for _ in types]

    @property
    def row_count(self) -> int:
        return len(self.values[0]) if self.values else 0


def _storage_dtype(ty: T.Type):
    if ty.is_string or ty.base in ("array", "map", "row") or \
            (ty.is_decimal and not ty.is_short_decimal):
        return object
    return ty.to_dtype()


_lock = threading.RLock()
_tables: Dict[str, _Table] = {}
_pending: Dict[str, dict] = {}  # handle -> staged chunks
_versions: Dict[str, int] = {}  # table -> mutation counter
_write_locks: Dict[str, threading.Lock] = {}


def table_version(name: str) -> int:
    """Monotonic per-table mutation counter."""
    with _lock:
        return _versions.get(name, 0)


def _bump_version(name: str) -> None:
    _versions[name] = _versions.get(name, 0) + 1


class _Schema(dict):
    """Live view of the store: table -> {column: Type}."""

    def __getitem__(self, table):
        with _lock:
            t = _tables[table]
            return {c: ty for c, ty in zip(t.columns, t.types)}

    def __contains__(self, table):
        with _lock:
            return table in _tables

    def __iter__(self):
        with _lock:
            return iter(list(_tables))

    def __len__(self):
        with _lock:
            return len(_tables)

    def keys(self):
        with _lock:
            return list(_tables)

    def items(self):
        return [(t, self[t]) for t in self.keys()]

    def values(self):
        return [self[t] for t in self.keys()]


SCHEMA = _Schema()


def table_names() -> List[str]:
    with _lock:
        return sorted(_tables)


def reset() -> None:
    """Drop every table and staged insert."""
    with _lock:
        _tables.clear()
        _pending.clear()


def create_table(name: str, columns: Sequence[str],
                 types: Sequence[T.Type],
                 if_not_exists: bool = False) -> None:
    with _lock:
        if name in _tables:
            if if_not_exists:
                return
            raise ValueError(f"memory table {name!r} already exists")
        _tables[name] = _Table(list(columns), list(types))
        _bump_version(name)


def drop_table(name: str, if_exists: bool = False) -> None:
    with _lock:
        if name not in _tables and not if_exists:
            raise KeyError(f"no memory table {name!r}")
        _tables.pop(name, None)
        _bump_version(name)


def column_type(table: str, column: str) -> T.Type:
    with _lock:
        t = _tables[table]
        return t.types[t.columns.index(column)]


def table_row_count(table: str, sf: float = 0.0) -> int:
    with _lock:
        return _tables[table].row_count


def generate_columns(table: str, sf: float, columns: Sequence[str],
                     start: int = 0, count: Optional[int] = None
                     ) -> Dict[str, np.ndarray]:
    """Rows [start, start + count) of the stored columns (sf is
    ignored: a stored table has one size)."""
    with _lock:
        t = _tables[table]
        count = t.row_count - start if count is None else count
        return {c: t.values[t.columns.index(c)][start:start + count].copy()
                for c in columns}


def generate_nulls(table: str, columns: Sequence[str], start: int = 0,
                   count: Optional[int] = None) -> Dict[str, np.ndarray]:
    with _lock:
        t = _tables[table]
        count = t.row_count - start if count is None else count
        return {c: t.nulls[t.columns.index(c)][start:start + count].copy()
                for c in columns}


def column_range(table: str, column: str, sf: float = 0.0):
    """Exact (lo, hi) over the stored non-NULL values of an integer
    column, for the narrow-width annotation; None for an empty,
    all-NULL or non-integer column. The staging-time guard
    (plan/widths.checked_physical_dtypes) covers a write between
    planning and staging."""
    with _lock:
        t = _tables.get(table)
        if t is None:
            raise KeyError(f"no memory table {table!r}")
        i = t.columns.index(column)
        vals, nulls = t.values[i], t.nulls[i]
    if vals.dtype == object or vals.dtype.kind not in "iu":
        return None
    live = vals[~nulls]
    if not len(live):
        return None
    return (int(live.min()), int(live.max()))


def generate_batch(table: str, sf: float, columns: Sequence[str],
                   start: int = 0, count: Optional[int] = None,
                   capacity: Optional[int] = None, device=None):
    """The stored rows staged as one Batch on `device` (None: CUDA)."""
    with _lock:
        t = _tables[table]
        count = t.row_count - start if count is None else count
        idx = [t.columns.index(c) for c in columns]
        vals = [t.values[i][start:start + count] for i in idx]
        nulls = [t.nulls[i][start:start + count] for i in idx]
        types = [t.types[i] for i in idx]
    return batch_from_numpy(types, vals, nulls=nulls,
                            capacity=capacity or max(count, 1),
                            device=device)


# -- write protocol ---------------------------------------------------------

def begin_insert(table: str,
                 create_columns: Optional[Sequence[str]] = None,
                 create_types: Optional[Sequence[T.Type]] = None) -> str:
    """Start a staged insert; with create_columns/types this is CTAS:
    the empty table is created now, so that two CTAS of one name
    conflict early, and dropped again on abort."""
    with _lock:
        created = False
        if create_columns is not None:
            create_table(table, create_columns, create_types)
            created = True
        if table not in _tables:
            raise KeyError(f"no memory table {table!r}")
        h = f"ins_{uuid.uuid4().hex[:12]}"
        t = _tables[table]
        _pending[h] = {"table": table, "created": created,
                       "values": [[] for _ in t.columns],
                       "nulls": [[] for _ in t.columns]}
        return h


def append(handle: str, columns: Sequence[np.ndarray],
           nulls: Optional[Sequence[np.ndarray]] = None) -> int:
    """Stage one chunk of rows; returns the rows staged."""
    with _lock:
        st = _pending[handle]
        t = _tables[st["table"]]
        if len(columns) != len(t.columns):
            raise ValueError(
                f"insert arity {len(columns)} != table arity "
                f"{len(t.columns)}")
        n = len(columns[0]) if len(columns) else 0
        for i, col in enumerate(columns):
            st["values"][i].append(np.asarray(col))
            st["nulls"][i].append(
                np.asarray(nulls[i], dtype=bool) if nulls is not None
                else np.zeros(n, dtype=bool))
        return n


def finish_insert(handle: str) -> int:
    """Publish every staged chunk at once; returns the rows written."""
    with _lock:
        table = _pending[handle]["table"]
    with write_lock(table), _lock:
        st = _pending.pop(handle)
        t = _tables[st["table"]]
        for i in range(len(t.columns)):
            chunks = st["values"][i]
            if not chunks:
                continue
            add = np.concatenate([np.asarray(c, dtype=t.values[i].dtype)
                                  for c in chunks]) \
                if t.values[i].dtype != object else \
                np.concatenate([_to_object(c) for c in chunks])
            t.values[i] = np.concatenate([t.values[i], add])
            t.nulls[i] = np.concatenate(
                [t.nulls[i], np.concatenate(st["nulls"][i])])
        rows = sum(len(c) for c in st["values"][0]) if t.columns else 0
        _bump_version(st["table"])
        return rows


def _to_object(arr) -> np.ndarray:
    out = np.empty(len(arr), dtype=object)
    for i, v in enumerate(arr):
        out[i] = v
    return out


def abort_insert(handle: str) -> None:
    """Drop a staged insert; a CTAS's table goes with it."""
    with _lock:
        st = _pending.pop(handle, None)
        if st is not None and st["created"]:
            _tables.pop(st["table"], None)


def data_version(table: str) -> int:
    """The fragment result cache's key part: the table's mutation
    counter."""
    return table_version(table)


def replace_table(name: str, columns: Sequence[np.ndarray],
                  nulls: Sequence[np.ndarray]) -> int:
    """Swap a table's contents at once (the DELETE/UPDATE sink);
    returns the old row count."""
    with _lock:
        t = _tables[name]
        if len(columns) != len(t.columns):
            raise ValueError(
                f"rewrite arity {len(columns)} != table arity "
                f"{len(t.columns)}")
        old = t.row_count
        for i in range(len(t.columns)):
            if t.values[i].dtype == object:
                t.values[i] = _to_object(columns[i])
            else:
                t.values[i] = np.asarray(columns[i],
                                         dtype=t.values[i].dtype)
            t.nulls[i] = np.asarray(nulls[i], dtype=bool)
        _bump_version(name)
        return old


def write_lock(name: str) -> threading.Lock:
    """Per-table writer mutex: DELETE and UPDATE hold it across their
    read-compute-swap, so that an insert committed meanwhile cannot be
    lost under the swap; inserts take it around their publish."""
    with _lock:
        lk = _write_locks.get(name)
        if lk is None:
            lk = _write_locks[name] = threading.Lock()
        return lk
