"""Parquet connector: files through the connector seam.

Counterpart of presto_tpu/connectors/parquet.py (presto-parquet's
reader and writer behind presto-hive's page-source path). Files decode
through pyarrow, imported only when a table is registered, read or
written; a scan stages the decoded columns on the device like any
other connector's, so the whole engine runs unchanged over files.

Pushdown:
  * column pruning: only the requested columns are read;
  * row-group pruning: a scan with a `predicate` (column, lo, hi)
    skips the row groups whose min/max statistics cannot match
    (`row_groups_matching`; plan/pushdown.py sets the scan's range).
    The Filter above the scan still runs, exactly.

Tables register explicitly (`register_table(name, path)`); the engine
types come from the parquet schema (decimals as scaled integers, date32
as day numbers, strings as varchar). `read_stats` counts the row groups
read out of the total, `decode_stats` the seconds and engine bytes of
the decode (the reference feeds both to its data-path ledger, ROADMAP
queue 1 item 15). CTAS, INSERT, DELETE and UPDATE write through the
shared LakeSink (lake_sink.py).
"""

from __future__ import annotations

import datetime
import decimal
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import types as T
from ..block import batch_from_numpy
from .lake_sink import LakeSink
from .registry import RegistrySchema

__all__ = ["SCHEMA", "register_table", "unregister_table", "reset",
           "table_row_count", "generate_columns", "generate_nulls",
           "generate_batch", "column_type", "write_table",
           "row_groups_matching", "engine_to_arrow", "read_stats",
           "decode_stats", "data_version"]


def _pa():
    """pyarrow with its parquet module, imported at first use."""
    import pyarrow
    import pyarrow.parquet  # noqa: F401
    return pyarrow


_lock = threading.RLock()
_tables: Dict[str, dict] = {}  # name -> {path, pf, schema, mtime}
SCHEMA = RegistrySchema(_tables, _lock)

# row groups read out of the total, over every read since the last reset
read_stats = {"groups_total": 0, "groups_read": 0}
# the decode's host seconds and the engine bytes it produced
decode_stats = {"seconds": 0.0, "bytes": 0}


def _engine_type(field) -> T.Type:
    pa = _pa()
    t = field.type
    if pa.types.is_boolean(t):
        return T.BOOLEAN
    if pa.types.is_int8(t):
        return T.TINYINT
    if pa.types.is_int16(t):
        return T.SMALLINT
    if pa.types.is_int32(t):
        return T.INTEGER
    if pa.types.is_integer(t):
        return T.BIGINT
    if pa.types.is_float32(t):
        return T.REAL
    if pa.types.is_floating(t):
        return T.DOUBLE
    if pa.types.is_decimal(t):
        return T.decimal(t.precision, t.scale)
    if pa.types.is_date(t):
        return T.DATE
    if pa.types.is_timestamp(t):
        return T.TIMESTAMP
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return T.varchar(1 << 19)  # staged at its longest value
    raise NotImplementedError(f"parquet type {t} for {field.name}")


def register_table(name: str, path: str) -> Dict[str, T.Type]:
    pq = _pa().parquet
    pf = pq.ParquetFile(path)
    schema = {f.name: _engine_type(f) for f in pf.schema_arrow}
    with _lock:
        # the version is taken with the handle: the data this handle
        # serves until the table registers again
        _tables[name] = {"path": path, "pf": pf, "schema": schema,
                         "mtime": os.path.getmtime(path)}
    return schema


def unregister_table(name: str) -> None:
    with _lock:
        _tables.pop(name, None)


def reset() -> None:
    with _lock:
        _tables.clear()


def column_type(table: str, column: str) -> T.Type:
    with _lock:
        return _tables[table]["schema"][column]


def table_row_count(table: str, sf: float = 0.0) -> int:
    with _lock:
        return _tables[table]["pf"].metadata.num_rows


def data_version(table: str) -> float:
    """The file's mtime when the table was last registered."""
    with _lock:
        return _tables[table]["mtime"]


def _engine_repr(v):
    """A parquet statistic -> the engine's lane value (dates as epoch
    days, timestamps as microseconds, decimals as scaled integers)."""
    if isinstance(v, datetime.datetime):
        return int(v.replace(tzinfo=datetime.timezone.utc)
                   .timestamp() * 1_000_000)
    if isinstance(v, datetime.date):
        return (v - datetime.date(1970, 1, 1)).days
    if isinstance(v, decimal.Decimal):
        return int(v.scaleb(-v.as_tuple().exponent))
    return v


def row_groups_matching(table: str,
                        predicate: Optional[Tuple[str, object, object]]
                        ) -> List[int]:
    """The row groups whose min/max statistics can satisfy
    `(column, lo, hi)` (a None bound is unbounded)."""
    with _lock:
        md = _tables[table]["pf"].metadata
        schema = _tables[table]["pf"].schema_arrow
    if predicate is None:
        return list(range(md.num_row_groups))
    col, lo, hi = predicate
    ci = schema.get_field_index(col)
    out = []
    for g in range(md.num_row_groups):
        st = md.row_group(g).column(ci).statistics
        if st is None or not st.has_min_max:
            out.append(g)
            continue
        smax = _engine_repr(st.max) if st.max is not None else None
        smin = _engine_repr(st.min) if st.min is not None else None
        if lo is not None and smax is not None and smax < lo:
            continue
        if hi is not None and smin is not None and smin > hi:
            continue
        out.append(g)
    return out


def _column_to_engine(arr, ty: T.Type) -> Tuple[np.ndarray, np.ndarray]:
    """A pyarrow array -> (engine values, NULL mask)."""
    pa = _pa()
    import pyarrow.compute as pc
    nulls = np.asarray(arr.is_null().to_numpy(zero_copy_only=False))
    if ty.is_decimal:
        if ty.is_short_decimal and pa.types.is_decimal128(arr.type) and \
                arr.type.scale == ty.scale:
            # a decimal128 is a 16-byte two's-complement integer; at
            # p <= 18 the little-endian low word is the value
            data = np.frombuffer(arr.buffers()[1], dtype=np.int64)
            vals = data[0::2][arr.offset:arr.offset + len(arr)].copy()
            return np.where(nulls, 0, vals), nulls
        # long decimals decode exactly through Python ints
        vals = np.array([0 if v is None else int(v.scaleb(ty.scale))
                         for v in arr.to_pylist()], dtype=object)
        if ty.is_short_decimal:
            vals = vals.astype(np.int64)
        return vals, nulls
    if ty.base == "date":
        days = pc.cast(arr, pa.int32()).to_numpy(zero_copy_only=False)
        return np.where(nulls, 0, days).astype(np.int32), nulls
    if ty.base == "timestamp":
        us = pc.cast(pc.cast(arr, pa.timestamp("us")),
                     pa.int64()).to_numpy(zero_copy_only=False)
        return np.where(nulls, 0, us).astype(np.int64), nulls
    if ty.is_string:
        vals = arr.fill_null("").to_numpy(zero_copy_only=False)
        return vals.astype(object), nulls
    np_vals = arr.to_numpy(zero_copy_only=False)
    fill = ty.to_dtype().type(0)
    return np.where(nulls, fill, np_vals).astype(ty.to_dtype()), nulls


def _record_decode(cols: Dict[str, Tuple[np.ndarray, np.ndarray]],
                   seconds: float) -> None:
    """Add one decode's seconds and engine bytes to `decode_stats`
    (shared with the ORC reader)."""
    decode_stats["seconds"] += seconds
    decode_stats["bytes"] += sum(v.nbytes + n.nbytes
                                 for v, n in cols.values())


def _empty(columns: Sequence[str]):
    return {c: (np.array([]), np.array([], dtype=bool)) for c in columns}


def _read(table: str, columns: Sequence[str], start: int, count: int,
          predicate=None):
    """Rows [start, start + count) of the requested columns, decoding
    only the row groups that the range and the predicate touch."""
    t0 = time.perf_counter()
    with _lock:
        pf = _tables[table]["pf"]
        schema = _tables[table]["schema"]
    groups = set(row_groups_matching(table, predicate))
    md = pf.metadata
    read_stats["groups_total"] += md.num_row_groups
    read_stats["groups_read"] += len(groups)
    pieces = []
    seen = 0
    for g in range(md.num_row_groups):
        g_rows = md.row_group(g).num_rows
        g_lo, g_hi = seen, seen + g_rows
        seen += g_rows
        if g_hi <= start or g_lo >= start + count or g not in groups:
            continue
        t = pf.read_row_group(g, columns=list(columns))
        lo = max(start - g_lo, 0)
        hi = min(start + count - g_lo, g_rows)
        pieces.append(t.slice(lo, hi - lo))
    if not pieces:
        return _empty(columns), schema
    whole = _pa().concat_tables(pieces)
    out = {c: _column_to_engine(whole.column(c).combine_chunks(), schema[c])
           for c in columns}
    _record_decode(out, time.perf_counter() - t0)
    return out, schema


def generate_columns(table: str, sf: float, columns: Sequence[str],
                     start: int = 0, count: Optional[int] = None
                     ) -> Dict[str, np.ndarray]:
    count = table_row_count(table) - start if count is None else count
    data, _ = _read(table, columns, start, count)
    return {c: v for c, (v, _n) in data.items()}


def generate_nulls(table: str, columns: Sequence[str], start: int = 0,
                   count: Optional[int] = None) -> Dict[str, np.ndarray]:
    count = table_row_count(table) - start if count is None else count
    data, _ = _read(table, columns, start, count)
    return {c: n for c, (_v, n) in data.items()}


def generate_batch(table: str, sf: float, columns: Sequence[str],
                   start: int = 0, count: Optional[int] = None,
                   capacity: Optional[int] = None, predicate=None,
                   device=None):
    """Rows [start, start + count) of the row groups that `predicate`
    can match, staged as one Batch on `device` (None: CUDA)."""
    count = table_row_count(table) - start if count is None else count
    data, schema = _read(table, columns, start, count, predicate)
    vals = [data[c][0] for c in columns]
    nulls = [data[c][1] for c in columns]
    n = len(vals[0]) if vals else 0
    return batch_from_numpy([schema[c] for c in columns], vals,
                            capacity=capacity or max(n, 1), nulls=nulls,
                            device=device)


def _short_decimal_array(pa, vals, nl, ty: T.Type):
    """A decimal128 array straight from the scaled integers: each value
    is a 16-byte two's-complement integer, the low word the value and
    the high word its sign."""
    v = np.asarray(vals, dtype=np.int64)
    words = np.empty((len(v), 2), dtype=np.int64)
    words[:, 0] = v
    words[:, 1] = v >> 63
    bufs = [None, pa.py_buffer(words)]
    nulls = 0
    if nl is not None and nl.any():
        bufs[0] = pa.py_buffer(np.packbits(~nl, bitorder="little"))
        nulls = int(nl.sum())
    return pa.Array.from_buffers(pa.decimal128(ty.precision, ty.scale),
                                 len(v), bufs, null_count=nulls)


def engine_to_arrow(columns: Dict[str, np.ndarray],
                    types: Dict[str, T.Type],
                    nulls: Optional[Dict[str, np.ndarray]] = None):
    """Engine columns -> a pyarrow Table (the parquet and ORC sinks).
    Columns convert as whole arrays; long decimals value by value, as
    the reference converts every column."""
    pa = _pa()
    arrays, fields = [], []
    for name, vals in columns.items():
        ty = types[name]
        nl = None if nulls is None or name not in nulls else \
            np.asarray(nulls[name], dtype=bool)
        mask = nl if nl is not None and nl.any() else None
        if ty.is_decimal and ty.is_short_decimal:
            arr = _short_decimal_array(pa, vals, nl, ty)
        elif ty.is_decimal:
            py = [None if mask is not None and mask[i] else
                  decimal.Decimal(int(v)).scaleb(-ty.scale)
                  for i, v in enumerate(np.asarray(vals, dtype=object))]
            arr = pa.array(py, type=pa.decimal128(ty.precision, ty.scale))
        elif ty.base == "date":
            arr = pa.array(np.asarray(vals, dtype=np.int32),
                           type=pa.date32(), mask=mask)
        elif ty.base == "timestamp":
            arr = pa.array(np.asarray(vals, dtype=np.int64),
                           type=pa.timestamp("us"), mask=mask)
        elif ty.is_string:
            arr = pa.array(np.asarray(vals, dtype=object), type=pa.string(),
                           mask=mask)
        else:
            arr = pa.array(np.asarray(vals, dtype=ty.to_dtype()),
                           type=pa.from_numpy_dtype(ty.to_dtype()),
                           mask=mask)
        arrays.append(arr)
        fields.append(pa.field(name, arr.type))
    return pa.Table.from_arrays(arrays, schema=pa.schema(fields))


def write_table(path: str, columns: Dict[str, np.ndarray],
                types: Dict[str, T.Type],
                nulls: Optional[Dict[str, np.ndarray]] = None,
                row_group_size: Optional[int] = None) -> None:
    """Engine columns -> a parquet file (the sink and fixture writer)."""
    _pa().parquet.write_table(engine_to_arrow(columns, types, nulls), path,
                              row_group_size=row_group_size)


def _read_all(table: str, columns):
    return _read(table, columns, 0, table_row_count(table))[0]


_sink = LakeSink("parquet", ".parquet", _tables, _lock, write_table,
                 register_table, table_row_count, _read_all)
set_warehouse = _sink.set_warehouse
write_lock = _sink.write_lock
create_table = _sink.create_table
drop_table = _sink.drop_table
begin_insert = _sink.begin_insert
append = _sink.append
finish_insert = _sink.finish_insert
abort_insert = _sink.abort_insert
replace_table = _sink.replace_table
