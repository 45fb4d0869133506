"""ORC connector: the lake's other columnar format.

Counterpart of presto_tpu/connectors/orc.py (presto-orc's readers and
writer behind the same page-source seam as parquet). Files decode
through pyarrow's ORC reader, imported at first use, and the connector
serves the parquet connector's surface: explicit registration, engine
types from the file's schema, range reads stripe by stripe, and the
writer sink (CTAS, INSERT, DELETE, UPDATE) through the shared LakeSink.

As in the reference, pyarrow exposes no per-stripe statistics, so an
ORC scan does not prune stripes by predicate (it has no
`row_groups_matching`); range reads and column pruning still apply.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np

from .. import types as T
from ..block import batch_from_numpy
from .lake_sink import LakeSink
from .parquet import (_column_to_engine, _empty, _engine_type, _pa,
                      _record_decode, engine_to_arrow)
from .registry import RegistrySchema

__all__ = ["SCHEMA", "register_table", "unregister_table", "reset",
           "table_row_count", "generate_columns", "generate_nulls",
           "generate_batch", "column_type", "write_table",
           "set_warehouse", "data_version"]

_lock = threading.RLock()
_tables: Dict[str, dict] = {}
SCHEMA = RegistrySchema(_tables, _lock)


def _orc():
    _pa()
    import pyarrow.orc
    return pyarrow.orc


def register_table(name: str, path: str) -> Dict[str, T.Type]:
    f = _orc().ORCFile(path)
    schema = {fld.name: _engine_type(fld) for fld in f.schema}
    with _lock:
        _tables[name] = {"path": path, "f": f, "schema": schema,
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
        return _tables[table]["f"].nrows


def data_version(table: str) -> float:
    with _lock:
        return _tables[table]["mtime"]


def _read(table: str, columns: Sequence[str], start: int, count: int):
    """Rows [start, start + count) of the requested columns, decoding
    stripes only until the range is read (pyarrow gives no stripe row
    counts, so they are counted as the stripes are read)."""
    t0 = time.perf_counter()
    with _lock:
        f = _tables[table]["f"]
        schema = _tables[table]["schema"]
    pa = _pa()
    pieces = []
    seen = 0
    for s in range(f.nstripes):
        if seen >= start + count:
            break
        t = f.read_stripe(s, columns=list(columns))
        g_lo, g_hi = seen, seen + t.num_rows
        seen += t.num_rows
        if g_hi <= start:
            continue
        lo = max(start - g_lo, 0)
        hi = min(start + count - g_lo, t.num_rows)
        pieces.append(pa.table(t).slice(lo, hi - lo))
    if not pieces:
        return _empty(columns), schema
    whole = pa.concat_tables(pieces)
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
                   capacity: Optional[int] = None, device=None):
    """Rows [start, start + count) staged as one Batch on `device`
    (None: CUDA)."""
    count = table_row_count(table) - start if count is None else count
    data, schema = _read(table, columns, start, count)
    vals = [data[c][0] for c in columns]
    nulls = [data[c][1] for c in columns]
    n = len(vals[0]) if vals else 0
    return batch_from_numpy([schema[c] for c in columns], vals,
                            capacity=capacity or max(n, 1), nulls=nulls,
                            device=device)


def write_table(path: str, columns: Dict[str, np.ndarray],
                types: Dict[str, T.Type],
                nulls: Optional[Dict[str, np.ndarray]] = None,
                stripe_size: Optional[int] = None) -> None:
    kw = {"stripe_size": stripe_size} if stripe_size else {}
    _orc().write_table(engine_to_arrow(columns, types, nulls), path, **kw)


def _read_all(table: str, columns):
    return _read(table, columns, 0, table_row_count(table))[0]


_sink = LakeSink("orc", ".orc", _tables, _lock, write_table,
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
