"""Local-file connector: CSV and JSON-lines files as tables.

Counterpart of presto_tpu/connectors/localfile.py (presto-local-file
with presto-record-decoder's CSV and JSON row decoders). Rows decode on
the host into the same columns every connector produces, and a scan
stages them on the device through the runner's staging path.

    register_table("events", "/data/events.csv",
                   schema={"ts": T.TIMESTAMP, "user": T.varchar(64),
                           "n": T.BIGINT})
    sql("SELECT user, count(*) FROM localfile.events GROUP BY user")

CSV: a header row names the columns (the schema is optional; unknown
columns are varchar); empty fields are NULL. JSONL: one JSON object a
line; missing keys and undecodable lines are NULL. Declared types drive
decoding: dates to day numbers, timestamps to UTC microseconds,
decimals to scaled integers. A cell that does not decode is NULL.
"""

from __future__ import annotations

import csv
import datetime
import json
import os
import threading
from decimal import Decimal
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import types as T
from ..block import batch_from_numpy
from .registry import RegistrySchema

__all__ = ["SCHEMA", "register_table", "unregister_table", "reset",
           "table_row_count", "generate_columns", "generate_nulls",
           "generate_batch", "column_type", "data_version"]

_lock = threading.RLock()
_tables: Dict[str, dict] = {}
SCHEMA = RegistrySchema(_tables, _lock)


def _decode_cell(raw, ty: T.Type):
    """One decoded cell -> the engine's value (None = NULL)."""
    if raw is None or raw == "":
        return None
    try:
        if ty.is_string:
            return str(raw)
        if ty.base == "boolean":
            if isinstance(raw, bool):
                return raw
            return str(raw).strip().lower() in ("true", "1", "t", "yes")
        if ty.is_integral:
            return int(raw)
        if ty.is_floating:
            return float(raw)
        if ty.is_decimal:
            return int(Decimal(str(raw)).scaleb(ty.scale))
        if ty.base == "date":
            return (datetime.date.fromisoformat(str(raw))
                    - datetime.date(1970, 1, 1)).days
        if ty.base == "timestamp":
            d = datetime.datetime.fromisoformat(str(raw))
            if d.tzinfo is None:
                # a bare wall clock is a UTC instant (the session zone)
                d = d.replace(tzinfo=datetime.timezone.utc)
            # an explicit offset converts the instant
            return int(d.timestamp() * 1_000_000)
    except (ValueError, ArithmeticError):
        return None
    return None


def _load_rows(path: str, fmt: str) -> List[dict]:
    rows: List[dict] = []
    if fmt == "csv":
        with open(path, newline="") as f:
            rows.extend(csv.DictReader(f))
    elif fmt == "jsonl":
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        rows.append(json.loads(line))
                    except json.JSONDecodeError:
                        rows.append({})  # a dirty line is an all-NULL row
    else:
        raise ValueError(f"unknown local-file format {fmt!r}")
    return rows


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _infer_type(vals: list) -> T.Type:
    """A column's type from its non-empty cells: BOOLEAN if all are
    JSON bools; BIGINT or DOUBLE if all are numeric (bools count as 0
    and 1; any float makes it DOUBLE) or all parse as such; else
    varchar at the longest cell, so that no value silently decodes to
    NULL."""
    ty = T.varchar(max((len(str(v)) for v in vals), default=1))
    if not vals:
        return ty
    if all(isinstance(v, bool) for v in vals):
        return T.BOOLEAN
    if all(_is_num(v) or isinstance(v, bool) for v in vals):
        return T.DOUBLE if any(isinstance(v, float) for v in vals) \
            else T.BIGINT
    try:
        [int(v) for v in vals if not isinstance(v, bool)]
        if any(isinstance(v, float) for v in vals):
            raise ValueError
        return T.BIGINT
    except (ValueError, TypeError):
        try:
            [float(v) for v in vals]
            return T.DOUBLE
        except (ValueError, TypeError):
            return ty


def register_table(name: str, path: str, fmt: Optional[str] = None,
                   schema: Optional[Dict[str, T.Type]] = None
                   ) -> Dict[str, T.Type]:
    """Decode the file at `path` (CSV, or JSONL by its extension unless
    `fmt` says) as table `name`; returns its schema, inferred where
    `schema` is None."""
    if fmt is None:
        fmt = "jsonl" if path.endswith((".jsonl", ".ndjson", ".json")) \
            else "csv"
    rows = _load_rows(path, fmt)
    if schema is None:
        cols: List[str] = []
        for r in rows:
            for k in r:
                if k not in cols:
                    cols.append(k)
        schema = {c: _infer_type([r.get(c) for r in rows
                                  if r.get(c) not in (None, "")])
                  for c in cols}
    decoded = {c: [_decode_cell(r.get(c), ty) for r in rows]
               for c, ty in schema.items()}
    with _lock:
        _tables[name] = {"path": path, "fmt": fmt, "schema": dict(schema),
                         "decoded": decoded, "rows": len(rows),
                         "mtime": os.path.getmtime(path)}
    return dict(schema)


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
        return _tables[table]["rows"]


def data_version(table: str) -> float:
    with _lock:
        return _tables[table]["mtime"]


def _slice(table: str, columns: Sequence[str], start: int, count: int):
    with _lock:
        ent = _tables[table]
    out_vals, out_nulls = {}, {}
    for c in columns:
        ty = ent["schema"][c]
        cells = ent["decoded"][c][start:start + count]
        nulls = np.array([v is None for v in cells], dtype=bool)
        if ty.is_string:
            vals = np.array([("" if v is None else v) for v in cells],
                            dtype=object)
        else:
            vals = np.array([(0 if v is None else v) for v in cells],
                            dtype=ty.to_dtype())
        out_vals[c], out_nulls[c] = vals, nulls
    return out_vals, out_nulls


def generate_columns(table: str, sf: float, columns: Sequence[str],
                     start: int = 0, count: Optional[int] = None
                     ) -> Dict[str, np.ndarray]:
    count = table_row_count(table) - start if count is None else count
    return _slice(table, columns, start, count)[0]


def generate_nulls(table: str, columns: Sequence[str], start: int = 0,
                   count: Optional[int] = None) -> Dict[str, np.ndarray]:
    count = table_row_count(table) - start if count is None else count
    return _slice(table, columns, start, count)[1]


def generate_batch(table: str, sf: float, columns: Sequence[str],
                   start: int = 0, count: Optional[int] = None,
                   capacity: Optional[int] = None, device=None):
    """Rows [start, start + count) staged as one Batch on `device`
    (None: CUDA)."""
    count = table_row_count(table) - start if count is None else count
    vals, nulls = _slice(table, columns, start, count)
    types = [column_type(table, c) for c in columns]
    n = len(vals[columns[0]]) if columns else 0
    return batch_from_numpy(types, [vals[c] for c in columns],
                            nulls=[nulls[c] for c in columns],
                            capacity=capacity or max(n, 1), device=device)
