"""information_schema connector: the standard metadata catalog.

The port's copy of presto_tpu/connectors/information_schema.py: the
tables `schemata`, `tables` and `columns`, whose rows are read on the
host from the port's connector registry. SHOW TABLES, SHOW COLUMNS and
DESCRIBE rewrite onto them (sql/statements.py)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import types as T

__all__ = ["SCHEMA", "table_row_count", "generate_columns",
           "generate_nulls", "column_type"]

_V = T.varchar(256)
SCHEMA = {
    "schemata": {"catalog_name": _V, "schema_name": _V},
    "tables": {"table_catalog": _V, "table_schema": _V, "table_name": _V,
               "table_type": _V},
    "columns": {"table_catalog": _V, "table_schema": _V, "table_name": _V,
                "column_name": _V, "ordinal_position": T.BIGINT,
                "data_type": _V, "is_nullable": _V},
}


def _schema_dict(cat: str, mod) -> dict:
    sch = getattr(mod, "SCHEMA", None) or {}
    # dict() normalizes both connector schema shapes: tpch/tpcds expose
    # list-of-(name, type) per table, memory/system expose dicts
    return {t: dict(cols) for t, cols in sch.items()}


def _rows_of(table: str) -> List[tuple]:
    from . import catalogs
    cats = sorted(catalogs().items())
    if table == "schemata":
        out = []
        for cat, _ in cats:
            out.append((cat, "default"))
            out.append((cat, "information_schema"))
        return out
    if table == "tables":
        out = []
        for cat, mod in cats:
            for t in sorted(_schema_dict(cat, mod)):
                out.append((cat, "default", t, "BASE TABLE"))
        return out
    if table == "columns":
        out = []
        for cat, mod in cats:
            sch = _schema_dict(cat, mod)
            for t in sorted(sch):
                for pos, (c, ty) in enumerate(sch[t].items(), start=1):
                    out.append((cat, "default", t, c, pos, str(ty), "YES"))
        return out
    raise KeyError(f"no information_schema table {table!r}")


def column_type(table: str, column: str) -> T.Type:
    return SCHEMA[table][column]


def table_row_count(table: str, sf: float = 0.0) -> int:
    return len(_rows_of(table))


def generate_columns(table: str, sf: float, columns: Sequence[str],
                     start: int = 0, count: Optional[int] = None
                     ) -> Dict[str, np.ndarray]:
    rows = _rows_of(table)
    count = len(rows) - start if count is None else count
    rows = rows[start:start + count]
    names = list(SCHEMA[table])
    out = {}
    for c in columns:
        i = names.index(c)
        ty = SCHEMA[table][c]
        vals = [r[i] for r in rows]
        if ty.is_string:
            out[c] = np.array([str(v) for v in vals], dtype=object)
        else:
            out[c] = np.array(vals, dtype=ty.to_dtype())
    return out


def generate_nulls(table: str, columns: Sequence[str], start: int = 0,
                   count: Optional[int] = None) -> Dict[str, np.ndarray]:
    n = table_row_count(table) - start if count is None else count
    return {c: np.zeros(max(n, 0), dtype=bool) for c in columns}
