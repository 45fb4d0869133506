"""Connector catalog: the data sources a TableScanNode can name.

Each connector module exposes `SCHEMA` (table -> columns and types),
`table_row_count`, `generate_columns` and `column_type`.
"""

from __future__ import annotations

__all__ = ["catalog", "catalogs", "schema_of"]

_CATALOGS = None


def _load() -> dict:
    from . import (information_schema, localfile, memory, system, tpcds,
                   tpch)
    cats = {"tpch": tpch, "tpcds": tpcds, "memory": memory,
            "system": system, "information_schema": information_schema,
            "localfile": localfile}
    try:
        import pyarrow  # noqa: F401  (the file connectors import it lazily)
    except ImportError:
        return cats  # without pyarrow there are no parquet or orc catalogs
    from . import orc, parquet
    cats["parquet"] = parquet
    cats["orc"] = orc
    return cats


def catalogs() -> dict:
    """Catalog name -> connector module: tpch, tpcds, memory, system,
    information_schema and localfile, and parquet and orc where pyarrow
    imports, as in the reference."""
    global _CATALOGS
    if _CATALOGS is None:
        _CATALOGS = _load()
    return _CATALOGS


def catalog(name: str):
    """The connector module registered under `name` (KeyError if none)."""
    try:
        return catalogs()[name]
    except KeyError:
        raise KeyError(f"unknown connector/catalog {name!r}") from None


def schema_of(name: str):
    """The `SCHEMA` of the catalog registered under `name`."""
    return catalog(name).SCHEMA
