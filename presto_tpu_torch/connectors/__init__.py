"""Connector catalog: the data sources a TableScanNode can name.

Each connector module exposes `SCHEMA` (table -> columns and types),
`table_row_count`, `generate_columns` and `column_type`.
"""

from __future__ import annotations

__all__ = ["catalog", "catalogs", "schema_of"]

_CATALOGS = None


def catalogs() -> dict:
    """Catalog name -> connector module, for every catalog of the port:
    tpch, tpcds, memory and information_schema. The reference's system
    and file connectors are not ported yet (ROADMAP queue 1 item 12)."""
    global _CATALOGS
    if _CATALOGS is None:
        from . import information_schema, memory, tpcds, tpch
        _CATALOGS = {"tpch": tpch, "tpcds": tpcds, "memory": memory,
                     "information_schema": information_schema}
    return _CATALOGS


def catalog(name: str):
    """The connector module registered under `name` (KeyError if none)."""
    try:
        return catalogs()[name]
    except KeyError:
        raise KeyError(f"no connector {name!r} in this port (ROADMAP queue "
                       "1 item 12: the file connectors and system)") from None


def schema_of(name: str):
    """The `SCHEMA` of the catalog registered under `name`."""
    return catalog(name).SCHEMA
