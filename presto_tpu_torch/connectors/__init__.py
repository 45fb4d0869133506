"""Connector catalog: the data sources a TableScanNode can name."""

from __future__ import annotations

__all__ = ["catalog"]


def catalog(name: str):
    """The connector module registered under `name` (KeyError if none)."""
    if name == "tpch":
        from . import tpch
        return tpch
    if name == "tpcds":
        from . import tpcds
        return tpcds
    if name == "memory":
        from . import memory
        return memory
    raise KeyError(f"no connector {name!r} in this port (ROADMAP queue 1 "
                   "item 12: the file connectors, system and "
                   "information_schema)")
