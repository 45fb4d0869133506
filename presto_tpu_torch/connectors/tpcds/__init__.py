"""The TPC-DS connector: the 24 deterministic generated tables."""

from .generator import (TPCDS_SCHEMA, column_type, generate_columns,
                        table_row_count)
from .stats import column_distinct_count

__all__ = ["TPCDS_SCHEMA", "table_row_count", "generate_columns",
           "column_type", "column_distinct_count"]

SCHEMA = TPCDS_SCHEMA  # the registry's uniform name (connectors.catalogs)
__all__ = __all__ + ["SCHEMA"]


def data_version(table: str) -> int:
    """The fragment result cache's key part: generated data is a pure
    function of (table, sf), so the version never changes."""
    return 0


__all__ = __all__ + ["data_version"]
