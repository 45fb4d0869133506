"""TPC-H value-range statistics for narrow-width staging.

The port's own copy of the value-range half of
presto_tpu/connectors/tpch/stats.py. The generator makes every numeric domain exact, so these are true bounds:
a column staged at a lane they prove can never wrap. Decimal ranges
are the scaled integers that are staged.
"""

from __future__ import annotations

from .generator import _EPOCH_1992, _ORDERDATE_RANGE, table_row_count

__all__ = ["column_range"]

# constant numeric domains from generator.py (scaled ints for decimals)
_RANGE_CONST = {
    ("lineitem", "linenumber"): (1, 4),
    ("lineitem", "quantity"): (100, 5000),          # 1..50 x100
    # extendedprice = qty(1..50) * retailprice(90000..389900)
    ("lineitem", "extendedprice"): (90000, 50 * 389900),
    ("lineitem", "discount"): (0, 10),
    ("lineitem", "tax"): (0, 8),
    ("orders", "totalprice"): (85000, 55550000),
    ("orders", "shippriority"): (0, 0),
    ("customer", "nationkey"): (0, 24),
    ("customer", "acctbal"): (-99999, 999999),
    ("part", "size"): (1, 50),
    ("part", "retailprice"): (90000, 389900),
    ("supplier", "nationkey"): (0, 24),
    ("supplier", "acctbal"): (-99999, 999999),
    ("partsupp", "availqty"): (1, 9999),
    ("partsupp", "supplycost"): (100, 100000),
    ("nation", "nationkey"): (0, 24),
    ("nation", "regionkey"): (0, 4),
    ("region", "regionkey"): (0, 4),
}

# 1..row_count(keyed table) key domains
_RANGE_KEYED = {
    ("lineitem", "orderkey"): "orders",
    ("lineitem", "partkey"): "part",
    ("lineitem", "suppkey"): "supplier",
    ("orders", "orderkey"): "orders",
    ("orders", "custkey"): "customer",
    ("customer", "custkey"): "customer",
    ("part", "partkey"): "part",
    ("supplier", "suppkey"): "supplier",
    ("partsupp", "partkey"): "part",
    ("partsupp", "suppkey"): "supplier",
}

# date columns as (lo offset from the orderdate low bound, hi offset
# from its high bound): shipdate = orderdate + 1..121, commitdate +
# 30..90, receiptdate = shipdate + 1..30
_RANGE_DATES = {
    ("lineitem", "shipdate"): (1, 121),
    ("lineitem", "commitdate"): (30, 90),
    ("lineitem", "receiptdate"): (2, 151),
    ("orders", "orderdate"): (0, 0),
}


def column_range(table: str, column: str, sf: float):
    """Exact (lo, hi) value bounds, or None when unknown (strings)."""
    key = (table, column)
    if key in _RANGE_CONST:
        return _RANGE_CONST[key]
    if key in _RANGE_KEYED:
        return (1, max(table_row_count(_RANGE_KEYED[key], sf), 1))
    if key in _RANGE_DATES:
        lo_off, hi_off = _RANGE_DATES[key]
        return (_EPOCH_1992 + lo_off, _EPOCH_1992 + _ORDERDATE_RANGE + hi_off)
    return None
