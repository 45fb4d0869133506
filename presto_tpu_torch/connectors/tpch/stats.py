"""TPC-H statistics: distinct-count upper bounds for the planner's
capacity pass, value ranges for narrow-width staging.

The port's own copy of presto_tpu/connectors/tpch/stats.py. The
generator makes every domain exact, so these are true bounds: a group
table sized from them cannot overflow, and a column staged at a lane
they prove can never wrap. Decimal ranges are the scaled integers that
are staged.
"""

from __future__ import annotations

from typing import Optional

from .generator import _EPOCH_1992, _ORDERDATE_RANGE, table_row_count

__all__ = ["column_distinct_count", "column_range"]

# constant-domain columns: exact vocabulary sizes from generator.py
_CONST = {
    ("lineitem", "linenumber"): 4,           # idx % LINES_PER_ORDER + 1
    ("lineitem", "quantity"): 50,            # uniform 1..50 (x100)
    ("lineitem", "discount"): 11,            # uniform 0..10
    ("lineitem", "tax"): 9,                  # uniform 0..8
    ("lineitem", "returnflag"): 3,           # R/A/N
    ("lineitem", "linestatus"): 2,           # O/F
    ("lineitem", "shipdate"): 2527,          # orderdate span 2406 + 121
    ("lineitem", "commitdate"): 2496,        # + 90
    ("lineitem", "receiptdate"): 2557,       # shipdate + 30
    ("lineitem", "shipinstruct"): 4,
    ("lineitem", "shipmode"): 7,
    ("orders", "orderstatus"): 3,
    ("orders", "orderdate"): 2406,           # uniform 0.._ORDERDATE_RANGE incl.
    ("orders", "orderpriority"): 5,
    ("orders", "shippriority"): 1,
    ("customer", "nationkey"): 25,
    ("customer", "mktsegment"): 5,
    ("part", "mfgr"): 5,
    ("part", "brand"): 25,                   # Brand#MB, M,B in 1..5
    ("part", "size"): 50,
    ("supplier", "nationkey"): 25,
    ("partsupp", "availqty"): 9999,
    ("nation", "nationkey"): 25,
    ("nation", "name"): 25,
    ("nation", "regionkey"): 5,
    ("region", "regionkey"): 5,
    ("region", "name"): 5,
}

# columns whose domain is another table's key space (or this table's)
_KEYED = {
    ("lineitem", "orderkey"): "orders",
    ("lineitem", "partkey"): "part",
    ("lineitem", "suppkey"): "supplier",
    ("orders", "orderkey"): "orders",
    ("orders", "custkey"): "customer",
    ("customer", "custkey"): "customer",
    ("customer", "name"): "customer",
    ("part", "partkey"): "part",
    ("supplier", "suppkey"): "supplier",
    ("supplier", "name"): "supplier",
    ("partsupp", "partkey"): "part",
    ("partsupp", "suppkey"): "supplier",
}


def column_distinct_count(table: str, column: str,
                          sf: float) -> Optional[int]:
    """Distinct-count upper bound, or None when unbounded/unknown
    (comments, prices). `part.type` and `part.container` depend on the
    generator's vocab lists -- resolved lazily to stay in sync."""
    key = (table, column)
    if key in _CONST:
        return _CONST[key]
    if key in _KEYED:
        return table_row_count(_KEYED[key], sf)
    if key == ("part", "type"):
        from .generator import P_TYPES
        return len(P_TYPES)
    if key == ("part", "container"):
        from .generator import _CONTAINERS
        return len(_CONTAINERS)
    if key == ("orders", "clerk"):
        return max(int(1000 * sf), 1)
    return None



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
