"""Scan predicate pushdown: a Filter's ranges prune connector row groups.

Counterpart of presto_tpu/plan/pushdown.py (the TupleDomain pushdown
into presto-parquet's row-group pruning). A Filter directly above a
TableScan gives its simple range conjuncts (`column <op> literal` on a
numeric or date column) to the scan's `pushdown` hint where the
connector has `row_groups_matching`. The Filter stays: pushdown prunes
row groups, it never replaces the exact evaluation.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from ..expr import ir as E
from ..expr.logical import conjuncts
from . import nodes as N

__all__ = ["push_scan_predicates"]

_CMP = {"lt", "le", "gt", "ge", "eq"}
_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq"}


def _range_of(conj: E.RowExpression, scan: N.TableScanNode
              ) -> Optional[Tuple[str, object, object]]:
    """`$inC <op> literal` (either side) -> (column, lo, hi)."""
    if not isinstance(conj, E.Call) or conj.name not in _CMP:
        return None
    a, b = conj.arguments
    op = conj.name
    if isinstance(b, E.InputReference) and isinstance(a, E.Constant):
        a, b = b, a
        op = _FLIP[op]
    if not (isinstance(a, E.InputReference) and isinstance(b, E.Constant)):
        return None
    if b.value is None or not (a.type.is_numeric or a.type.base == "date"):
        return None
    if a.channel >= len(scan.columns):
        return None
    col, v = scan.columns[a.channel], b.value
    if op == "eq":
        return col, v, v
    if op in ("lt", "le"):
        return col, None, v
    return col, v, None


def _merge(a: Tuple, b: Tuple) -> Tuple:
    """The intersection of two ranges on one column."""
    _, alo, ahi = a
    col, blo, bhi = b
    lo = alo if blo is None else (blo if alo is None else max(alo, blo))
    hi = ahi if bhi is None else (bhi if ahi is None else min(ahi, bhi))
    return col, lo, hi


def push_scan_predicates(root: N.PlanNode) -> N.PlanNode:
    """Annotate each Filter(TableScan) whose connector prunes row groups
    by statistics with the range of its most constrained column (two
    bounds before one). Memoized by identity, so that a shared subtree
    stays one node."""
    from ..connectors import catalog
    memo: Dict[int, N.PlanNode] = {}

    def supports(connector: str) -> bool:
        try:
            return hasattr(catalog(connector), "row_groups_matching")
        except KeyError:
            return False

    def walk(n: N.PlanNode) -> N.PlanNode:
        if id(n) in memo:
            return memo[id(n)]
        orig = n
        changes = {}
        for f in dataclasses.fields(n):
            v = getattr(n, f.name)
            if isinstance(v, N.PlanNode):
                w = walk(v)
                if w is not v:
                    changes[f.name] = w
            elif isinstance(v, list) and v and isinstance(v[0], N.PlanNode):
                w = [walk(x) for x in v]
                if any(x is not y for x, y in zip(w, v)):
                    changes[f.name] = w
        if changes:
            n = dataclasses.replace(n, **changes)
        if isinstance(n, N.FilterNode) \
                and isinstance(n.source, N.TableScanNode) \
                and n.source.pushdown is None \
                and supports(n.source.connector):
            ranges: Dict[str, Tuple] = {}
            for c in conjuncts(n.predicate):
                r = _range_of(c, n.source)
                if r is not None:
                    ranges[r[0]] = _merge(ranges[r[0]], r) \
                        if r[0] in ranges else r
            if ranges:
                best = max(ranges.values(),
                           key=lambda r: (r[1] is not None)
                           + (r[2] is not None))
                n = dataclasses.replace(
                    n, source=dataclasses.replace(n.source, pushdown=best))
        memo[id(orig)] = n
        return n

    return walk(root)
