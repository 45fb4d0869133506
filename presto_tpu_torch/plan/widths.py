"""Narrow-width execution: plan-level physical-lane inference.

Counterpart of presto_tpu/plan/widths.py (`infer_table_widths`,
`annotate_widths`, `checked_physical_dtypes`, `narrow_enabled`). Each
scan column whose value range the connector proves stages at the
narrowest integer lane that holds it (int8/int16/int32); prepare_plan
annotates the scans. The logical type is unchanged and
every compute site widens before arithmetic, so results stay exact.
The staging site re-checks the actual host values, so a stale
statistic makes a column stage wide instead of wrapping.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import types as T
from . import nodes as N

__all__ = ["narrow_enabled", "infer_column_width", "infer_table_widths",
           "annotate_widths", "checked_physical_dtypes"]


def narrow_enabled(session=None) -> bool:
    """Whether prepare_plan annotates narrow lanes: on unless the
    session sets narrow_width_execution to false."""
    from ..utils.config import session_flag
    return session_flag(session, "narrow_width_execution", True)


_CANDIDATES = (np.dtype(np.int8), np.dtype(np.int16), np.dtype(np.int32))
_NARROWABLE_BASES = ("tinyint", "smallint", "integer", "bigint", "date",
                     "time", "timestamp")


def _narrowable(ty: T.Type) -> bool:
    if ty.is_decimal:
        return ty.is_short_decimal
    return ty.base in _NARROWABLE_BASES


def infer_column_width(ty: T.Type, lo: int, hi: int) -> Optional[str]:
    """Narrowest physical dtype name for values of `ty` in [lo, hi];
    None keeps the logical lane."""
    if not _narrowable(ty):
        return None
    logical = np.dtype(ty.to_dtype())
    for cand in _CANDIDATES:
        if cand.itemsize >= logical.itemsize:
            break
        info = np.iinfo(cand)
        if info.min <= lo and hi <= info.max:
            return cand.name
    return None


def _column_range(conn, table: str, column: str, sf: float
                  ) -> Optional[Tuple[int, int]]:
    """The connector's proven value range of a column; None where it
    has no range statistics (the tpcds connector) or none for it."""
    fn = getattr(conn, "column_range", None)
    if fn is None:
        return None
    try:
        return fn(table, column, sf)
    except KeyError:
        return None


def infer_table_widths(connector: str, table: str, columns: Sequence[str],
                       column_types: Sequence[T.Type], sf: float
                       ) -> Optional[Tuple[Optional[str], ...]]:
    """Per-column physical dtype names for one scan; None when nothing
    narrows or the connector has no range statistics."""
    from ..connectors import catalog
    try:
        conn = catalog(connector)
    except KeyError:
        return None
    out: List[Optional[str]] = []
    for col, ty in zip(columns, column_types):
        rng = _column_range(conn, table, col, sf)
        out.append(None if rng is None
                   else infer_column_width(ty, int(rng[0]), int(rng[1])))
    if not any(out):
        return None
    return tuple(out)


def annotate_widths(root: N.PlanNode, sf: float, _memo=None) -> N.PlanNode:
    """Rewrite every range-proven TableScanNode with its
    `physical_dtypes` annotation; a scan that already carries one (a
    plan prepared by the reference) keeps it. A shared subtree stays
    one node (the rewrite is memoized by identity), so that the plan
    DAG's readers stay what dynamic filtering sees."""
    if _memo is None:
        _memo = {}
    if id(root) in _memo:
        return _memo[id(root)]
    orig = id(root)
    replaced = {}
    for f in dataclasses.fields(root):
        v = getattr(root, f.name)
        if isinstance(v, N.PlanNode):
            nv = annotate_widths(v, sf, _memo)
            if nv is not v:
                replaced[f.name] = nv
        elif isinstance(v, list) and v and isinstance(v[0], N.PlanNode):
            # a UnionNode's inputs
            nv = [annotate_widths(x, sf, _memo) for x in v]
            if any(a is not b for a, b in zip(nv, v)):
                replaced[f.name] = nv
    if replaced:
        root = dataclasses.replace(root, **replaced)
    if isinstance(root, N.TableScanNode) and root.physical_dtypes is None \
            and not _pushdown_bypasses_staging(root):
        widths = infer_table_widths(root.connector, root.table, root.columns,
                                    root.column_types, sf)
        if widths is not None:
            root = dataclasses.replace(root, physical_dtypes=widths)
    _memo[orig] = root
    return root


def _pushdown_bypasses_staging(node: N.TableScanNode) -> bool:
    """A scan with a connector pushdown range stages through the
    connector's own row-group reader (exec/runner.py::_scan_batch),
    which does not read narrow lanes: such a scan gets none."""
    if node.pushdown is None:
        return False
    from ..connectors import catalog
    try:
        return hasattr(catalog(node.connector), "row_groups_matching")
    except KeyError:
        return False


def checked_physical_dtypes(phys: Sequence[Optional[str]],
                            types: Sequence[T.Type],
                            arrays: Sequence[np.ndarray],
                            nulls: Optional[Sequence[
                                Optional[np.ndarray]]] = None
                            ) -> Tuple[Optional[str], ...]:
    """Staging-time guard: drop any narrowing the actual host values
    would overflow. NULL positions are excluded from the check."""
    out: List[Optional[str]] = []
    for i, (dt, arr) in enumerate(zip(phys, arrays)):
        if dt is None or arr.dtype == object or arr.dtype.kind not in "iu" \
                or not len(arr):
            out.append(None)
            continue
        live = arr
        if nulls is not None and nulls[i] is not None:
            live = arr[~np.asarray(nulls[i], dtype=bool)]
            if not len(live):
                out.append(dt)
                continue
        info = np.iinfo(np.dtype(dt))
        lo, hi = int(live.min()), int(live.max())
        out.append(dt if info.min <= lo and hi <= info.max else None)
    return tuple(out)
