"""Plan validation: which plan shapes can this engine execute?

The port's copy of presto_tpu/plan/validator.py (Presto's PlanChecker),
checked against the port's function REGISTRY, its aggregates and its
regex DFA. `validate_plan` returns the list of violations; empty means
executable.
"""

from __future__ import annotations

from typing import List

from ..expr import ir as E
from ..expr.functions import REGISTRY
from ..ops.aggregation import _AGGS
from . import nodes as N

__all__ = ["validate_plan"]

_SPECIAL_INTERCEPTED = {"like", "date_add", "date_trunc", "date_diff",
                        "split_part", "cast", "regexp_like", "date_format",
                        "at_timezone", "regexp_replace", "row_field",
                        "transform", "filter", "any_match", "all_match",
                        "none_match", "reduce", "array_constructor",
                        "transform_values", "transform_keys", "map_filter",
                        "sequence"}
_DATE_UNITS = {"date_add": {"day", "week", "month", "year"},
               "date_trunc": {"day", "week", "month", "quarter", "year"},
               "date_diff": {"day", "week", "month", "quarter", "year"}}


def _check_expr(e: E.RowExpression, out: List[str]):
    if isinstance(e, E.Call):
        name = e.name.lower()
        if name not in REGISTRY and name not in _SPECIAL_INTERCEPTED:
            out.append(f"unregistered scalar function {name!r}")
        if name == "like" and not isinstance(e.arguments[1], E.Constant):
            out.append("LIKE with non-constant pattern")
        if name == "regexp_like":
            if not isinstance(e.arguments[1], E.Constant):
                out.append("regexp_like with non-constant pattern")
            else:
                from ..ops.regex import RegexUnsupported, compile_dfa
                try:
                    compile_dfa(str(e.arguments[1].value))
                except RegexUnsupported as ex:
                    out.append(f"regexp_like pattern: {ex}")
        if name == "date_format":
            if not isinstance(e.arguments[1], E.Constant):
                out.append("date_format with non-constant format")
            else:
                from ..expr.functions import date_format_width
                try:
                    date_format_width(str(e.arguments[1].value))
                except NotImplementedError as ex:
                    out.append(str(ex))
        if name in _DATE_UNITS:
            unit = e.arguments[0]
            if not isinstance(unit, E.Constant):
                out.append(f"{name} with non-constant unit")
            elif str(unit.value) not in _DATE_UNITS[name]:
                out.append(f"{name} unit {unit.value!r} not supported")
        if name == "split_part":
            if not isinstance(e.arguments[1], E.Constant):
                out.append("split_part with non-constant delimiter")
            elif len(str(e.arguments[1].value)) != 1:
                out.append("split_part delimiter must be 1 byte")
            if not isinstance(e.arguments[2], E.Constant):
                out.append("split_part with non-constant index")
    for c in e.children():
        _check_expr(c, out)


def validate_plan(root: N.PlanNode, distributed: bool = False) -> List[str]:
    out: List[str] = []

    def walk(n: N.PlanNode):
        if isinstance(n, N.TableScanNode):
            try:
                from ..connectors import catalog
                catalog(n.connector)
            except KeyError:
                out.append(f"unknown connector {n.connector!r}")
        elif isinstance(n, N.FilterNode):
            _check_expr(n.predicate, out)
        elif isinstance(n, N.ProjectNode):
            for e in n.expressions:
                _check_expr(e, out)
        elif isinstance(n, N.AggregationNode):
            st = n.source.output_types()
            for c in n.group_channels:
                if st[c].base == "array":
                    out.append("array-typed group key")
            for a in n.aggregates:
                if a.name not in _AGGS:
                    out.append(f"unsupported aggregate {a.name!r}")
                elif distributed and a.canonical in ("count_distinct",
                                                     "approx_percentile") and \
                        n.step != "SINGLE":
                    out.append(f"{a.name} partials don't merge; "
                               "pre-partition rows by group keys")
                elif a.canonical == "approx_percentile" and a.parameter is None:
                    out.append("approx_percentile without a fraction")
        elif isinstance(n, N.JoinNode):
            if n.join_type not in ("inner", "left", "right", "full"):
                out.append(f"unsupported join type {n.join_type!r}")
            lt = n.left.output_types()
            rt = n.right.output_types()
            for c in n.left_keys:
                if lt[c].base == "array":
                    out.append("array-typed join key")
            for c in n.right_keys:
                if rt[c].base == "array":
                    out.append("array-typed join key")
        elif isinstance(n, (N.SortNode, N.TopNNode)):
            st = n.source.output_types()
            for c, _, _ in n.keys:
                if st[c].base == "array":
                    out.append("array-typed sort key")
        elif isinstance(n, N.ExchangeNode):
            if n.kind not in ("REPARTITION", "REPLICATE", "GATHER", "MERGE"):
                out.append(f"unsupported exchange kind {n.kind!r}")
            if n.kind == "MERGE" and not n.sort_keys:
                out.append("MERGE exchange without sort_keys")
        for s in n.sources:
            walk(s)

    walk(root)
    return out
