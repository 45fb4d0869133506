"""Plan nodes: the worker-visible plan vocabulary this port executes.

Counterpart of presto_tpu/plan/nodes.py, trimmed to the nodes of the
TPC-H q1/q6 plan shape: TableScan, Filter, Project, Aggregation, Sort
and Output. Channels are already resolved to indices.

`from_json` reads the dict that presto_tpu.plan.nodes.to_json writes:
that JSON is the plan-fragment wire format a worker parses, so the port
reads it as data. Node kinds the port does not run yet raise
NotImplementedError naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Tuple

from .. import types as T
from ..expr import ir as E
from ..ops.aggregation import AggSpec

__all__ = ["PlanNode", "TableScanNode", "FilterNode", "ProjectNode",
           "AggregationNode", "SortNode", "OutputNode", "from_json"]

_ids = itertools.count(1)


def _nid() -> str:
    return str(next(_ids))


@dataclasses.dataclass
class PlanNode:
    id: str = dataclasses.field(default_factory=_nid, kw_only=True)

    @property
    def sources(self) -> Tuple["PlanNode", ...]:
        return ()

    def output_types(self) -> List[T.Type]:
        raise NotImplementedError


@dataclasses.dataclass
class TableScanNode(PlanNode):
    connector: str
    table: str
    columns: List[str]
    column_types: List[T.Type]
    # narrow-width execution (plan/widths.py): per-column physical lane
    # dtype names ("int16", ...; None = logical width)
    physical_dtypes: Optional[Tuple[Optional[str], ...]] = None

    def output_types(self):
        return list(self.column_types)


@dataclasses.dataclass
class FilterNode(PlanNode):
    source: PlanNode
    predicate: E.RowExpression

    @property
    def sources(self):
        return (self.source,)

    def output_types(self):
        return self.source.output_types()


@dataclasses.dataclass
class ProjectNode(PlanNode):
    source: PlanNode
    expressions: List[E.RowExpression]

    @property
    def sources(self):
        return (self.source,)

    def output_types(self):
        return [e.type for e in self.expressions]


@dataclasses.dataclass
class AggregationNode(PlanNode):
    source: PlanNode
    group_channels: List[int]
    aggregates: List[AggSpec]
    step: str = "SINGLE"  # SINGLE | PARTIAL | FINAL | INTERMEDIATE
    max_groups: int = 1 << 16

    @property
    def sources(self):
        return (self.source,)

    def output_types(self):
        src = self.source.output_types()
        return [src[c] for c in self.group_channels] + \
            [a.output_type for a in self.aggregates]


@dataclasses.dataclass
class SortNode(PlanNode):
    source: PlanNode
    keys: List[Tuple[int, bool, bool]]  # (channel, descending, nulls_last)

    @property
    def sources(self):
        return (self.source,)

    def output_types(self):
        return self.source.output_types()


@dataclasses.dataclass
class OutputNode(PlanNode):
    source: PlanNode
    names: List[str]

    @property
    def sources(self):
        return (self.source,)

    def output_types(self):
        return self.source.output_types()


# ---------------------------------------------------------------------------
# JSON (the plan-fragment wire shape)
# ---------------------------------------------------------------------------

# node kinds of presto_tpu's wire format this port does not run yet
_NOT_PORTED = {
    "join": "queue 1 item 8 (joins, for config 2)",
    "semijoin": "queue 1 item 8 (joins, for config 2)",
    "limit": "queue 1 item 8 (joins and misc, for config 2)",
    "distinct": "queue 1 item 8 (joins and misc, for config 2)",
    "markdistinct": "queue 1 item 8 (joins and misc, for config 2)",
    "topn": "queue 1 item 8 (top_n, for config 2)",
    "window": "queue 1 item 10 (breadth: ops/window.py)",
    "rownumber": "queue 1 item 10 (breadth: ops/window.py)",
    "unnest": "queue 1 item 10 (breadth: ops/unnest.py)",
    "exchange": "queue 1 item 12 (parallel/ and the worker tier)",
    "remotesource": "queue 1 item 12 (parallel/ and the worker tier)",
}


def _agg_from_json(j: dict) -> AggSpec:
    return AggSpec(j["name"], j["input"], T.parse_type(j["type"]))


def from_json(j: dict) -> PlanNode:
    t = j["@type"]
    nid = j.get("id")
    kw = {"id": nid} if nid else {}
    if t == "tablescan":
        # "pushdown" (a connector pruning range; the Filter above still
        # applies exactly) is not needed by the generated tables
        phys = j.get("physicalDtypes")
        return TableScanNode(j["connector"], j["table"], j["columns"],
                             [T.parse_type(s) for s in j["columnTypes"]],
                             physical_dtypes=tuple(phys) if phys else None,
                             **kw)
    if t == "filter":
        return FilterNode(from_json(j["source"]),
                          E.from_json(j["predicate"]), **kw)
    if t == "project":
        return ProjectNode(from_json(j["source"]),
                           [E.from_json(e) for e in j["expressions"]], **kw)
    if t == "aggregation":
        return AggregationNode(from_json(j["source"]), j["groupChannels"],
                               [_agg_from_json(a) for a in j["aggregates"]],
                               j["step"], j["maxGroups"], **kw)
    if t == "sort":
        return SortNode(from_json(j["source"]),
                        [tuple(k) for k in j["keys"]], **kw)
    if t == "output":
        return OutputNode(from_json(j["source"]), j["names"], **kw)
    if t in _NOT_PORTED:
        raise NotImplementedError(
            f"plan node {t!r} is not ported yet: ROADMAP {_NOT_PORTED[t]}")
    raise NotImplementedError(
        f"plan node {t!r} is not ported yet: ROADMAP queue 1 item 10 "
        "(breadth)")
