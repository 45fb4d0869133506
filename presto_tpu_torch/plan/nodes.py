"""Plan nodes: the worker-visible plan vocabulary this port executes.

Counterpart of presto_tpu/plan/nodes.py, trimmed to the nodes of the
ported plan shapes: TableScan, Values, RemoteSource, Filter, Project, Aggregation
(SINGLE, PARTIAL, INTERMEDIATE, FINAL), Join, SemiJoin, Sort, TopN,
Limit, Distinct, Union, Sample, AssignUniqueId, MarkDistinct, Window,
RowNumber, GroupId, Unnest, Exchange and Output, and the write roots
Ddl, TableRewrite, TableWriter and TableFinish, which the runner
executes on the host around an inner SELECT (exec/runner.py).
Channels are already resolved to indices.

`from_json` reads the dict that presto_tpu.plan.nodes.to_json writes,
and `to_json` writes the same dict: that JSON is the plan-fragment wire
format a worker parses, so the port reads it as data.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
from typing import List, Optional, Tuple, Union

from .. import types as T
from ..expr import ir as E
from ..ops.aggregation import AggSpec, state_types

__all__ = ["PlanNode", "TableScanNode", "ValuesNode", "RemoteSourceNode",
           "FilterNode",
           "ProjectNode",
           "AggregationNode", "JoinNode", "SemiJoinNode", "SortNode",
           "TopNNode", "LimitNode", "DistinctNode", "UnionNode",
           "SampleNode", "AssignUniqueIdNode", "MarkDistinctNode", "WindowNode",
           "RowNumberNode", "GroupIdNode", "UnnestNode", "ExchangeNode",
           "OutputNode", "DdlNode", "TableRewriteNode", "TableWriterNode",
           "TableFinishNode", "WRITE_ROOTS", "from_json", "to_json"]

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
    # connector predicate pushdown (plan/pushdown.py): a (column, lo,
    # hi) range the connector may prune row groups by; the Filter above
    # still applies exactly, and a None bound is unbounded
    pushdown: Optional[Tuple[str, object, object]] = None
    # narrow-width execution (plan/widths.py): per-column physical lane
    # dtype names ("int16", ...; None = logical width)
    physical_dtypes: Optional[Tuple[Optional[str], ...]] = None

    def output_types(self):
        return list(self.column_types)


@dataclasses.dataclass
class RemoteSourceNode(PlanNode):
    """Input fed by the output of an upstream plan fragment
    (plan/fragment.py cuts a plan at its REMOTE exchanges and names the
    producer by `fragment_id`). Its batch is a leaf input of the
    lowering, like a scan's: the worker pulls it from the upstream
    tasks (server/http_exchange.py) and hands it to run_query by this
    node's id (`remote_sources`)."""
    types: List[T.Type]
    fragment_id: int = -1

    def output_types(self):
        return list(self.types)


@dataclasses.dataclass
class ValuesNode(PlanNode):
    """Literal rows (VALUES, and the one row of a FROM-less SELECT, which
    has no columns): each row a list of values in the reference's
    constant form, None for NULL."""
    types: List[T.Type]
    rows: List[List[object]]

    def output_types(self):
        return list(self.types)


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
        """SINGLE and FINAL: the keys, then one column per aggregate;
        PARTIAL: the keys, then each aggregate's state columns;
        INTERMEDIATE: its source's state layout again."""
        src = self.source.output_types()
        if self.step == "INTERMEDIATE":
            return list(src)
        out = [src[c] for c in self.group_channels]
        if self.step in ("SINGLE", "FINAL"):
            return out + [a.output_type for a in self.aggregates]
        for a in self.aggregates:
            out.extend(state_types(a, src))
        return out


@dataclasses.dataclass
class JoinNode(PlanNode):
    """`left` is the probe side, `right` the build side; the output is
    left's columns followed by right's `right_output_channels` (all of
    them when None). `out_capacity` None takes the runner's default."""
    left: PlanNode
    right: PlanNode
    left_keys: List[int]
    right_keys: List[int]
    join_type: str = "inner"          # inner | left | right | full
    distribution: str = "partitioned"  # partitioned | broadcast
    right_output_channels: Optional[List[int]] = None
    out_capacity: Optional[int] = None

    @property
    def sources(self):
        return (self.left, self.right)

    def output_types(self):
        lt = self.left.output_types()
        rt = self.right.output_types()
        chans = self.right_output_channels
        if chans is None:
            chans = list(range(len(rt)))
        return lt + [rt[c] for c in chans]


@dataclasses.dataclass
class SemiJoinNode(PlanNode):
    """`source`'s columns plus one BOOLEAN column: whether each row's
    `source_key` is IN `filtering_source`'s `filtering_key`, with SQL's
    NULL (ops/join.py::semi_join_mask). A key is one channel or a list
    of them."""
    source: PlanNode
    filtering_source: PlanNode
    source_key: Union[int, List[int]]
    filtering_key: Union[int, List[int]]
    negate: bool = False  # anti-join semantics when filtered on
    null_keys_match: bool = False  # NULL == NULL (set-operation semantics)

    @property
    def sources(self):
        return (self.source, self.filtering_source)

    def output_types(self):
        return self.source.output_types() + [T.BOOLEAN]


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
class TopNNode(PlanNode):
    source: PlanNode
    keys: List[Tuple[int, bool, bool]]
    count: int

    @property
    def sources(self):
        return (self.source,)

    def output_types(self):
        return self.source.output_types()


@dataclasses.dataclass
class LimitNode(PlanNode):
    source: PlanNode
    count: int

    @property
    def sources(self):
        return (self.source,)

    def output_types(self):
        return self.source.output_types()


@dataclasses.dataclass
class DistinctNode(PlanNode):
    """DISTINCT over `key_channels` (every column when None). The port
    finds distinct keys by a sort (ops/misc.py), so `max_groups` is
    carried for the plan JSON and never scaled."""
    source: PlanNode
    key_channels: Optional[List[int]] = None
    max_groups: int = 1 << 16

    @property
    def sources(self):
        return (self.source,)

    def output_types(self):
        return self.source.output_types()


@dataclasses.dataclass
class UnionNode(PlanNode):
    """UNION ALL of `inputs`; a set-distinct UNION is a Distinct above
    it."""
    inputs: List[PlanNode] = dataclasses.field(default_factory=list)

    @property
    def sources(self):
        return tuple(self.inputs)

    def output_types(self):
        return self.inputs[0].output_types()


@dataclasses.dataclass
class SampleNode(PlanNode):
    """BERNOULLI sampling: each row is kept with probability `ratio`,
    decided by a deterministic hash of its row slot, as the reference
    decides it."""
    source: PlanNode
    ratio: float = 1.0

    @property
    def sources(self):
        return (self.source,)

    def output_types(self):
        return self.source.output_types()


@dataclasses.dataclass
class AssignUniqueIdNode(PlanNode):
    """`source`'s columns plus a BIGINT unique to each row."""
    source: PlanNode

    @property
    def sources(self):
        return (self.source,)

    def output_types(self):
        return self.source.output_types() + [T.BIGINT]


@dataclasses.dataclass
class MarkDistinctNode(PlanNode):
    """`source`'s columns plus a BOOLEAN that marks the first
    occurrence of each distinct key of `key_channels`; `max_groups` as
    in DistinctNode."""
    source: PlanNode
    key_channels: List[int] = dataclasses.field(default_factory=list)
    max_groups: int = 1 << 16

    @property
    def sources(self):
        return (self.source,)

    def output_types(self):
        return self.source.output_types() + [T.BOOLEAN]


@dataclasses.dataclass
class WindowNode(PlanNode):
    """Window functions over partitions. `functions` entries:
    (name, input channel or None, type, frame, k), frame as
    ops/window.WindowSpec takes it and k the function's int parameter
    (ntile's bucket count, lag/lead's offset, nth_value's n)."""
    source: PlanNode
    partition_channels: List[int] = dataclasses.field(default_factory=list)
    order_keys: List[Tuple[int, bool, bool]] = dataclasses.field(
        default_factory=list)
    functions: List[Tuple] = dataclasses.field(default_factory=list)

    @property
    def sources(self):
        return (self.source,)

    def output_types(self):
        return self.source.output_types() + [f[2] for f in self.functions]


@dataclasses.dataclass
class RowNumberNode(PlanNode):
    """`source`'s columns plus row_number() over partitions, keeping only
    the first `max_rows_per_partition` rows of each when it is set.
    `max_partitions` is carried for the plan JSON only: the sort-based
    operator has no partition table."""
    source: PlanNode
    partition_channels: List[int] = dataclasses.field(default_factory=list)
    order_keys: List[Tuple[int, bool, bool]] = dataclasses.field(
        default_factory=list)
    max_rows_per_partition: Optional[int] = None
    max_partitions: int = 1 << 16

    @property
    def sources(self):
        return (self.source,)

    def output_types(self):
        return self.source.output_types() + [T.BIGINT]


@dataclasses.dataclass
class GroupIdNode(PlanNode):
    """Grouping-set row expansion: each input row is emitted once per
    grouping set, key channels not in that set NULL, and a BIGINT group
    id (the set's index) appended. Output capacity is the source's
    times len(grouping_sets)."""
    source: PlanNode
    grouping_sets: List[List[int]] = dataclasses.field(default_factory=list)

    @property
    def sources(self):
        return (self.source,)

    @property
    def key_channels(self) -> List[int]:
        seen: List[int] = []
        for s in self.grouping_sets:
            for c in s:
                if c not in seen:
                    seen.append(c)
        return seen

    def output_types(self):
        return self.source.output_types() + [T.BIGINT]


@dataclasses.dataclass
class UnnestNode(PlanNode):
    """UNNEST(array or map) [WITH ORDINALITY]: the source's columns but
    the unnested one, then the element column (a map's key and value
    columns), then the ordinality. Without `out_capacity` the output
    holds four times the source's rows. `capacity_factor` is the
    overflow ladder's multiplier of that default (not in the JSON)."""
    source: PlanNode
    array_channel: int
    out_capacity: Optional[int] = None
    with_ordinality: bool = False
    capacity_factor: int = 1

    @property
    def sources(self):
        return (self.source,)

    def output_types(self):
        src = self.source.output_types()
        arr = src[self.array_channel]
        out = [t for i, t in enumerate(src) if i != self.array_channel]
        if arr.base == "map":
            out.extend([arr.key_type, arr.value_type])
        else:
            out.append(arr.element_type)
        if self.with_ordinality:
            out.append(T.BIGINT)
        return out


@dataclasses.dataclass
class ExchangeNode(PlanNode):
    """A stage boundary of a distributed plan: REPARTITION (hash by
    `partition_channels`), REPLICATE, GATHER, or MERGE (of inputs each
    sorted locally by `sort_keys`); scope REMOTE or LOCAL. On one
    device with no mesh every kind and scope is the identity, as in
    the reference without a mesh: a MERGE's input is its local
    SortNode, so its rows are already in order."""
    source: PlanNode
    kind: str = "REPARTITION"
    scope: str = "REMOTE"
    partition_channels: List[int] = dataclasses.field(default_factory=list)
    slot_capacity: Optional[int] = None
    sort_keys: Optional[List[Tuple[int, bool, bool]]] = None

    @property
    def sources(self):
        return (self.source,)

    def output_types(self):
        return self.source.output_types()


@dataclasses.dataclass
class DdlNode(PlanNode):
    """Data definition run on the host against a connector's metadata:
    `op` is drop_table."""
    op: str
    connector: str
    table: str
    if_exists: bool = False

    def output_types(self):
        return [T.BOOLEAN]


@dataclasses.dataclass
class TableRewriteNode(PlanNode):
    """DELETE or UPDATE as a rewrite of a stored table: `source` yields
    the table's columns and a trailing BOOLEAN `changed`; delete drops
    the changed rows, update keeps every row (the changed ones already
    projected to their new values). Outputs the affected rows."""
    source: PlanNode
    connector: str
    table: str
    kind: str = "delete"  # delete | update

    @property
    def sources(self):
        return (self.source,)

    def output_types(self):
        return [T.BIGINT]


@dataclasses.dataclass
class TableWriterNode(PlanNode):
    """Writes its source's rows into a connector table, on the host
    after the source ran on the device. Outputs the rows written."""
    source: PlanNode
    connector: str
    table: str
    column_names: List[str] = dataclasses.field(default_factory=list)
    insert_handle: Optional[str] = None

    @property
    def sources(self):
        return (self.source,)

    def output_types(self):
        return [T.BIGINT]


@dataclasses.dataclass
class TableFinishNode(PlanNode):
    """The commit point of a write: publishes the staged insert at
    once; `create_*` carry a CTAS's table metadata."""
    source: PlanNode
    connector: str
    table: str
    create: bool = False
    create_columns: List[str] = dataclasses.field(default_factory=list)
    create_types: List[T.Type] = dataclasses.field(default_factory=list)

    @property
    def sources(self):
        return (self.source,)

    def output_types(self):
        return [T.BIGINT]


WRITE_ROOTS = (DdlNode, TableRewriteNode, TableWriterNode, TableFinishNode)


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

def _agg_to_json(a: AggSpec) -> dict:
    """The reference's keys; and, where set, `maskChannel` and
    `parameter`, which the reference's JSON leaves out (its plans
    from SQL never set them; a Presto coordinator's fragment does,
    server/protocol.py)."""
    out = {"name": a.name, "input": a.input_channel,
           "type": str(a.output_type)}
    if a.second_channel is not None:
        out["secondChannel"] = a.second_channel
        out["secondType"] = str(a.second_type) if a.second_type else None
    if a.mask_channel is not None:
        out["maskChannel"] = a.mask_channel
    if a.parameter is not None:
        out["parameter"] = a.parameter
    return out


def _agg_from_json(j: dict) -> AggSpec:
    st = j.get("secondType")
    return AggSpec(j["name"], j["input"], T.parse_type(j["type"]),
                   second_channel=j.get("secondChannel"),
                   second_type=T.parse_type(st) if st else None,
                   parameter=j.get("parameter"),
                   mask_channel=j.get("maskChannel"))


def _frame_from_json(frame):
    """A ROWS or RANGE frame arrives as a JSON list: read back the
    tuple the reference builds."""
    return tuple(frame) if isinstance(frame, list) else frame


def to_json(n: PlanNode) -> dict:
    base = {"id": n.id}
    if isinstance(n, TableScanNode):
        j = {**base, "@type": "tablescan", "connector": n.connector,
             "table": n.table, "columns": n.columns,
             "columnTypes": [str(t) for t in n.column_types]}
        if n.pushdown is not None:
            j["pushdown"] = list(n.pushdown)
        if n.physical_dtypes is not None:
            j["physicalDtypes"] = list(n.physical_dtypes)
        return j
    if isinstance(n, RemoteSourceNode):
        return {**base, "@type": "remotesource",
                "types": [str(t) for t in n.types],
                "fragmentId": n.fragment_id}
    if isinstance(n, ValuesNode):
        return {**base, "@type": "values", "types": [str(t) for t in n.types],
                "rows": n.rows}
    if isinstance(n, FilterNode):
        return {**base, "@type": "filter", "source": to_json(n.source),
                "predicate": E.to_json(n.predicate)}
    if isinstance(n, ProjectNode):
        return {**base, "@type": "project", "source": to_json(n.source),
                "expressions": [E.to_json(e) for e in n.expressions]}
    if isinstance(n, AggregationNode):
        return {**base, "@type": "aggregation", "source": to_json(n.source),
                "groupChannels": n.group_channels,
                "aggregates": [_agg_to_json(a) for a in n.aggregates],
                "step": n.step, "maxGroups": n.max_groups}
    if isinstance(n, JoinNode):
        return {**base, "@type": "join", "left": to_json(n.left),
                "right": to_json(n.right), "leftKeys": n.left_keys,
                "rightKeys": n.right_keys, "joinType": n.join_type,
                "distribution": n.distribution,
                "rightOutputChannels": n.right_output_channels,
                "outCapacity": n.out_capacity}
    if isinstance(n, SemiJoinNode):
        return {**base, "@type": "semijoin", "source": to_json(n.source),
                "filteringSource": to_json(n.filtering_source),
                "sourceKey": n.source_key, "filteringKey": n.filtering_key,
                "negate": n.negate, "nullKeysMatch": n.null_keys_match}
    if isinstance(n, SortNode):
        return {**base, "@type": "sort", "source": to_json(n.source),
                "keys": [list(k) for k in n.keys]}
    if isinstance(n, TopNNode):
        return {**base, "@type": "topn", "source": to_json(n.source),
                "keys": [list(k) for k in n.keys], "count": n.count}
    if isinstance(n, LimitNode):
        return {**base, "@type": "limit", "source": to_json(n.source),
                "count": n.count}
    if isinstance(n, DistinctNode):
        return {**base, "@type": "distinct", "source": to_json(n.source),
                "keyChannels": n.key_channels, "maxGroups": n.max_groups}
    if isinstance(n, UnionNode):
        return {**base, "@type": "union",
                "inputs": [to_json(s) for s in n.inputs]}
    if isinstance(n, SampleNode):
        return {**base, "@type": "sample", "source": to_json(n.source),
                "ratio": n.ratio}
    if isinstance(n, AssignUniqueIdNode):
        return {**base, "@type": "assignuniqueid",
                "source": to_json(n.source)}
    if isinstance(n, MarkDistinctNode):
        return {**base, "@type": "markdistinct", "source": to_json(n.source),
                "keyChannels": n.key_channels, "maxGroups": n.max_groups}
    if isinstance(n, WindowNode):
        return {**base, "@type": "window", "source": to_json(n.source),
                "partitionChannels": n.partition_channels,
                "orderKeys": [list(k) for k in n.order_keys],
                "functions": [[f[0], f[1], str(f[2]), f[3], f[4]]
                              for f in n.functions]}
    if isinstance(n, RowNumberNode):
        return {**base, "@type": "rownumber", "source": to_json(n.source),
                "partitionChannels": n.partition_channels,
                "orderKeys": [list(k) for k in n.order_keys],
                "maxRowsPerPartition": n.max_rows_per_partition,
                "maxPartitions": n.max_partitions}
    if isinstance(n, UnnestNode):
        return {**base, "@type": "unnest", "source": to_json(n.source),
                "arrayChannel": n.array_channel,
                "outCapacity": n.out_capacity,
                "withOrdinality": n.with_ordinality}
    if isinstance(n, GroupIdNode):
        return {**base, "@type": "groupid", "source": to_json(n.source),
                "groupingSets": [list(s) for s in n.grouping_sets]}
    if isinstance(n, ExchangeNode):
        return {**base, "@type": "exchange", "source": to_json(n.source),
                "kind": n.kind, "scope": n.scope,
                "partitionChannels": n.partition_channels,
                "slotCapacity": n.slot_capacity,
                "sortKeys": [list(k) for k in n.sort_keys]
                if n.sort_keys is not None else None}
    if isinstance(n, DdlNode):
        return {**base, "@type": "ddl", "op": n.op,
                "connector": n.connector, "table": n.table,
                "ifExists": n.if_exists}
    if isinstance(n, TableRewriteNode):
        return {**base, "@type": "tablerewrite", "source": to_json(n.source),
                "connector": n.connector, "table": n.table, "kind": n.kind}
    if isinstance(n, TableWriterNode):
        return {**base, "@type": "tablewriter", "source": to_json(n.source),
                "connector": n.connector, "table": n.table,
                "columnNames": n.column_names,
                "insertHandle": n.insert_handle}
    if isinstance(n, TableFinishNode):
        return {**base, "@type": "tablefinish", "source": to_json(n.source),
                "connector": n.connector, "table": n.table,
                "create": n.create, "createColumns": n.create_columns,
                "createTypes": [str(t) for t in n.create_types]}
    if isinstance(n, OutputNode):
        return {**base, "@type": "output", "source": to_json(n.source),
                "names": n.names}
    raise TypeError(type(n))


def _shape(j: dict) -> str:
    """A node's JSON with every node id left out."""
    def strip(v):
        if isinstance(v, dict):
            return {k: strip(x) for k, x in v.items() if k != "id"}
        if isinstance(v, list):
            return [strip(x) for x in v]
        return v
    return json.dumps(strip(j), sort_keys=True)


def from_json(j: dict) -> PlanNode:
    """The plan a to_json dict describes. A node id that comes again
    with the same content (node ids below it aside) is the node already
    read, so the plan is a DAG with one node per shared subtree: the
    reference's plan passes copy subtrees with dataclasses.replace,
    which keeps the id, and its JSON writes a shared subtree out under
    every parent. The same passes also keep the id of a node they
    change (a pruned projection of one side of a self-join, TPC-DS q47),
    so a repeated id with other content is another node: it reads
    under the id with ".k" appended, k counting the variants. A shape
    is computed only once its id comes again: most ids come once."""
    memo: dict = {}

    def read(x: dict) -> PlanNode:
        nid = x.get("id")
        variants = memo.setdefault(nid, []) if nid else None
        if variants:
            shape = _shape(x)
            for i, (node, known) in enumerate(variants):
                if isinstance(known, dict):  # its JSON, not yet its shape
                    known = _shape(known)
                    variants[i] = (node, known)
                if known == shape:
                    return node
            x = {**x, "id": f"{nid}.{len(variants)}"}
        node = _node_from_json(x, read)
        if nid:
            variants.append((node, x))
        return node

    return read(j)


def _node_from_json(j: dict, sub) -> PlanNode:
    t = j["@type"]
    nid = j.get("id")
    kw = {"id": nid} if nid else {}
    if t == "tablescan":
        pd = j.get("pushdown")
        phys = j.get("physicalDtypes")
        return TableScanNode(j["connector"], j["table"], j["columns"],
                             [T.parse_type(s) for s in j["columnTypes"]],
                             pushdown=tuple(pd) if pd else None,
                             physical_dtypes=tuple(phys) if phys else None,
                             **kw)
    if t == "filter":
        return FilterNode(sub(j["source"]),
                          E.from_json(j["predicate"]), **kw)
    if t == "project":
        return ProjectNode(sub(j["source"]),
                           [E.from_json(e) for e in j["expressions"]], **kw)
    if t == "aggregation":
        return AggregationNode(sub(j["source"]), j["groupChannels"],
                               [_agg_from_json(a) for a in j["aggregates"]],
                               j["step"], j["maxGroups"], **kw)
    if t == "join":
        return JoinNode(sub(j["left"]), sub(j["right"]),
                        j["leftKeys"], j["rightKeys"], j["joinType"],
                        j["distribution"], j["rightOutputChannels"],
                        j["outCapacity"], **kw)
    if t == "semijoin":
        return SemiJoinNode(sub(j["source"]),
                            sub(j["filteringSource"]), j["sourceKey"],
                            j["filteringKey"], j["negate"],
                            j.get("nullKeysMatch", False), **kw)
    if t == "sort":
        return SortNode(sub(j["source"]),
                        [tuple(k) for k in j["keys"]], **kw)
    if t == "topn":
        return TopNNode(sub(j["source"]),
                        [tuple(k) for k in j["keys"]], j["count"], **kw)
    if t == "limit":
        return LimitNode(sub(j["source"]), j["count"], **kw)
    if t == "distinct":
        return DistinctNode(sub(j["source"]), j["keyChannels"],
                            j["maxGroups"], **kw)
    if t == "union":
        return UnionNode([sub(s) for s in j["inputs"]], **kw)
    if t == "remotesource":
        return RemoteSourceNode([T.parse_type(x) for x in j["types"]],
                                j["fragmentId"], **kw)
    if t == "values":
        return ValuesNode([T.parse_type(x) for x in j["types"]], j["rows"],
                          **kw)
    if t == "sample":
        return SampleNode(sub(j["source"]), j["ratio"], **kw)
    if t == "assignuniqueid":
        return AssignUniqueIdNode(sub(j["source"]), **kw)
    if t == "markdistinct":
        return MarkDistinctNode(sub(j["source"]), j["keyChannels"],
                                j["maxGroups"], **kw)
    if t == "window":
        return WindowNode(sub(j["source"]), j["partitionChannels"],
                          [tuple(k) for k in j["orderKeys"]],
                          [(f[0], f[1], T.parse_type(f[2]),
                            _frame_from_json(f[3]), f[4])
                           for f in j["functions"]], **kw)
    if t == "rownumber":
        return RowNumberNode(sub(j["source"]), j["partitionChannels"],
                             [tuple(k) for k in j["orderKeys"]],
                             j["maxRowsPerPartition"], j["maxPartitions"],
                             **kw)
    if t == "unnest":
        return UnnestNode(sub(j["source"]), j["arrayChannel"],
                          j["outCapacity"], j["withOrdinality"], **kw)
    if t == "groupid":
        return GroupIdNode(sub(j["source"]),
                           [list(s) for s in j["groupingSets"]], **kw)
    if t == "exchange":
        keys = j.get("sortKeys")
        return ExchangeNode(sub(j["source"]), j["kind"], j["scope"],
                            j["partitionChannels"], j["slotCapacity"],
                            [tuple(k) for k in keys] if keys is not None
                            else None, **kw)
    if t == "ddl":
        return DdlNode(j["op"], j["connector"], j["table"],
                       j.get("ifExists", False), **kw)
    if t == "tablerewrite":
        return TableRewriteNode(sub(j["source"]), j["connector"],
                                j["table"], j["kind"], **kw)
    if t == "tablewriter":
        return TableWriterNode(sub(j["source"]), j["connector"],
                               j["table"], j["columnNames"],
                               j.get("insertHandle"), **kw)
    if t == "tablefinish":
        return TableFinishNode(sub(j["source"]), j["connector"],
                               j["table"], j["create"], j["createColumns"],
                               [T.parse_type(s) for s in j["createTypes"]],
                               **kw)
    if t == "output":
        return OutputNode(sub(j["source"]), j["names"], **kw)
    raise ValueError(f"unknown plan node kind {t!r}")
