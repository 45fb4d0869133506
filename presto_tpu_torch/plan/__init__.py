"""Plan nodes (the plan-fragment vocabulary) and plan passes."""

from .fragment import PlanFragment, fragment_plan
from .nodes import (AggregationNode, AssignUniqueIdNode, DdlNode,
                    DistinctNode, ExchangeNode, FilterNode, JoinNode,
                    LimitNode, MarkDistinctNode, OutputNode, PlanNode,
                    ProjectNode, RemoteSourceNode, SemiJoinNode, SortNode,
                    TableFinishNode, TableRewriteNode, TableScanNode,
                    TableWriterNode, TopNNode, UnionNode, UnnestNode,
                    ValuesNode, from_json, to_json)
from .explain import explain, explain_analyze, explain_distributed

__all__ = ["PlanNode", "TableScanNode", "ValuesNode", "RemoteSourceNode",
           "FilterNode", "ProjectNode", "AggregationNode", "JoinNode",
           "SemiJoinNode", "SortNode", "TopNNode", "LimitNode",
           "DistinctNode", "UnionNode", "AssignUniqueIdNode",
           "MarkDistinctNode", "UnnestNode", "ExchangeNode", "OutputNode",
           "DdlNode", "TableRewriteNode", "TableWriterNode",
           "TableFinishNode", "from_json", "to_json", "PlanFragment",
           "fragment_plan", "explain", "explain_analyze",
           "explain_distributed"]
