"""Plan nodes (the plan-fragment vocabulary) and plan passes."""

from .nodes import (AggregationNode, AssignUniqueIdNode, DdlNode,
                    DistinctNode, FilterNode, JoinNode, LimitNode,
                    MarkDistinctNode, OutputNode, PlanNode, ProjectNode,
                    SemiJoinNode, SortNode, TableFinishNode,
                    TableRewriteNode, TableScanNode, TableWriterNode,
                    TopNNode, UnionNode, UnnestNode, from_json, to_json)

__all__ = ["PlanNode", "TableScanNode", "FilterNode", "ProjectNode",
           "AggregationNode", "JoinNode", "SemiJoinNode", "SortNode",
           "TopNNode", "LimitNode", "DistinctNode", "UnionNode",
           "AssignUniqueIdNode", "MarkDistinctNode", "UnnestNode",
           "OutputNode", "DdlNode", "TableRewriteNode", "TableWriterNode",
           "TableFinishNode", "from_json", "to_json"]
