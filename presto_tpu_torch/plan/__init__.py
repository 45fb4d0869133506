"""Plan nodes (the plan-fragment vocabulary) and plan passes."""

from .nodes import (AggregationNode, AssignUniqueIdNode, DistinctNode,
                    FilterNode, JoinNode, LimitNode, MarkDistinctNode,
                    OutputNode, PlanNode, ProjectNode, SemiJoinNode,
                    SortNode, TableScanNode, TopNNode, UnionNode, from_json,
                    to_json)

__all__ = ["PlanNode", "TableScanNode", "FilterNode", "ProjectNode",
           "AggregationNode", "JoinNode", "SemiJoinNode", "SortNode",
           "TopNNode", "LimitNode", "DistinctNode", "UnionNode",
           "AssignUniqueIdNode", "MarkDistinctNode",
           "OutputNode", "from_json", "to_json"]
