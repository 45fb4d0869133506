"""Plan nodes (the plan-fragment vocabulary) and plan passes."""

from .nodes import (AggregationNode, AssignUniqueIdNode, DistinctNode,
                    FilterNode, JoinNode, LimitNode, MarkDistinctNode,
                    OutputNode, PlanNode, ProjectNode, SemiJoinNode,
                    SortNode, TableScanNode, TopNNode, UnionNode, UnnestNode,
                    from_json, to_json)

__all__ = ["PlanNode", "TableScanNode", "FilterNode", "ProjectNode",
           "AggregationNode", "JoinNode", "SemiJoinNode", "SortNode",
           "TopNNode", "LimitNode", "DistinctNode", "UnionNode",
           "AssignUniqueIdNode", "MarkDistinctNode", "UnnestNode",
           "OutputNode", "from_json", "to_json"]
