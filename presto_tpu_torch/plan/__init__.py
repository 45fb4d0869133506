"""Plan nodes (the plan-fragment vocabulary) and plan passes."""

from .nodes import (AggregationNode, FilterNode, JoinNode, OutputNode,
                    PlanNode, ProjectNode, SemiJoinNode, SortNode,
                    TableScanNode, TopNNode, from_json, to_json)

__all__ = ["PlanNode", "TableScanNode", "FilterNode", "ProjectNode",
           "AggregationNode", "JoinNode", "SemiJoinNode", "SortNode",
           "TopNNode",
           "OutputNode", "from_json", "to_json"]
