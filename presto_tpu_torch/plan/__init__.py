"""Plan nodes (the plan-fragment vocabulary) and plan passes."""

from .nodes import (AggregationNode, FilterNode, JoinNode, OutputNode,
                    PlanNode, ProjectNode, SortNode, TableScanNode, TopNNode,
                    from_json, to_json)

__all__ = ["PlanNode", "TableScanNode", "FilterNode", "ProjectNode",
           "AggregationNode", "JoinNode", "SortNode", "TopNNode",
           "OutputNode", "from_json", "to_json"]
