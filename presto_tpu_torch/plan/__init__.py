"""Plan nodes (the plan-fragment vocabulary) and plan passes."""

from .nodes import (AggregationNode, FilterNode, OutputNode, PlanNode,
                    ProjectNode, SortNode, TableScanNode, from_json)

__all__ = ["PlanNode", "TableScanNode", "FilterNode", "ProjectNode",
           "AggregationNode", "SortNode", "OutputNode", "from_json"]
