"""Execution: plan preparation, lowering and the query runner."""

from .runner import QueryResult, prepare_plan, run_query

__all__ = ["run_query", "prepare_plan", "QueryResult"]
