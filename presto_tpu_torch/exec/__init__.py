"""Execution: plan lowering and the query runner."""

from .runner import QueryResult, run_query

__all__ = ["run_query", "QueryResult"]
