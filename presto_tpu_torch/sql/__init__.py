"""The port's SQL front door: parser, planner, meta statements, `sql()`."""

from .parser import parse_sql
from .planner import plan_sql, sql

__all__ = ["parse_sql", "plan_sql", "sql"]
