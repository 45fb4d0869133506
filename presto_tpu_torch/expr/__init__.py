"""Expressions: the IR, the scalar function registry and the evaluator."""

from .compile import compile_filter, compile_projections, evaluate
from .ir import call, const, input_ref, special

__all__ = ["call", "const", "input_ref", "special", "evaluate",
           "compile_filter", "compile_projections"]
