"""W001: hot-path kernel modules stay narrow-lane disciplined.

Counterpart of presto_tpu/lint/passes/wide_lanes.py, in torch terms.
Narrow-width execution (plan/widths.py) stages every range-proven
column at 32 bits or less; one accidental 64-bit lane doubles the bytes
the card moves for it. Two rules over the ops modules the reference
names (aggregation, keys, join, sort, window):

  1. IMPLICIT-DTYPE creation: ``torch.arange(n)`` and
     ``torch.tensor([1, 2])`` make int64 lanes, ``torch.full(n, 0)``
     an int64 fill, ``torch.zeros(n)`` lanes of the process default
     dtype. Every ``zeros/ones/full/empty/arange/tensor/linspace/eye``
     call names its dtype.
  2. EXPLICIT 64-bit lanes -- ``dtype=torch.int64`` (``long``,
     ``float64``, ``double``), ``.to(torch.int64)``, ``.long()``,
     ``.double()`` -- only inside the sites the kernel audit's K001
     sanctions (audit/passes/wide_lanes.py, read from there):
     ``WIDE_OK_FILES`` whole, ``WIDE_OK_SITES`` by any enclosing
     function or class, and a cast of an output that is int64 by
     torch's own contract (``INDEX_OUTPUTS``: argsort, nonzero, the
     indices of sort/topk/max/min ...), which changes nothing.

Most sanctioned sites are index lanes: torch's gather, scatter, sort
and advanced indexing take int64 positions, where XLA takes 32-bit
ones, so row positions, permutations, group slots and segment ids are
int64 by the library's contract.
"""

from __future__ import annotations

import ast
import functools
from typing import List, Set

from ..core import (Finding, LintPass, ModuleSource, dotted_context,
                    register)

__all__ = ["WideLanesPass", "scan_module"]

_CREATORS = {"zeros", "ones", "full", "empty", "arange", "tensor",
             "linspace", "eye"}
_WIDE_DTYPES = {"int64", "long", "float64", "double"}
_WIDE_METHODS = {"long": "int64", "double": "float64"}


@functools.lru_cache(maxsize=1)
def _k001_whitelist():
    """K001's whitelist, the single source: (files, sites, the torch
    names of the ops whose outputs are int64 by contract)."""
    from ...audit.passes.wide_lanes import (INDEX_OUTPUTS, WIDE_OK_FILES,
                                            WIDE_OK_SITES)
    index_ops = {op.split(".", 1)[1].lstrip("_").rstrip("0123456789")
                 for op in INDEX_OUTPUTS}
    return WIDE_OK_FILES, WIDE_OK_SITES, index_ops


def _wide_dtype(node: ast.AST) -> str:
    """'int64'/'float64' when ``node`` spells a 64-bit torch dtype
    (``torch.int64``, ``torch.long``, ...), else ''."""
    if isinstance(node, ast.Attribute) and node.attr in _WIDE_DTYPES and \
            isinstance(node.value, ast.Name) and node.value.id == "torch":
        return "int64" if node.attr in ("int64", "long") else "float64"
    return ""


def _call_name(node: ast.AST) -> str:
    if isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Attribute):
            return fn.attr
        if isinstance(fn, ast.Name):
            return fn.id
    return ""


def scan_module(ms: ModuleSource, code: str = "W001") -> List[Finding]:
    """The W001 rule engine over one parsed module."""
    files, sites, index_ops = _k001_whitelist()
    if ms.rel_path in files:
        return []
    allowed: Set[str] = set(sites.get(ms.rel_path, {}))
    findings: List[Finding] = []
    stack: List[str] = []

    def in_allowed() -> bool:
        return any(s in allowed for s in stack)

    def emit(node: ast.AST, message: str) -> None:
        findings.append(ms.finding(code, node, dotted_context(stack),
                                   message))

    def index_lane(subject: ast.AST) -> bool:
        while isinstance(subject, ast.Subscript):
            subject = subject.value
        return _call_name(subject) in index_ops

    class V(ast.NodeVisitor):
        def visit_FunctionDef(self, node):
            stack.append(node.name)
            self.generic_visit(node)
            stack.pop()

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_ClassDef(self, node):
            stack.append(node.name)
            self.generic_visit(node)
            stack.pop()

        def visit_Call(self, node):
            fn = node.func
            # rule 1: torch creators must name a dtype
            if isinstance(fn, ast.Attribute) and fn.attr in _CREATORS \
                    and isinstance(fn.value, ast.Name) \
                    and fn.value.id == "torch" \
                    and not any(k.arg == "dtype" for k in node.keywords):
                emit(node, f"torch.{fn.attr}() without an explicit dtype "
                           f"(implicit lane width: int64 for integer "
                           f"ranges, literals and fills)")
            # rule 2: casts to 64-bit lanes outside the whitelist
            if isinstance(fn, ast.Attribute) and not in_allowed() and \
                    not index_lane(fn.value):
                if fn.attr in ("to", "type") and node.args and \
                        _wide_dtype(node.args[0]):
                    emit(node, f".{fn.attr}({_wide_dtype(node.args[0])}) "
                               f"outside K001's sanctioned wide-lane "
                               f"sites")
                elif fn.attr in _WIDE_METHODS and not node.args:
                    emit(node, f".{fn.attr}() makes "
                               f"{_WIDE_METHODS[fn.attr]} lanes outside "
                               f"K001's sanctioned wide-lane sites")
            self.generic_visit(node)

        def visit_keyword(self, node):
            dt = _wide_dtype(node.value)
            if node.arg == "dtype" and dt and not in_allowed():
                findings.append(Finding(
                    code=code, path=ms.rel_path,
                    line=getattr(node.value, "lineno", 0),
                    col=getattr(node.value, "col_offset", 0),
                    context=dotted_context(stack),
                    message=f"dtype={dt} outside K001's sanctioned "
                            f"wide-lane sites"))
            self.generic_visit(node)

    V().visit(ms.tree)
    return findings


@register
class WideLanesPass(LintPass):
    code = "W001"
    name = "wide-lanes"
    description = ("implicit-dtype tensor creation and unsanctioned "
                   "int64/float64 lanes in hot-path kernel modules")
    TARGETS = ("presto_tpu_torch/ops/aggregation.py",
               "presto_tpu_torch/ops/keys.py",
               "presto_tpu_torch/ops/join.py",
               "presto_tpu_torch/ops/sort.py",
               "presto_tpu_torch/ops/window.py")

    def run(self, module: ModuleSource) -> List[Finding]:
        return scan_module(module)
