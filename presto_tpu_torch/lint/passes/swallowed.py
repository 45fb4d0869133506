"""S001: swallowed errors in server-tier request handlers.

Counterpart of presto_tpu/lint/passes/swallowed.py over the port's
``server/`` and ``failpoints/``; the port's counter is the same
``presto_tpu_suppressed_errors_total`` (server/metrics.py).

A coordinator/worker handler that catches ``Exception`` and does
NOTHING converts every future bug in that path into silent data loss:
the announcement that never lands, the task abort that never happens,
the trace span that never ships -- all invisible until an operator
asks why the cluster view is stale. The server tier's contract
(PR 1's observability work) is that suppressed failures are at least
*counted*: ``server.metrics.record_suppressed()`` logs the exception
and exports a ``presto_tpu_suppressed_errors_total`` counter per
(component, site) on ``/v1/metrics``.

Flagged:

  * bare ``except:`` and ``except BaseException:`` anywhere in
    ``server/`` -- they also swallow ``KeyboardInterrupt`` /
    ``SystemExit``, which no handler here means to do;
  * ``except Exception:`` whose body is pure filler (``pass``, ``...``,
    ``continue``, bare docstring) -- no log, no counter, no re-raise,
    no value returned for the caller to observe.

NOT flagged: handlers that return a value (``return False`` -- the
caller observes the outcome), re-raise, assign state, or call anything
(logging, ``record_suppressed``, cleanup). Sites that must stay
genuinely silent (``__del__`` during interpreter teardown) carry an
inline ``# tpulint: disable=S001`` with the reason beside it.
"""

from __future__ import annotations

import ast
from typing import List

from ..core import (Finding, LintPass, ModuleSource, dotted_context,
                    register)

__all__ = ["SwallowedErrorsPass"]

_BROAD = ("Exception",)
_FORBIDDEN = ("BaseException",)


def _type_names(node) -> List[str]:
    """Exception-type names named by an except clause."""
    if node is None:
        return []
    items = node.elts if isinstance(node, ast.Tuple) else [node]
    out = []
    for it in items:
        if isinstance(it, ast.Name):
            out.append(it.id)
        elif isinstance(it, ast.Attribute):
            out.append(it.attr)
    return out


def _is_filler(stmt: ast.stmt) -> bool:
    if isinstance(stmt, (ast.Pass, ast.Continue, ast.Break)):
        return True
    if isinstance(stmt, ast.Return) and stmt.value is None:
        # bare `return` is indistinguishable from normal completion at
        # the call site -- silent; `return <value>` is an observable
        # outcome and counts as handling
        return True
    if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant):
        return True  # ellipsis or stray docstring
    return False


@register
class SwallowedErrorsPass(LintPass):
    code = "S001"
    name = "swallowed-errors"
    description = ("bare/overbroad excepts whose body neither logs, "
                   "counts, re-raises, nor returns a value")
    TARGETS = ("presto_tpu_torch/server/*.py",
               "presto_tpu_torch/failpoints/*.py")

    def run(self, ms: ModuleSource) -> List[Finding]:
        findings: List[Finding] = []
        stack: List[str] = []

        def context() -> str:
            return dotted_context(stack)

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

            def visit_ExceptHandler(self, node):
                names = _type_names(node.type)
                if node.type is None or any(n in _FORBIDDEN
                                            for n in names):
                    findings.append(ms.finding(
                        "S001", node, context(),
                        "bare except swallows KeyboardInterrupt/"
                        "SystemExit too -- catch Exception (and count "
                        "it: server.metrics.record_suppressed)"))
                elif any(n in _BROAD for n in names) and \
                        all(_is_filler(s) for s in node.body):
                    findings.append(ms.finding(
                        "S001", node, context(),
                        "swallowed exception: log + count it "
                        "(server.metrics.record_suppressed) or "
                        "re-raise"))
                self.generic_visit(node)

        V().visit(ms.tree)
        return findings
