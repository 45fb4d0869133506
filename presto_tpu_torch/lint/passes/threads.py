"""C004: thread lifecycle discipline in the server tier.

Counterpart of presto_tpu/lint/passes/threads.py over the port's files.

A worker that "stopped" but left a live non-daemon thread holds the
process open; a service loop without a stop flag spins forever after
``stop()`` and keeps touching freed state. The tier's convention is
explicit and this pass enforces it:

  * every ``threading.Thread`` created in server code is either
    ``daemon=True`` or joined on the stop path: a thread bound to
    ``self.<attr>`` must have a ``<recv>.<attr>.join(...)`` somewhere
    in the module; a thread bound to a local must be joined (or
    daemon-flagged) in the same function; an anonymous
    ``Thread(...).start()`` must be daemon.
  * every ``while True:`` loop inside a thread-TARGET function (any
    function named by a ``target=`` in the module) must consult a stop
    signal: a name/attribute matching the stop vocabulary
    (stop/shutdown/close/drain/exit/quit/running/done) or an
    ``Event.is_set()``/``Event.wait()`` test. Loops spelled ``while
    not self._stop.is_set():`` pass by construction; retry loops in
    non-target functions are out of scope.

Leaks found in real code get fixed, not baselined -- a flag and a
``join`` are always small diffs.
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional, Set, Tuple

from ..core import (Finding, LintPass, ModuleSource, dotted_context,
                    register)
from .lock_order import CONCURRENCY_TARGETS

__all__ = ["ThreadLifecyclePass"]

_STOP_RE = re.compile(
    r"stop|shutdown|clos(?:e|ed|ing)|drain|exit|quit|running|done|alive",
    re.IGNORECASE)


def _is_thread_ctor(call: ast.Call) -> bool:
    fn = call.func
    if isinstance(fn, ast.Attribute) and fn.attr == "Thread":
        return True
    return isinstance(fn, ast.Name) and fn.id == "Thread"


def _daemon_kw(call: ast.Call) -> Optional[bool]:
    """True/False when daemon= is a literal; None when absent (a
    non-literal daemon= counts as handled -- dynamic policy)."""
    for kw in call.keywords:
        if kw.arg == "daemon":
            if isinstance(kw.value, ast.Constant):
                return bool(kw.value.value)
            return True
    return None


def _target_names(tree: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _is_thread_ctor(node):
            for kw in node.keywords:
                if kw.arg == "target":
                    t = kw.value
                    if isinstance(t, ast.Attribute):
                        out.add(t.attr)
                    elif isinstance(t, ast.Name):
                        out.add(t.id)
    return out


def _attr_joins(tree: ast.AST) -> Set[str]:
    """Attribute names X for which some `<recv>.X.join(...)` exists."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "join" and \
                isinstance(node.func.value, ast.Attribute):
            out.add(node.func.value.attr)
    return out


def _local_handled(fn_node: ast.AST, var: str) -> bool:
    """`var.join(...)` or `var.daemon = True` in the same function."""
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "join" and \
                isinstance(node.func.value, ast.Name) and \
                node.func.value.id == var:
            return True
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Attribute) and t.attr == "daemon" \
                        and isinstance(t.value, ast.Name) and \
                        t.value.id == var:
                    return True
    return False


def _loop_has_stop_check(loop: ast.While) -> bool:
    for node in ast.walk(loop):
        if isinstance(node, ast.Attribute) and _STOP_RE.search(node.attr):
            return True
        if isinstance(node, ast.Name) and _STOP_RE.search(node.id):
            return True
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in ("is_set", "wait"):
            return True
    return False


@register
class ThreadLifecyclePass(LintPass):
    code = "C004"
    name = "thread-lifecycle"
    description = ("threads that are neither daemon nor joined-on-stop; "
                   "`while True` service loops without a stop flag")
    TARGETS = CONCURRENCY_TARGETS

    def run(self, ms: ModuleSource) -> List[Finding]:
        findings: List[Finding] = []
        targets = _target_names(ms.tree)
        joined_attrs = _attr_joins(ms.tree)
        stack: List[str] = []

        pass_self = self

        class V(ast.NodeVisitor):
            def _ctx(self) -> str:
                return dotted_context(stack)

            def visit_ClassDef(self, node):
                stack.append(node.name)
                self.generic_visit(node)
                stack.pop()

            def visit_FunctionDef(self, node):
                stack.append(node.name)
                # service loops: only functions spawned as thread
                # targets are service loops
                if node.name in targets:
                    for sub in ast.walk(node):
                        if isinstance(sub, ast.While) and \
                                isinstance(sub.test, ast.Constant) and \
                                sub.test.value is True and \
                                not _loop_has_stop_check(sub):
                            findings.append(ms.finding(
                                "C004", sub, self._ctx(),
                                "`while True` service loop in thread "
                                "target without a stop-flag check -- "
                                "the loop survives stop()"))
                # thread creations in this function
                for sub in ast.walk(node):
                    if not (isinstance(sub, ast.Call) and
                            _is_thread_ctor(sub)):
                        continue
                    if _daemon_kw(sub):
                        continue
                    handled, how = pass_self._creation_handled(
                        node, sub, joined_attrs)
                    if not handled:
                        findings.append(ms.finding(
                            "C004", sub, self._ctx(),
                            f"Thread is neither daemon=True nor "
                            f"joined on the stop path ({how}) -- a "
                            f"leaked non-daemon thread outlives "
                            f"stop() and pins the process"))
                self.generic_visit(node)
                stack.pop()

            visit_AsyncFunctionDef = visit_FunctionDef

        V().visit(ms.tree)
        return findings

    @staticmethod
    def _creation_handled(fn_node: ast.AST, call: ast.Call,
                          joined_attrs: Set[str]) -> Tuple[bool, str]:
        """Is this non-daemon Thread(...) joined somewhere visible?"""
        # find the assignment statement binding this call, if any
        for node in ast.walk(fn_node):
            if isinstance(node, ast.Assign) and node.value is call:
                t = node.targets[0]
                if isinstance(t, ast.Attribute):
                    if t.attr in joined_attrs:
                        return True, ""
                    return False, f"self.{t.attr} is never .join()ed"
                if isinstance(t, ast.Name):
                    if _local_handled(fn_node, t.id):
                        return True, ""
                    return False, (f"local {t.id!r} is neither joined "
                                   f"nor daemon-flagged here")
        return False, "anonymous Thread(...) -- unjoinable"
