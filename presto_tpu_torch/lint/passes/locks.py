"""C001: lock discipline on shared server-tier state.

Counterpart of presto_tpu/lint/passes/locks.py over the port's files;
the port's classes carry the reference's declarations.

The coordinator/worker tier shares registries (tasks, queries, nodes,
rates, counters) across request-handler threads. Python's GIL makes
single-opcode races rare enough that the bug ships and only fires
under load -- so the discipline is declared, then enforced statically.

Declaration convention: a class lists its guarded attributes in a
class-level ``_GUARDED_BY`` dict literal::

    class TaskManager:
        _GUARDED_BY = {"_tasks_lock": ("tasks", "draining"),
                       "_counters_lock": ("counters",)}

The pass then requires every WRITE (assign / augmented assign /
``del``, including subscript writes like ``self.tasks[k] = v``) to a
guarded attribute to sit lexically inside ``with <recv>.<lock>:``
where ``<recv>`` is the same receiver the write uses (``self._state``
under ``with self._lock``, ``task.state`` under ``with task.lock``).
Receiver matching is by attribute NAME module-wide, so helper code in
the same module that mutates another object's guarded field is checked
too (the TaskManager methods mutating ``_Task`` fields).

Three further declaration forms cover the tier's other idioms:

  * **Module-level guards.** A module-level ``_GUARDED_BY`` dict maps a
    module-level lock NAME to the module-level globals it guards
    (the process-wide counter idiom: ``_SPEC`` under ``_SPEC_LOCK``)::

        _GUARDED_BY = {"_SPEC_LOCK": ("_SPEC",)}

    Writes to those globals (assign / augassign / subscript / del)
    must sit inside ``with <LOCK_NAME>:``.
  * **Shared locks.** ``_GUARDED_BY_SHARED = ("_cv",)`` on a class
    declares that every instance shares ONE lock object (the
    dispatcher's resource-group tree condition), so the write barrier
    accepts the lock held through ANY receiver (``with self._cv:``
    guarding ``root._ticket``).
  * **Caller-held locks.** The pseudo-lock ``"<caller>"`` declares a
    class whose contract is "callers hold their own lock" (the task
    lock around SpoolingOutputBuffer). Writes through ``self`` inside
    the declaring class are exempt (the contract); writes through any
    OTHER receiver must sit under SOME ``with``-held lock.

Escape hatches, all visible in the code:

  * ``__init__`` / ``__del__`` writes through ``self`` are exempt (the
    object is not yet / no longer shared).
  * functions whose name ends in ``_locked`` are exempt -- the
    caller-holds-the-lock convention (document it in the docstring).
  * reads, and mutation through method calls (``d.pop(k)``,
    ``l.append(x)``), are out of scope: the pass is a write-barrier
    checker, not an escape analysis.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ..core import (Finding, LintPass, ModuleSource, dotted_context,
                    register)
from .lock_order import CONCURRENCY_TARGETS

__all__ = ["LockDisciplinePass", "GUARDED_BY_ATTR", "CALLER_LOCK"]

GUARDED_BY_ATTR = "_GUARDED_BY"
SHARED_ATTR = "_GUARDED_BY_SHARED"
CALLER_LOCK = "<caller>"


def _str_elts(v: ast.AST) -> List[str]:
    if isinstance(v, (ast.Tuple, ast.List)):
        return [e.value for e in v.elts
                if isinstance(e, ast.Constant) and
                isinstance(e.value, str)]
    if isinstance(v, ast.Constant) and isinstance(v.value, str):
        return [v.value]
    return []


def _dict_decl(stmt: ast.stmt) -> Optional[ast.Dict]:
    """The Dict literal of `_GUARDED_BY = {...}`, else None."""
    if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and
            isinstance(stmt.targets[0], ast.Name) and
            stmt.targets[0].id == GUARDED_BY_ATTR and
            isinstance(stmt.value, ast.Dict)):
        return stmt.value
    return None


def _guarded_map(tree: ast.Module) -> Dict[str, Tuple[str, str]]:
    """module-wide {guarded_attr: (class_name, lock_attr)} from every
    class-level _GUARDED_BY dict literal."""
    out: Dict[str, Tuple[str, str]] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for stmt in node.body:
            decl = _dict_decl(stmt)
            if decl is None:
                continue
            for k, v in zip(decl.keys, decl.values):
                if not (isinstance(k, ast.Constant) and
                        isinstance(k.value, str)):
                    continue
                for a in _str_elts(v):
                    out[a] = (node.name, k.value)
    return out


def _module_guards(tree: ast.Module) -> Dict[str, str]:
    """{global_name: lock_name} from a MODULE-level _GUARDED_BY dict
    (the process-wide counter idiom: _SPEC under _SPEC_LOCK)."""
    out: Dict[str, str] = {}
    for stmt in tree.body:
        decl = _dict_decl(stmt)
        if decl is None:
            continue
        for k, v in zip(decl.keys, decl.values):
            if not (isinstance(k, ast.Constant) and
                    isinstance(k.value, str)):
                continue
            for g in _str_elts(v):
                out[g] = k.value
    return out


def _shared_locks(tree: ast.Module) -> Set[str]:
    """Lock attr names declared _GUARDED_BY_SHARED on any class: every
    instance shares ONE lock object, so holding it through ANY receiver
    satisfies the barrier."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for stmt in node.body:
            if (isinstance(stmt, ast.Assign) and
                    len(stmt.targets) == 1 and
                    isinstance(stmt.targets[0], ast.Name) and
                    stmt.targets[0].id == SHARED_ATTR):
                out.update(_str_elts(stmt.value))
    return out


def _attr_write_target(node: ast.AST) -> Optional[Tuple[str, str]]:
    """(receiver_name, attr) when ``node`` is ``<name>.<attr>`` or a
    subscript chain rooted there (``<name>.<attr>[k]``...)."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name):
        return node.value.id, node.attr
    return None


def _name_write_target(node: ast.AST) -> Optional[str]:
    """The bare global name when ``node`` is ``<name>`` or a subscript
    chain rooted there (``_SPEC["wins"] += 1`` writes ``_SPEC``)."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


@register
class LockDisciplinePass(LintPass):
    code = "C001"
    name = "lock-discipline"
    description = ("writes to _GUARDED_BY-declared attributes outside "
                   "their `with <lock>:` block")
    # same audit surface as C002/C003/C004: server tier, failpoints,
    # and the threaded exec/ modules
    TARGETS = CONCURRENCY_TARGETS

    def run(self, ms: ModuleSource) -> List[Finding]:
        guarded = _guarded_map(ms.tree)
        mod_guards = _module_guards(ms.tree)
        if not guarded and not mod_guards:
            return []
        shared = _shared_locks(ms.tree)
        findings: List[Finding] = []
        stack: List[str] = []            # class/function names
        cls_stack: List[str] = []        # enclosing class names only
        held: List[Tuple[str, str]] = []  # (receiver, lock_attr) stack
        held_names: List[str] = []       # module-level locks held
        func_depth = [0]                 # module scope writes are init
        # exemption is a property of the INNERMOST enclosing def only:
        # a closure defined inside __init__/__del__/*_locked runs later
        # (thread target, callback) when the object IS shared / the
        # lock is NOT held, so it must not inherit the exemption
        exempt_stack: List[bool] = []

        def context() -> str:
            return dotted_context(stack)

        def exempt_scope() -> bool:
            return bool(exempt_stack) and exempt_stack[-1]

        def check_target(t: ast.AST, stmt: ast.AST) -> None:
            gname = _name_write_target(t)
            if gname is not None and gname in mod_guards and \
                    func_depth[0] > 0 and not exempt_scope():
                lock = mod_guards[gname]
                if lock not in held_names:
                    findings.append(ms.finding(
                        "C001", stmt, context(),
                        f"write to module global {gname!r} (guarded by "
                        f"{lock}) outside `with {lock}:`"))
                return
            rt = _attr_write_target(t)
            if rt is None:
                return
            recv, attr = rt
            if attr not in guarded:
                return
            cls, lock = guarded[attr]
            if exempt_scope():
                return
            if lock == CALLER_LOCK:
                # the contract: callers hold THEIR lock. Inside the
                # declaring class `self` writes are the contract body;
                # foreign receivers must sit under SOME held lock.
                if recv == "self" and cls in cls_stack:
                    return
                if held or held_names:
                    return
                findings.append(ms.finding(
                    "C001", stmt, context(),
                    f"write to {attr!r} ({cls} is caller-locked) with "
                    f"no lock held -- callers must hold their own lock"))
                return
            if (recv, lock) in held:
                return
            if lock in shared and any(lk == lock for _, lk in held):
                return  # one lock object per tree: any receiver works
            findings.append(ms.finding(
                "C001", stmt, context(),
                f"write to {attr!r} (guarded by {cls}.{lock}) outside "
                f"`with {recv}.{lock}:`"))

        class V(ast.NodeVisitor):
            def visit_FunctionDef(self, node):
                stack.append(node.name)
                func_depth[0] += 1
                exempt_stack.append(
                    node.name in ("__init__", "__post_init__",
                                  "__del__") or
                    node.name.endswith("_locked"))
                # a nested def's body runs LATER (callback, thread
                # target): locks held at the def site are not held at
                # call time, so the held stack must not leak in
                saved = held[:]
                saved_names = held_names[:]
                del held[:]
                del held_names[:]
                self.generic_visit(node)
                held[:] = saved
                held_names[:] = saved_names
                exempt_stack.pop()
                func_depth[0] -= 1
                stack.pop()

            visit_AsyncFunctionDef = visit_FunctionDef

            def visit_ClassDef(self, node):
                stack.append(node.name)
                cls_stack.append(node.name)
                self.generic_visit(node)
                cls_stack.pop()
                stack.pop()

            def visit_With(self, node):
                pushed = 0
                pushed_names = 0
                for item in node.items:
                    ce = item.context_expr
                    if isinstance(ce, ast.Attribute) and \
                            isinstance(ce.value, ast.Name):
                        held.append((ce.value.id, ce.attr))
                        pushed += 1
                    elif isinstance(ce, ast.Name):
                        held_names.append(ce.id)
                        pushed_names += 1
                self.generic_visit(node)
                del held[len(held) - pushed:]
                del held_names[len(held_names) - pushed_names:]

            def visit_Assign(self, node):
                for t in node.targets:
                    for sub in ([t.elts] if isinstance(
                            t, (ast.Tuple, ast.List)) else [[t]])[0]:
                        check_target(sub, node)
                self.generic_visit(node)

            def visit_AugAssign(self, node):
                check_target(node.target, node)
                self.generic_visit(node)

            def visit_AnnAssign(self, node):
                if node.value is not None:
                    check_target(node.target, node)
                self.generic_visit(node)

            def visit_Delete(self, node):
                for t in node.targets:
                    check_target(t, node)
                self.generic_visit(node)

        V().visit(ms.tree)
        return findings
