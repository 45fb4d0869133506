"""R001: stale-cache-key risk in the code a cached closure keeps.

Counterpart of presto_tpu/lint/passes/retrace.py. The port's
compiled-plan cache (exec/plan_cache.py) keeps the Python closure
``compile_plan`` lowers (exec/planner.py), keyed by plan structure +
mesh + the limb form + a ``_kernel_mode()`` string built from the
registered kernel-mode env knobs. Anything ELSE the lowering reads from
ambient process state -- an unregistered env var, the clock, a random
source, a mutable module global -- is kept in the closure and served
on every cache hit: the torch counterpart of the reference's
trace-time constant folding.

Rules:

  1. ``os.environ.get/[...]`` / ``os.getenv`` reads anywhere in
     ``ops/`` and ``exec/`` must name an env var registered in
     ``exec.plan_cache.KERNEL_MODE_ENVS`` (read from there: the single
     source). A name read through a module-level string constant
     (``os.environ.get(FUSION_ENV, "1")``) is resolved to its value.
  2. In the lowering scope (``core.lowering_scope``: the body of
     ``compile_plan`` outside the closures it builds; in a file outside
     the port, a jit decorated body): ``time.*`` / ``random.*`` /
     ``np.random.*`` / ``torch.rand*`` calls -- the cached closure
     keeps one frozen sample.
  3. In the lowering scope: reads of module-level MUTABLE globals
     (names bound to dict/list/set literals at module scope) -- a later
     mutation does not re-lower the cached closure.

The closures' own bodies, and the ops/ and expr/ functions they call,
run on every dispatch, so what they read is read afresh each time.
Messages on a file outside the port are the reference's, word for word.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ..core import (PACKAGE, Finding, LintPass, ModuleSource,
                    dotted_context, lowering_scope, register)

__all__ = ["RetracePass", "kernel_mode_envs"]

_ENV_ROOTS = ("os", "_os")
_CLOCK_CALLS = {("time", "time"), ("time", "monotonic"),
                ("time", "perf_counter"), ("time", "time_ns"),
                ("random", "random"), ("random", "randint"),
                ("random", "uniform"), ("random", "choice"),
                ("random", "shuffle"), ("random", "sample")}
_TORCH_RANDOM = {"rand", "randn", "randint", "randperm", "rand_like",
                 "randn_like", "randint_like", "normal", "bernoulli",
                 "multinomial", "poisson"}


def kernel_mode_envs() -> Tuple[str, ...]:
    """The env vars the plan cache keys on: exec.plan_cache's
    KERNEL_MODE_ENVS, the single source."""
    from ...exec.plan_cache import KERNEL_MODE_ENVS
    return tuple(name for name, _default in KERNEL_MODE_ENVS)


def _mutable_module_globals(tree: ast.Module) -> Set[str]:
    out: Set[str] = set()
    for stmt in tree.body:
        if not isinstance(stmt, ast.Assign):
            continue
        v = stmt.value
        mutable = isinstance(v, (ast.Dict, ast.List, ast.Set)) or (
            isinstance(v, ast.Call) and isinstance(v.func, ast.Name)
            and v.func.id in ("dict", "list", "set"))
        if not mutable:
            continue
        for t in stmt.targets:
            if isinstance(t, ast.Name):
                out.add(t.id)
    return out


def _string_constants(tree: ast.Module) -> Dict[str, str]:
    """Module-level ``NAME = "literal"`` bindings."""
    out: Dict[str, str] = {}
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                isinstance(stmt.targets[0], ast.Name) and \
                isinstance(stmt.value, ast.Constant) and \
                isinstance(stmt.value.value, str):
            out[stmt.targets[0].id] = stmt.value.value
    return out


def _env_name(node: Optional[ast.AST],
              consts: Dict[str, str]) -> Optional[str]:
    """The env var an argument names: a literal, or a module constant."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    return None


@register
class RetracePass(LintPass):
    code = "R001"
    name = "retrace-risk"
    description = ("ambient-state reads (unkeyed env vars, clocks, "
                   "randomness, mutable globals) baked into cached "
                   "closures")
    TARGETS = ("presto_tpu_torch/ops/*.py", "presto_tpu_torch/exec/*.py")

    def run(self, ms: ModuleSource) -> List[Finding]:
        keyed = set(kernel_mode_envs())
        mutable_globals = _mutable_module_globals(ms.tree)
        consts = _string_constants(ms.tree)
        in_port = ms.rel_path.startswith(f"{PACKAGE}/")
        findings: List[Finding] = []
        stack: List[str] = []
        funcs: List[ast.AST] = []
        local_names: List[Set[str]] = []  # per-function locals/params

        def context() -> str:
            return dotted_context(stack)

        def emit(node: ast.AST, message: str) -> None:
            findings.append(ms.finding("R001", node, context(), message))

        def lowering() -> bool:
            return lowering_scope(ms.rel_path, funcs)

        def sampled(node: ast.AST, call: str) -> None:
            emit(node,
                 f"{call} is sampled once when compile_plan lowers the "
                 f"closure; the plan cache serves that one sample on "
                 f"every hit" if in_port else
                 f"{call} constant-folds at trace time; the cached "
                 f"executable replays one frozen sample forever")

        def env_read(node: ast.AST, var: Optional[str]) -> None:
            if var is not None and var in keyed:
                return  # registered kernel-mode knob: cache-keyed
            emit(node,
                 f"env read {var or '<dynamic>'!r} at trace/import time "
                 f"is invisible to the plan-cache key (register it in "
                 f"exec.plan_cache.KERNEL_MODE_ENVS or route it through "
                 f"the session)")

        def fn_locals(node) -> Set[str]:
            names: Set[str] = set()
            a = node.args
            for arg in [*a.posonlyargs, *a.args, *a.kwonlyargs,
                        *([a.vararg] if a.vararg else []),
                        *([a.kwarg] if a.kwarg else [])]:
                names.add(arg.arg)
            for sub in ast.walk(node):
                if isinstance(sub, ast.Name) and \
                        isinstance(sub.ctx, ast.Store):
                    names.add(sub.id)
            return names

        class V(ast.NodeVisitor):
            def visit_FunctionDef(self, node):
                stack.append(node.name)
                funcs.append(node)
                local_names.append(fn_locals(node))
                self.generic_visit(node)
                local_names.pop()
                funcs.pop()
                stack.pop()

            visit_AsyncFunctionDef = visit_FunctionDef

            def visit_ClassDef(self, node):
                stack.append(node.name)
                self.generic_visit(node)
                stack.pop()

            def visit_Call(self, node):
                fn = node.func
                if isinstance(fn, ast.Attribute):
                    root = fn.value
                    # rule 1: env reads must be cache-keyed
                    if fn.attr == "get" and isinstance(root, ast.Attribute) \
                            and root.attr == "environ" \
                            and isinstance(root.value, ast.Name) \
                            and root.value.id in _ENV_ROOTS:
                        env_read(node, _env_name(
                            node.args[0] if node.args else None, consts))
                    elif fn.attr == "getenv" and \
                            isinstance(root, ast.Name) and \
                            root.id in _ENV_ROOTS:
                        env_read(node, _env_name(
                            node.args[0] if node.args else None, consts))
                    # rule 2: clocks/randomness in the lowering scope
                    elif lowering() and isinstance(root, ast.Name) and \
                            (root.id, fn.attr) in _CLOCK_CALLS:
                        sampled(node, f"{root.id}.{fn.attr}()")
                    elif lowering() and isinstance(root, ast.Name) and \
                            root.id == "torch" and fn.attr in _TORCH_RANDOM:
                        sampled(node, f"torch.{fn.attr}()")
                    elif lowering() and isinstance(root, ast.Attribute) \
                            and root.attr == "random" \
                            and isinstance(root.value, ast.Name) \
                            and root.value.id in ("np", "numpy"):
                        emit(node,
                             f"np.random.{fn.attr}() is sampled once when "
                             f"compile_plan lowers the closure" if in_port
                             else f"np.random.{fn.attr}() constant-folds "
                                  f"at trace time inside a jit'd function")
                self.generic_visit(node)

            def visit_Subscript(self, node):
                # os.environ["X"] reads (rule 1)
                v = node.value
                if isinstance(node.ctx, ast.Load) and \
                        isinstance(v, ast.Attribute) and \
                        v.attr == "environ" and \
                        isinstance(v.value, ast.Name) and \
                        v.value.id in _ENV_ROOTS:
                    var = _env_name(node.slice, consts)
                    if var is None or var not in keyed:
                        emit(node,
                             f"env read {var or '<dynamic>'!r} at "
                             f"trace/import time is invisible to the "
                             f"plan-cache key")
                self.generic_visit(node)

            def visit_Name(self, node):
                # rule 3: mutable-global capture in the lowering scope
                if lowering() and isinstance(node.ctx, ast.Load) \
                        and node.id in mutable_globals \
                        and not any(node.id in ls for ls in local_names):
                    emit(node,
                         f"mutable module global {node.id!r} read when "
                         f"compile_plan lowers the closure: later "
                         f"mutations never re-lower the cached closure"
                         if in_port else
                         f"mutable module global {node.id!r} captured "
                         f"by a jit'd function: later mutations never "
                         f"retrace the cached executable")
                self.generic_visit(node)

        V().visit(ms.tree)
        return findings
