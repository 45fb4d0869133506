"""allocguard host tier: M001/M002/M003 allocation-discipline passes.

Counterpart of presto_tpu/lint/passes/alloc.py over the port's files,
with the reference's rules and messages. The port stages relations
through numpy on the host before they are copied to the card, so the
host-tier discipline is the same.

The host tier stages relations through numpy before anything reaches
the device, and nothing in the type system distinguishes "a few page
headers" from "the whole fact table": a list appended per row, a
``np.concatenate`` over every split, or a cast-then-pad-then-transfer
chain each allocate silently and only fail at SF100. These passes make
the discipline declarative, the way C001 does for locks:

  * **M001 unbounded accumulation.** A list/dict/set/bytes local that
    grows inside a loop whose bound is DATA-dependent (splits, pages,
    rows, batches, chunks, records) with no visible bound: no
    ``MemoryPool.reserve`` in the function, no ``len(acc)`` cap check,
    and no ``_BOUNDED_BY`` declaration. The declaration mirrors C001's
    ``_GUARDED_BY``: a dict literal naming each accumulator and the
    invariant that bounds it, reviewable at the accumulation site::

        _BOUNDED_BY = {"flat": "rows <= page capacity (serialize_page"
                               " is called per staged batch)"}

    Module-level declarations cover a module's named idiom; a
    function-level ``_BOUNDED_BY = {...}`` statement scopes tighter.
    Generators are exempt (yielding per iteration IS the streaming
    seam), as are functions that reserve against the pool.
  * **M002 unreserved materialization.** Full-relation materializers
    (``np.concatenate/stack/vstack/hstack``, ``.tolist()``, argless
    ``.read()``) on call paths reachable from ``run_query`` with no
    pool reservation or streaming/spill seam between them and the
    entry. The call graph is name-resolved the same conservative way
    lint/lockmodel.py resolves lock edges; a function that calls
    ``.reserve(...)``, yields, or hands off to the spill tier seals
    its subtree (everything below allocates against accounted memory).
  * **M003 copy amplification.** The same host array copied >= 2x
    across a staging chain -- ``asarray(x, dtype)`` -> ``astype`` ->
    ``pad`` -- where one fused conversion (allocate at the target
    dtype/shape once) suffices. Chains are tracked through nested call
    spines, through single-assignment locals, and through module-local
    copy WRAPPERS (a helper whose body returns a copy-op of its first
    parameter, e.g. block.py's ``_pad``). ``.copy()`` is deliberately
    out of scope: an explicit copy is a statement of intent (the
    buffer is mutated after), not an accident.

Findings are fixed or declared, never baselined: the gate ships with
``presto_tpu_torch/lint/baseline.json`` EMPTY.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..core import (REPO, Finding, LintPass, ModuleSource, dotted_context,
                    register)

__all__ = ["AccumulationPass", "MaterializationPass", "CopyAmpPass",
           "BOUNDED_BY_ATTR", "ALLOC_TARGETS"]

BOUNDED_BY_ATTR = "_BOUNDED_BY"

# the host-allocation audit surface: everything that touches numpy
# buffers between a connector and the device boundary
ALLOC_TARGETS = (
    "presto_tpu_torch/exec/*.py",
    "presto_tpu_torch/ops/*.py",
    "presto_tpu_torch/connectors/*.py",
    "presto_tpu_torch/serde/*.py",
    "presto_tpu_torch/server/*.py",
)

# staging-chain surface for M003: host-side conversion code only (ops/
# excluded -- its casts are tensor ops inside a lowered closure, and
# server/ handles serialized bytes, not arrays)
STAGING_TARGETS = (
    "presto_tpu_torch/block.py",
    "presto_tpu_torch/exec/*.py",
    "presto_tpu_torch/connectors/*.py",
    "presto_tpu_torch/serde/*.py",
)

# substrings that mark a loop's bound as DATA-dependent: iterating
# splits/pages/rows/batches scales with the relation, not the plan
_DATA_BOUND_WORDS = ("split", "page", "row", "batch", "chunk", "record")

_NUMPY_ROOTS = ("np", "numpy")


def _walk_shallow(fn: ast.AST):
    """SOURCE-ORDER walk of a function's body without descending into
    nested defs -- their bodies execute in their own scope (and get
    their own visit), so accumulators/chains must not leak across the
    boundary. Pre-order DFS in field order so assignment-dataflow
    consumers (M003) see definitions before uses."""
    for child in ast.iter_child_nodes(fn):
        yield child
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
            continue
        yield from _walk_shallow(child)


def _render(node: ast.AST) -> str:
    """Best-effort dotted rendering of an expression for bound-word
    matching ('self.splits', 'range(num_rows)')."""
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - unparse is total on 3.9+
        return ""


def _bound_text(node: ast.AST) -> str:
    """The name(s) that determine a loop's trip count, with
    known-bounded spellings stripped: ``range(md.num_row_groups)``
    counts METADATA (row groups, not rows), ``value.split(",")`` is
    bounded by one string, ``batch.num_columns`` by the schema."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Subscript):
        return _bound_text(node.value)
    if isinstance(node, ast.BoolOp):
        return " ".join(_bound_text(v) for v in node.values)
    if isinstance(node, ast.Call):
        f = node.func
        fname = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else "")
        if fname in ("split", "rsplit", "splitlines"):
            return ""  # str.split: one string's worth, not a relation
        if fname in ("items", "keys", "values") and \
                isinstance(f, ast.Attribute):
            return _bound_text(f.value)
        if fname in ("range", "enumerate", "zip", "sorted", "reversed",
                     "list", "tuple", "set", "dict", "get", "min",
                     "max"):
            return " ".join(_bound_text(a) for a in node.args)
        return " ".join([fname] + [_bound_text(a) for a in node.args])
    return _render(node)


def _is_data_bounded(iter_node: ast.AST) -> Optional[str]:
    """The data-ish name that bounds a ``for`` iterable, or None when
    the trip count is plan-shaped (constants, schema fields, axes)."""
    text = _bound_text(iter_node).lower()
    text = text.replace("row_group", "").replace("rowgroup", "")
    for w in _DATA_BOUND_WORDS:
        if w in text:
            return w
    return None


def _bounded_decls(body: Sequence[ast.stmt]) -> Set[str]:
    """Accumulator names a ``_BOUNDED_BY = {...}`` dict literal in this
    body declares bounded (values are the human-readable invariants)."""
    out: Set[str] = set()
    for stmt in body:
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and
                isinstance(stmt.targets[0], ast.Name) and
                stmt.targets[0].id == BOUNDED_BY_ATTR and
                isinstance(stmt.value, ast.Dict)):
            for k in stmt.value.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    out.add(k.value)
    return out


def _empty_accumulator_kind(v: ast.AST) -> Optional[str]:
    """'list'/'dict'/'set'/'bytes' when ``v`` initializes an EMPTY
    growable container (the accumulator idiom), else None."""
    if isinstance(v, ast.List) and not v.elts:
        return "list"
    if isinstance(v, ast.Dict) and not v.keys:
        return "dict"
    if isinstance(v, ast.Call) and isinstance(v.func, ast.Name) and \
            not v.args and not v.keywords:
        if v.func.id in ("list", "dict", "set", "bytearray"):
            return "bytes" if v.func.id == "bytearray" else v.func.id
    if isinstance(v, ast.Constant) and v.value == b"":
        return "bytes"
    return None


def _has_reserve_call(fn: ast.AST) -> bool:
    """True when the function body calls ``<anything>.reserve(...)`` --
    the MemoryPool accounting seam (memory.reserve failpoint rides the
    same spelling, so chaos coverage comes along)."""
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Call) and \
                isinstance(sub.func, ast.Attribute) and \
                sub.func.attr == "reserve":
            return True
    return False


def _is_generator(fn: ast.AST) -> bool:
    for sub in ast.walk(fn):
        if isinstance(sub, (ast.Yield, ast.YieldFrom)):
            # nested defs' yields don't make the OUTER fn a generator,
            # but the over-approximation is safe (exemption, not
            # finding) and nested generators are absent from the tier
            return True
    return False


def _len_capped_names(fn: ast.AST) -> Set[str]:
    """Names whose ``len(...)`` appears inside a comparison in this
    function: ``if len(acc) >= cap: flush()`` is a visible bound."""
    out: Set[str] = set()
    for sub in ast.walk(fn):
        if not isinstance(sub, ast.Compare):
            continue
        for piece in [sub.left, *sub.comparators]:
            if isinstance(piece, ast.Call) and \
                    isinstance(piece.func, ast.Name) and \
                    piece.func.id == "len" and piece.args and \
                    isinstance(piece.args[0], ast.Name):
                out.add(piece.args[0].id)
    return out


@register
class AccumulationPass(LintPass):
    code = "M001"
    name = "unbounded-accumulation"
    description = ("containers growing in data-bounded loops without a "
                   "cap, MemoryPool.reserve, or _BOUNDED_BY declaration")
    TARGETS = ALLOC_TARGETS

    def run(self, ms: ModuleSource) -> List[Finding]:
        module_bounded = _bounded_decls(ms.tree.body)
        findings: List[Finding] = []
        stack: List[str] = []

        def walk_function(fn: ast.AST) -> None:
            if _has_reserve_call(fn) or _is_generator(fn):
                return
            bounded = module_bounded | _bounded_decls(fn.body)
            capped = _len_capped_names(fn)
            # locals initialized empty in THIS function body
            accs: Dict[str, str] = {}
            for sub in _walk_shallow(fn):
                if isinstance(sub, ast.Assign) and \
                        len(sub.targets) == 1 and \
                        isinstance(sub.targets[0], ast.Name):
                    kind = _empty_accumulator_kind(sub.value)
                    if kind:
                        accs[sub.targets[0].id] = kind
            if not accs:
                return
            def grow_target(node: ast.AST) -> Optional[str]:
                """Accumulator name this statement grows, or None."""
                if isinstance(node, ast.Expr) and \
                        isinstance(node.value, ast.Call) and \
                        isinstance(node.value.func, ast.Attribute) and \
                        isinstance(node.value.func.value, ast.Name) and \
                        node.value.func.attr in ("append", "extend",
                                                 "update", "add",
                                                 "appendleft"):
                    return node.value.func.value.id
                if isinstance(node, ast.AugAssign) and \
                        isinstance(node.target, ast.Name):
                    return node.target.id
                if isinstance(node, ast.Assign) and \
                        len(node.targets) == 1 and \
                        isinstance(node.targets[0], ast.Subscript) and \
                        isinstance(node.targets[0].value, ast.Name):
                    return node.targets[0].value.id
                return None

            # the bound that matters is the INNERMOST enclosing loop's:
            # a per-row scratch list reset each outer iteration and
            # grown per COLUMN is schema-bounded, not data-bounded
            loop_bounds: List[Optional[str]] = []

            def check(node: ast.AST) -> None:
                bound = loop_bounds[-1] if loop_bounds else None
                if bound is None:
                    return
                name = grow_target(node)
                if name is None or name not in accs:
                    return
                if name in bounded or name in capped:
                    return
                findings.append(ms.finding(
                    "M001", node, dotted_context(stack),
                    f"{accs[name]} {name!r} grows in a loop bounded "
                    f"by data ({bound!r}) with no cap, "
                    f"MemoryPool.reserve, or {BOUNDED_BY_ATTR} "
                    f"declaration -- unbounded host accumulation"))

            class L(ast.NodeVisitor):
                def visit_For(self, node):
                    loop_bounds.append(_is_data_bounded(node.iter))
                    self.generic_visit(node)
                    loop_bounds.pop()

                def visit_While(self, node):
                    loop_bounds.append(_is_data_bounded(node.test))
                    self.generic_visit(node)
                    loop_bounds.pop()

                def visit_Expr(self, node):
                    check(node)
                    self.generic_visit(node)

                def visit_AugAssign(self, node):
                    check(node)
                    self.generic_visit(node)

                def visit_Assign(self, node):
                    check(node)
                    self.generic_visit(node)

                def visit_FunctionDef(self, node):
                    return  # nested scope: its own visit

                visit_AsyncFunctionDef = visit_FunctionDef

                def visit_ClassDef(self, node):
                    return

                def visit_Lambda(self, node):
                    return

            L().visit(ast.Module(body=list(fn.body), type_ignores=[]))

        class V(ast.NodeVisitor):
            def visit_FunctionDef(self, node):
                stack.append(node.name)
                walk_function(node)
                self.generic_visit(node)
                stack.pop()

            visit_AsyncFunctionDef = visit_FunctionDef

            def visit_ClassDef(self, node):
                stack.append(node.name)
                self.generic_visit(node)
                stack.pop()

        V().visit(ms.tree)
        return findings


# ---------------------------------------------------------------------------
# M002: unreserved materialization on run_query-reachable paths
# ---------------------------------------------------------------------------

# full-relation materializers: each allocates O(relation) host bytes in
# one call (np.asarray is deliberately absent -- staging a single
# COLUMN through asarray is the accounted per-batch path; gluing whole
# relations back together is what must sit under a reservation)
_MATERIALIZERS = {"concatenate", "stack", "vstack", "hstack",
                  "column_stack", "row_stack"}

# method names owned by builtin collections -- same guard lockmodel
# uses: binding every `.get()` call edge program-wide invents paths
_COMMON_METHODS = {
    "get", "put", "pop", "append", "add", "update", "items", "keys",
    "values", "join", "split", "strip", "read", "write", "close",
    "open", "flush", "start", "wait", "set", "info", "send", "recv",
    "encode", "decode", "format", "count", "index", "copy", "clear",
    "extend", "insert", "sort", "remove", "discard", "setdefault",
}


class _FuncFacts:
    """Per-function facts M002 needs: call edges out, materialization
    sites, and whether the function seals its subtree."""

    __slots__ = ("rel_path", "qualname", "name", "calls", "sites",
                 "sealed", "node_line")

    def __init__(self, rel_path: str, qualname: str, name: str):
        self.rel_path = rel_path
        self.qualname = qualname
        self.name = name
        self.calls: List[str] = []          # callee bare names
        self.sites: List[Tuple[int, int, str]] = []  # line, col, what
        self.sealed = False
        self.node_line = 0


def _seam_name(name: str) -> bool:
    low = name.lower()
    return "spill" in low or "stream" in low


def _extract_funcs(ms: ModuleSource) -> List[_FuncFacts]:
    out: List[_FuncFacts] = []
    stack: List[str] = []

    def scan(fn: ast.AST, facts: _FuncFacts) -> None:
        facts.sealed = _has_reserve_call(fn) or _is_generator(fn) or \
            _seam_name(facts.name)
        for sub in _walk_shallow(fn):
            if not isinstance(sub, ast.Call):
                continue
            f = sub.func
            if isinstance(f, ast.Attribute):
                recv = f.value
                if isinstance(recv, ast.Name) and \
                        recv.id in _NUMPY_ROOTS and \
                        f.attr in _MATERIALIZERS:
                    facts.sites.append((sub.lineno, sub.col_offset,
                                        f"np.{f.attr}"))
                elif f.attr == "tolist" and not sub.args:
                    facts.sites.append((sub.lineno, sub.col_offset,
                                        ".tolist()"))
                elif f.attr == "read" and not sub.args and \
                        not sub.keywords:
                    facts.sites.append((sub.lineno, sub.col_offset,
                                        "whole-file .read()"))
                if f.attr not in _COMMON_METHODS:
                    facts.calls.append(f.attr)
                if _seam_name(f.attr):
                    facts.sealed = True
            elif isinstance(f, ast.Name):
                facts.calls.append(f.id)
                if _seam_name(f.id):
                    facts.sealed = True

    class V(ast.NodeVisitor):
        def visit_FunctionDef(self, node):
            stack.append(node.name)
            facts = _FuncFacts(ms.rel_path, ".".join(stack), node.name)
            facts.node_line = node.lineno
            scan(node, facts)
            out.append(facts)
            self.generic_visit(node)
            stack.pop()

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_ClassDef(self, node):
            stack.append(node.name)
            self.generic_visit(node)
            stack.pop()

    V().visit(ms.tree)
    return out


_M002_CACHE: Dict[tuple, Dict[str, List[Finding]]] = {}


def _m002_analyze(sources: Sequence[ModuleSource]
                  ) -> Dict[str, List[Finding]]:
    """BFS from every ``run_query`` definition through the name-resolved
    call graph; materialization sites inside unsealed reachable
    functions are findings, grouped per rel_path."""
    funcs: List[_FuncFacts] = []
    for ms in sources:
        funcs.extend(_extract_funcs(ms))
    by_name: Dict[str, List[_FuncFacts]] = {}
    for f in funcs:
        by_name.setdefault(f.name, []).append(f)

    roots = by_name.get("run_query", [])
    visited: Set[int] = set()
    frontier = [f for f in roots]
    for f in frontier:
        visited.add(id(f))
    reach_via: Dict[int, str] = {id(f): f.name for f in frontier}
    while frontier:
        nxt: List[_FuncFacts] = []
        for f in frontier:
            if f.sealed and f.name != "run_query":
                continue  # reservation / streaming seam seals below
            for callee in f.calls:
                # conservative name resolution, lockmodel-style: a
                # unique definition program-wide binds; ambiguity
                # binds nothing (missed edge beats fictional path)
                cands = by_name.get(callee, [])
                if len(cands) != 1:
                    continue
                g = cands[0]
                if id(g) in visited:
                    continue
                visited.add(id(g))
                reach_via[id(g)] = f.qualname
                nxt.append(g)
        frontier = nxt

    out: Dict[str, List[Finding]] = {}
    for f in funcs:
        if id(f) not in visited or f.sealed:
            continue
        for line, col, what in f.sites:
            out.setdefault(f.rel_path, []).append(Finding(
                code="M002", path=f.rel_path, line=line, col=col,
                context=dotted_context(f.qualname.split(".")),
                message=(f"{what} materializes a full relation on a "
                         f"run_query-reachable path (via "
                         f"{reach_via[id(f)]}) with no MemoryPool "
                         f"reservation or streaming/spill seam "
                         f"in scope")))
    return out


def _m002_program(files: List[str], repo: str = REPO
                  ) -> Dict[str, List[Finding]]:
    key_parts = []
    for rel in sorted(set(files)):
        ap = os.path.join(repo, rel)
        try:
            key_parts.append((rel, os.path.getmtime(ap)))
        except OSError:
            key_parts.append((rel, 0.0))
    key = (repo, tuple(key_parts))
    cached = _M002_CACHE.get(key)
    if cached is None:
        sources = [ModuleSource(rel, repo) for rel in sorted(set(files))]
        cached = _m002_analyze(sources)
        _M002_CACHE.clear()  # one live entry; edits invalidate
        _M002_CACHE[key] = cached
    return cached


@register
class MaterializationPass(LintPass):
    code = "M002"
    name = "unreserved-materialization"
    description = ("full-relation materialization on run_query-reachable "
                   "paths without a pool reservation or streaming seam")
    TARGETS = ALLOC_TARGETS

    def run(self, ms: ModuleSource) -> List[Finding]:
        targets = self.target_files()
        if ms.rel_path in targets:
            per_file = _m002_program(targets)
            return list(per_file.get(ms.rel_path, []))
        # standalone file (fixture corpus): self-contained call graph
        return list(_m002_analyze([ms]).get(ms.rel_path, []))


# ---------------------------------------------------------------------------
# M003: copy amplification across staging chains
# ---------------------------------------------------------------------------

# host copy operations: each allocates a fresh buffer the size of its
# input. np.asarray only copies when handed a dtype; .copy() is
# deliberately excluded (explicit copies document a mutation that
# follows). The transfer to the card -- torch.as_tensor /
# torch.from_numpy in the port, jnp.asarray / device_put in the
# reference -- is the TRANSFER terminal, not a host copy: it doesn't
# count toward the chain but doesn't break it.
_COPY_FUNCS = {"array", "pad", "ascontiguousarray", "require", "repeat",
               "tile"}
_COPY_METHODS = {"astype"}
_PASS_THROUGH = ("asarray", "device_put", "as_tensor", "from_numpy")


def _copy_wrappers(tree: ast.Module) -> Set[str]:
    """Module functions whose body RETURNS a copy-op applied to their
    first parameter (block.py's ``_pad``): calling one is a copy."""
    out: Set[str] = set()
    for node in tree.body:
        if not isinstance(node, ast.FunctionDef) or not node.args.args:
            continue
        first = node.args.args[0].arg
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Return) or sub.value is None:
                continue
            for call in ast.walk(sub.value):
                if isinstance(call, ast.Call) and \
                        _copy_call_kind(call, set()) is not None and \
                        any(isinstance(a, ast.Name) and a.id == first
                            for a in ast.walk(call)):
                    out.add(node.name)
    return out


def _copy_call_kind(call: ast.Call, wrappers: Set[str]
                    ) -> Optional[Tuple[str, ast.AST]]:
    """(op label, subject expr) when ``call`` is a host copy op."""
    f = call.func
    if isinstance(f, ast.Attribute):
        recv = f.value
        if isinstance(recv, ast.Name) and recv.id in _NUMPY_ROOTS:
            if f.attr in _COPY_FUNCS and call.args:
                return (f"np.{f.attr}", call.args[0])
            if f.attr == "asarray" and call.args and (
                    len(call.args) > 1 or
                    any(k.arg == "dtype" for k in call.keywords)):
                return ("np.asarray(dtype=...)", call.args[0])
        if f.attr in _COPY_METHODS:
            return (f".{f.attr}()", recv)
    elif isinstance(f, ast.Name) and f.id in wrappers and call.args:
        return (f"{f.id}()", call.args[0])
    return None


@register
class CopyAmpPass(LintPass):
    code = "M003"
    name = "copy-amplification"
    description = ("the same host array copied >=2x across a staging "
                   "chain where one fused conversion suffices")
    TARGETS = STAGING_TARGETS

    def run(self, ms: ModuleSource) -> List[Finding]:
        wrappers = _copy_wrappers(ms.tree)
        findings: List[Finding] = []
        stack: List[str] = []

        def walk_function(fn: ast.AST) -> None:
            # chain length already accumulated into each local name:
            # v = np.asarray(x, dtype) -> chains['v'] = 1
            chains: Dict[str, Tuple[int, List[str]]] = {}
            reported: Set[int] = set()
            # chains only flow through SINGLE-USE locals: a var read
            # more than once is a shared intermediate (hi/lo both built
            # from one asarray), not an accidental re-copy
            loads: Dict[str, int] = {}
            for sub in _walk_shallow(fn):
                if isinstance(sub, ast.Name) and \
                        isinstance(sub.ctx, ast.Load):
                    loads[sub.id] = loads.get(sub.id, 0) + 1

            def chain_of(expr: ast.AST) -> Tuple[int, List[str]]:
                if isinstance(expr, ast.Name):
                    if loads.get(expr.id, 0) != 1:
                        return (0, [])
                    return chains.get(expr.id, (0, []))
                if isinstance(expr, ast.Call):
                    kind = _copy_call_kind(expr, wrappers)
                    if kind is not None:
                        op, subject = kind
                        n, ops = chain_of(subject)
                        return (n + 1, ops + [op])
                    # transparent pass-throughs keep the chain alive:
                    # asarray w/o dtype and the transfer terminals
                    f = expr.func
                    if isinstance(f, ast.Attribute) and expr.args and \
                            f.attr in _PASS_THROUGH:
                        return chain_of(expr.args[0])
                return (0, [])

            def note(call: ast.Call) -> None:
                n, ops = chain_of(call)
                if n >= 2 and id(call) not in reported:
                    # report at the OUTERMOST copy of the chain; mark
                    # the inner spine so nesting reports once
                    for sub in ast.walk(call):
                        reported.add(id(sub))
                    findings.append(ms.finding(
                        "M003", call, dotted_context(stack),
                        f"array copied {n}x across a staging chain "
                        f"({' -> '.join(ops)}) -- fuse into one "
                        f"conversion (allocate at the target "
                        f"dtype/shape once)"))

            for sub in _walk_shallow(fn):
                if isinstance(sub, ast.Assign) and \
                        len(sub.targets) == 1 and \
                        isinstance(sub.targets[0], ast.Name):
                    name = sub.targets[0].id
                    n, ops = chain_of(sub.value)
                    if isinstance(sub.value, ast.Call):
                        note(sub.value)
                    chains[name] = (n, ops) if n else (0, [])
                elif isinstance(sub, ast.Call) and id(sub) not in reported:
                    if _copy_call_kind(sub, wrappers) is not None:
                        note(sub)

        class V(ast.NodeVisitor):
            def visit_FunctionDef(self, node):
                stack.append(node.name)
                walk_function(node)
                self.generic_visit(node)
                stack.pop()

            visit_AsyncFunctionDef = visit_FunctionDef

            def visit_ClassDef(self, node):
                stack.append(node.name)
                self.generic_visit(node)
                stack.pop()

        V().visit(ms.tree)
        return findings
