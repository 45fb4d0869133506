"""The static lock model the concurrency passes share.

Counterpart of presto_tpu/lint/lockmodel.py, with the same extraction
rules, so that the port's graph speaks the node language of the
reference's and of the runtime witness. One AST walk, three consumers:
C002 (lock-order graph) needs *which lock is acquired while which is
held*, across function and module boundaries; C003 (blocking-under-lock)
needs *what runs under a held lock*; ``python -m
presto_tpu_torch.lint.lockgraph`` needs the whole graph as a reviewable
artifact (presto_tpu_torch/lint/LOCK_ORDER.json). The facts:

  * **Lock definitions.** ``self.X = threading.Lock()`` (Lock / RLock /
    Condition / Semaphore / BoundedSemaphore, and the witness's
    ``OrderedLock`` of presto_tpu_torch/utils/locks.py) in a class body
    names the lock ``<module>.<Class>.<X>``; a module-level assignment
    names ``<module>.<X>``. The *name* is the identity -- every
    ``_Task.lock`` instance is one node, the convention the witness
    uses.
  * **Receiver resolution.** ``with self.X:`` resolves through the
    enclosing class; ``with obj.X:`` by attribute-name ownership --
    the class IN THE SAME MODULE that defines lock attr ``X``, else the
    unique class program-wide; ``with X:`` to the module-level lock.
    Unresolvable receivers still count as *a* held lock for C003
    (conservative) but add no graph edge for C002.
  * **Acquisition events + call edges.** Per function: every lock
    acquired with the held-set at that point, and every call made with
    the held-set at that point. Nested ``def``s run later (thread
    targets, callbacks), so the held stack does NOT leak into them.
    Functions named ``*_locked`` are analyzed with their class's single
    lock pre-held (the caller-holds convention).
  * **Blocking operations.** Direct blocking ops per function (the
    C003 catalog: sleeps, joins, HTTP, file/socket I/O, subprocess,
    foreign lock/condition waits, device syncs -- ``block_until_ready``
    and, in torch, ``synchronize``), propagated through resolved calls
    to a fixpoint.

Call resolution is name-based and curated: ``self.m()`` binds to the
enclosing class when it defines ``m``; other ``obj.m()`` calls bind by
method-name ownership across the scanned program EXCEPT for
``_COMMON_METHODS`` (dict/list/set/str methods). Ambiguous names bind
nothing: a missed edge beats a fictional one.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import ModuleSource, dotted_context

__all__ = ["LOCK_FACTORIES", "ModuleLockInfo", "FuncInfo",
           "LockProgram", "analyze_module", "build_program"]

# threading.* (and utils/locks.py's OrderedLock) constructors whose result is a lock
# for ordering purposes. Semaphores block like locks; Conditions wrap
# one.
LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore",
                  "BoundedSemaphore", "OrderedLock"}

# method names owned by builtin collections/strings: never resolve a
# bare ``obj.m()`` call edge through these (a ``.get()`` is a dict, not
# FragmentResultCache, until proven otherwise)
_COMMON_METHODS = {
    "get", "put", "pop", "popitem", "append", "appendleft", "add",
    "clear", "update", "remove", "discard", "extend", "insert", "sort",
    "reverse", "copy", "setdefault", "items", "keys", "values", "join",
    "split", "strip", "read", "write", "close", "open", "flush",
    "start", "wait", "notify", "notify_all", "acquire", "release",
    "is_set", "set", "info", "send", "recv", "encode", "decode",
    "format", "count", "index", "replace", "seek", "tell", "move_to_end",
}


@dataclasses.dataclass
class BlockingOp:
    """One direct blocking operation inside a function."""
    op: str        # short category: sleep | join | http | io | ...
    detail: str    # rendered call, e.g. "time.sleep"
    line: int
    col: int
    held: Tuple[str, ...] = ()   # resolved locks held at the op
    held_any: bool = False       # ANY lock-ish held (incl. unresolved)
    context: str = "<module>"


@dataclasses.dataclass
class Acquire:
    lock: str                  # resolved lock id
    held: Tuple[str, ...]      # resolved locks held at this point
    line: int
    col: int
    context: str


@dataclasses.dataclass
class CallSite:
    recv: Optional[str]        # receiver name ("self", "task", None)
    name: str                  # method/function name
    held: Tuple[str, ...]      # resolved locks held at the call
    held_any: bool             # ANY lock-ish held (incl. unresolved)
    line: int
    col: int
    context: str
    recv_attr: Optional[str] = None  # final attr of an attribute
    #                                  receiver: self.manager.drain()
    #                                  -> "manager" (typed resolution)


@dataclasses.dataclass
class FuncInfo:
    module: str                # module stem ("worker")
    rel_path: str
    qualname: str              # dotted in-module path ("TaskManager._run")
    cls: Optional[str]         # enclosing class name
    name: str                  # bare function name
    entry_held: Tuple[str, ...]
    acquires: List[Acquire] = dataclasses.field(default_factory=list)
    calls: List[CallSite] = dataclasses.field(default_factory=list)
    blocking: List[BlockingOp] = dataclasses.field(default_factory=list)
    # `while True`/thread facts for C004
    thread_targets: List[Tuple[str, int]] = \
        dataclasses.field(default_factory=list)
    # local `v = ClassName(...)` bindings (call resolution)
    local_types: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ModuleLockInfo:
    stem: str
    rel_path: str
    # lock id -> (kind, line)
    locks: Dict[str, Tuple[str, int]]
    # attr name -> [(class name, lock id)] for receiver resolution
    class_lock_attrs: Dict[str, List[Tuple[str, str]]]
    # module-level name -> lock id
    module_locks: Dict[str, str]
    funcs: List[FuncInfo]
    # `self.X = ClassName(...)` bindings: attr -> {class names}
    attr_types: Dict[str, Set[str]] = dataclasses.field(
        default_factory=dict)
    class_names: Set[str] = dataclasses.field(default_factory=set)


def _stem(rel_path: str) -> str:
    base = os.path.splitext(os.path.basename(rel_path))[0]
    if base == "__init__":
        # a package's __init__.py speaks with the PACKAGE's name --
        # "failpoints.FailpointRegistry._lock", never the ambiguous
        # "__init__.…" (the runtime witness uses the same spelling)
        return os.path.basename(os.path.dirname(rel_path)) or base
    return base


def _is_lock_factory(call: ast.AST) -> Optional[str]:
    """'Lock'|'RLock'|... when `call` constructs a lock."""
    if not isinstance(call, ast.Call):
        return None
    fn = call.func
    if isinstance(fn, ast.Attribute) and fn.attr in LOCK_FACTORIES:
        return fn.attr
    if isinstance(fn, ast.Name) and fn.id in LOCK_FACTORIES:
        return fn.id
    return None


def _collect_locks(ms: ModuleSource, stem: str):
    """Lock definitions: class-attribute locks (assigned anywhere in
    the class body, __init__ included) and module-level locks."""
    locks: Dict[str, Tuple[str, int]] = {}
    class_lock_attrs: Dict[str, List[Tuple[str, str]]] = {}
    module_locks: Dict[str, str] = {}

    for node in ms.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            kind = _is_lock_factory(node.value)
            if kind:
                lid = f"{stem}.{node.targets[0].id}"
                locks[lid] = (kind, node.lineno)
                module_locks[node.targets[0].id] = lid

    for cls in ast.walk(ms.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        for sub in ast.walk(cls):
            if isinstance(sub, ast.Assign):
                kind = _is_lock_factory(sub.value)
                if not kind:
                    continue
                for t in sub.targets:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self":
                        lid = f"{stem}.{cls.name}.{t.attr}"
                        locks[lid] = (kind, sub.lineno)
                        class_lock_attrs.setdefault(t.attr, []).append(
                            (cls.name, lid))
                    elif isinstance(t, ast.Name) and sub in cls.body:
                        # class-attribute form: `lock = Lock()` in the
                        # class body (one lock shared by every
                        # instance; `with self.lock:` resolves to it
                        # through the enclosing class)
                        lid = f"{stem}.{cls.name}.{t.id}"
                        locks[lid] = (kind, sub.lineno)
                        class_lock_attrs.setdefault(t.id, []).append(
                            (cls.name, lid))
            elif isinstance(sub, ast.AnnAssign) and sub in cls.body and \
                    isinstance(sub.target, ast.Name):
                # dataclass-style lock field: `call_lock: threading.Lock`
                ann = ast.dump(sub.annotation)
                if any(f"'{k}'" in ann for k in LOCK_FACTORIES):
                    lid = f"{stem}.{cls.name}.{sub.target.id}"
                    locks[lid] = ("field", sub.lineno)
                    class_lock_attrs.setdefault(sub.target.id, []).append(
                        (cls.name, lid))
    return locks, class_lock_attrs, module_locks


def _call_name(fn: ast.AST) -> str:
    """Dotted rendering of a call target, best effort."""
    parts: List[str] = []
    node = fn
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts)) or "<call>"


def _blocking_kind(call: ast.Call, open_vars: Set[str],
                   held_attrs: Set[Tuple[str, str]]) -> Optional[Tuple[str, str]]:
    """(category, detail) when `call` is a blocking operation from the
    C003 catalog; None otherwise. ``open_vars`` are local names bound
    from open()/fdopen()/mkstemp in this function; ``held_attrs`` the
    (recv, attr) spellings of currently-held locks (so waiting on your
    OWN condition is not 'waiting on a different lock')."""
    fn = call.func
    dotted = _call_name(fn)
    nargs = len(call.args)
    kwnames = {k.arg for k in call.keywords}

    # sleeps (time.sleep, bare sleep, Backoff.sleep)
    if dotted == "time.sleep" or dotted.endswith(".sleep") or \
            dotted == "sleep":
        return ("sleep", dotted)
    # subprocess
    if dotted.startswith("subprocess."):
        return ("subprocess", dotted)
    # HTTP / RPC
    if dotted.endswith("urlopen") or dotted.endswith(".getresponse"):
        return ("http", dotted)
    if dotted in ("pull_worker_docs", "remote_group_load",
                  "fetch_remote_batch"):
        return ("http", dotted)
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name) \
            and "client" in fn.value.id.lower():
        return ("http", dotted)  # WorkerClient/StatementClient methods
    # device sync (jax's spelling, and torch's: torch.cuda.synchronize,
    # stream/event .synchronize())
    if dotted.endswith("block_until_ready") or \
            dotted.endswith("synchronize"):
        return ("device_sync", dotted)
    # file / socket I/O
    if dotted in ("open", "os.fdopen", "tempfile.mkstemp",
                  "os.fsync", "os.replace", "json.dump", "pickle.dump"):
        return ("io", dotted)
    if isinstance(fn, ast.Attribute):
        recv = fn.value
        recv_name = recv.id if isinstance(recv, ast.Name) else \
            (recv.attr if isinstance(recv, ast.Attribute) else None)
        if fn.attr in ("write", "read", "flush", "readline", "seek",
                       "recv", "send", "sendall", "makefile"):
            if recv_name in open_vars or \
                    recv_name in ("wfile", "rfile", "sock", "socket",
                                  "conn", "connection"):
                return ("io", dotted)
        # Thread.join / future.result: zero args or a numeric/timeout
        # arg; str.join always takes an iterable, os.path.join several
        # parts -- both excluded by shape and receiver
        if fn.attr in ("join", "result"):
            if isinstance(recv, ast.Constant):
                return None  # ", ".join(...)
            if dotted.startswith(("os.path.", "posixpath.", "ntpath.")):
                return None
            numeric = nargs == 1 and isinstance(call.args[0], ast.Constant) \
                and isinstance(call.args[0].value, (int, float))
            if nargs == 0 or numeric or kwnames <= {"timeout"}:
                if nargs <= 1:
                    return ("join", dotted)
        # waiting on a DIFFERENT lock/condition than every held one
        if fn.attr in ("wait", "wait_for", "acquire"):
            rt = None
            if isinstance(recv, ast.Attribute) and \
                    isinstance(recv.value, ast.Name):
                rt = (recv.value.id, recv.attr)
            elif isinstance(recv, ast.Name):
                rt = ("", recv.id)
            if rt is not None and rt in held_attrs:
                return None  # cv.wait under `with cv:` -- the idiom
            return ("lock_wait", dotted)
    return None


def _first_class_call(value: ast.AST, classes: Set[str]) -> Optional[str]:
    """The first `ClassName(...)` constructor inside `value` whose name
    is a scanned class (handles `x or ClassName(...)` fallbacks)."""
    for sub in ast.walk(value):
        if isinstance(sub, ast.Call):
            fn = sub.func
            name = fn.id if isinstance(fn, ast.Name) else \
                (fn.attr if isinstance(fn, ast.Attribute) else None)
            if name in classes:
                return name
    return None


def analyze_module(ms: ModuleSource,
                   program_attrs: Optional[Dict[str, List[Tuple[str, str]]]]
                   = None,
                   program_classes: Optional[Set[str]] = None
                   ) -> ModuleLockInfo:
    """Extract the module's lock facts. ``program_attrs`` (attr ->
    [(class, lock id)] across the whole scanned program) and
    ``program_classes`` refine receiver resolution for cross-module
    receivers; single-module callers (fixtures) omit them."""
    stem = _stem(ms.rel_path)
    locks, class_lock_attrs, module_locks = _collect_locks(ms, stem)
    funcs: List[FuncInfo] = []
    class_names = {n.name for n in ast.walk(ms.tree)
                   if isinstance(n, ast.ClassDef)}
    known_classes = (program_classes or set()) | class_names
    # `self.X = ClassName(...)`: attr -> {classes} (typed resolution
    # for `self.X.m()` receivers)
    attr_types: Dict[str, Set[str]] = {}
    for node in ast.walk(ms.tree):
        if isinstance(node, ast.Assign):
            cls = _first_class_call(node.value, known_classes)
            if cls is None:
                continue
            for t in node.targets:
                if isinstance(t, ast.Attribute) and \
                        isinstance(t.value, ast.Name) and \
                        t.value.id == "self":
                    attr_types.setdefault(t.attr, set()).add(cls)

    def resolve(ce: ast.AST, cls: Optional[str]) -> Optional[str]:
        """Lock id for a with-context expression, or None."""
        if isinstance(ce, ast.Name):
            return module_locks.get(ce.id)
        if isinstance(ce, ast.Attribute):
            attr = ce.attr
            owners = class_lock_attrs.get(attr, [])
            if isinstance(ce.value, ast.Name) and ce.value.id == "self" \
                    and cls is not None:
                for c, lid in owners:
                    if c == cls:
                        return lid
            if len(owners) == 1:
                return owners[0][1]
            if len({lid for _, lid in owners}) == 1 and owners:
                return owners[0][1]
            if not owners and program_attrs is not None:
                powners = program_attrs.get(attr, [])
                if len({lid for _, lid in powners}) == 1 and powners:
                    return powners[0][1]
        return None

    def lockish(ce: ast.AST) -> bool:
        """Heuristic: does this with-context expression LOOK like a
        lock (for C003's conservative held tracking)?"""
        name = None
        if isinstance(ce, ast.Attribute):
            name = ce.attr
        elif isinstance(ce, ast.Name):
            name = ce.id
        if name is None:
            return False
        low = name.lower()
        return ("lock" in low or low.endswith("_cv") or low == "cv" or
                "mutex" in low or "sem" in low or "cond" in low)

    class W(ast.NodeVisitor):
        def __init__(self):
            self.stack: List[str] = []       # class/function names
            self.cls_stack: List[str] = []

        def _context(self) -> str:
            return dotted_context(self.stack)

        def visit_ClassDef(self, node):
            self.stack.append(node.name)
            self.cls_stack.append(node.name)
            self.generic_visit(node)
            self.cls_stack.pop()
            self.stack.pop()

        def visit_FunctionDef(self, node):
            cls = self.cls_stack[-1] if self.cls_stack else None
            self.stack.append(node.name)
            qual = ".".join(self.stack)
            entry_held: Tuple[str, ...] = ()
            if node.name.endswith("_locked") and cls is not None:
                own = [lid for lids in class_lock_attrs.values()
                       for c, lid in lids if c == cls]
                if len(own) == 1:
                    entry_held = (own[0],)
            fi = FuncInfo(module=stem, rel_path=ms.rel_path,
                          qualname=qual, cls=cls, name=node.name,
                          entry_held=entry_held)
            funcs.append(fi)
            self._walk_body(node, fi, cls, entry_held)
            self.stack.pop()

        visit_AsyncFunctionDef = visit_FunctionDef

        def _walk_body(self, fn_node, fi: FuncInfo, cls, entry_held):
            held: List[str] = list(entry_held)
            held_attrs: Set[Tuple[str, str]] = set()
            any_depth = [1 if entry_held else 0]  # count incl. unresolved
            open_vars: Set[str] = set()
            outer = self

            class B(ast.NodeVisitor):
                def visit_FunctionDef(self, node):
                    # nested def: body runs later, locks not held there;
                    # analyze it as its own function with a fresh stack
                    outer.visit_FunctionDef(node)

                visit_AsyncFunctionDef = visit_FunctionDef

                def visit_ClassDef(self, node):
                    outer.visit_ClassDef(node)

                def visit_Lambda(self, node):
                    return  # body runs later; no lock facts inside

                def visit_Assign(self, node):
                    v = node.value
                    if isinstance(v, ast.Call):
                        d = _call_name(v.func)
                        if d in ("open", "os.fdopen", "tempfile.mkstemp",
                                 "tempfile.NamedTemporaryFile"):
                            for t in node.targets:
                                if isinstance(t, ast.Name):
                                    open_vars.add(t.id)
                    cls_name = _first_class_call(v, known_classes)
                    if cls_name is not None:
                        for t in node.targets:
                            if isinstance(t, ast.Name):
                                fi.local_types[t.id] = cls_name
                    self.generic_visit(node)

                def visit_With(self, node):
                    pushed: List[Optional[str]] = []
                    for item in node.items:
                        ce = item.context_expr
                        lid = resolve(ce, cls)
                        if lid is None and not lockish(ce):
                            continue
                        if lid is not None:
                            fi.acquires.append(Acquire(
                                lock=lid, held=tuple(held),
                                line=node.lineno, col=node.col_offset,
                                context=outer._context()))
                            held.append(lid)
                            pushed.append(lid)
                        else:
                            pushed.append(None)
                        any_depth[0] += 1
                        if isinstance(ce, ast.Attribute) and \
                                isinstance(ce.value, ast.Name):
                            held_attrs.add((ce.value.id, ce.attr))
                        elif isinstance(ce, ast.Name):
                            # module-level lock: `_cv.wait()` under
                            # `with _cv:` is the same own-cv idiom
                            held_attrs.add(("", ce.id))
                    self.generic_visit(node)
                    for lid in pushed:
                        any_depth[0] -= 1
                        if lid is not None:
                            held.remove(lid)

                visit_AsyncWith = visit_With

                def visit_Call(self, node):
                    blk = _blocking_kind(node, open_vars, held_attrs)
                    if blk is not None:
                        fi.blocking.append(BlockingOp(
                            op=blk[0], detail=blk[1],
                            line=node.lineno, col=node.col_offset,
                            held=tuple(held),
                            held_any=any_depth[0] > 0,
                            context=outer._context()))
                    fn = node.func
                    recv = None
                    recv_attr = None
                    name = None
                    if isinstance(fn, ast.Attribute):
                        name = fn.attr
                        if isinstance(fn.value, ast.Name):
                            recv = fn.value.id
                        elif isinstance(fn.value, ast.Attribute):
                            recv_attr = fn.value.attr
                    elif isinstance(fn, ast.Name):
                        name = fn.id
                    if name:
                        fi.calls.append(CallSite(
                            recv=recv, name=name, held=tuple(held),
                            held_any=any_depth[0] > 0,
                            line=node.lineno, col=node.col_offset,
                            context=outer._context(),
                            recv_attr=recv_attr))
                    # thread targets (C004)
                    if name == "Thread":
                        for kw in node.keywords:
                            if kw.arg == "target":
                                t = kw.value
                                tn = None
                                if isinstance(t, ast.Attribute):
                                    tn = t.attr
                                elif isinstance(t, ast.Name):
                                    tn = t.id
                                if tn:
                                    fi.thread_targets.append(
                                        (tn, node.lineno))
                    self.generic_visit(node)

            B().visit(ast.Module(body=list(fn_node.body),
                                 type_ignores=[]))

    W().visit(ms.tree)
    return ModuleLockInfo(stem=stem, rel_path=ms.rel_path, locks=locks,
                          class_lock_attrs=class_lock_attrs,
                          module_locks=module_locks, funcs=funcs,
                          attr_types=attr_types,
                          class_names=class_names)


class LockProgram:
    """Whole-program view: resolved call graph, transitive acquire and
    blocking sets, the lock-order edge set, and its cycles."""

    def __init__(self, infos: Sequence[ModuleLockInfo]):
        self.infos = list(infos)
        self.locks: Dict[str, Tuple[str, int, str]] = {}
        for mi in self.infos:
            for lid, (kind, line) in mi.locks.items():
                self.locks[lid] = (kind, line, mi.rel_path)
        # function index: (cls, name) and bare name -> FuncInfos
        self.by_method: Dict[Tuple[str, str], List[FuncInfo]] = {}
        self.by_name: Dict[str, List[FuncInfo]] = {}
        self.attr_types: Dict[str, Set[str]] = {}
        for mi in self.infos:
            for fi in mi.funcs:
                if fi.cls is not None:
                    self.by_method.setdefault((fi.cls, fi.name),
                                              []).append(fi)
                self.by_name.setdefault(fi.name, []).append(fi)
            for attr, clss in mi.attr_types.items():
                self.attr_types.setdefault(attr, set()).update(clss)
        self._fixpoints()
        self._build_edges()

    # -- call resolution -------------------------------------------------

    def resolve_call(self, fi: FuncInfo, c: CallSite) -> List[FuncInfo]:
        """Callees a call site may bind to. Typed resolution only --
        `self.m()` through the enclosing class, `self.attr.m()` /
        `var.m()` through `attr/var = ClassName(...)` bindings, module
        functions, and unique program-wide names. Ambiguous names
        resolve to NOTHING: for a gate with an empty baseline a missed
        edge beats a fictional one."""
        if c.recv == "self" and fi.cls is not None:
            own = self.by_method.get((fi.cls, c.name))
            if own:
                return own
        # typed receivers: self.<attr>.m() / <var>.m()
        classes: Set[str] = set()
        if c.recv_attr is not None:
            classes = self.attr_types.get(c.recv_attr, set())
        elif c.recv is not None and c.recv != "self":
            t = fi.local_types.get(c.recv)
            if t:
                classes = {t}
        if len(classes) == 1:
            own = self.by_method.get((next(iter(classes)), c.name))
            if own:
                return own
        if c.name in _COMMON_METHODS:
            return []
        # bare function / unique method name program-wide
        cands = self.by_name.get(c.name, [])
        return cands if len(cands) == 1 else []

    # -- fixpoints -------------------------------------------------------

    def _fixpoints(self) -> None:
        """Transitive may-acquire lock sets and may-block op sets per
        function (union over the resolved call graph)."""
        self.may_acquire: Dict[int, Set[str]] = {}
        self.may_block: Dict[int, Dict[str, Tuple[str, str]]] = {}
        funcs = [fi for mi in self.infos for fi in mi.funcs]
        for fi in funcs:
            self.may_acquire[id(fi)] = {a.lock for a in fi.acquires}
            self.may_block[id(fi)] = {
                b.op: (b.detail, f"{fi.rel_path}:{fi.qualname}")
                for b in fi.blocking}
        changed = True
        while changed:
            changed = False
            for fi in funcs:
                acq = self.may_acquire[id(fi)]
                blk = self.may_block[id(fi)]
                for c in fi.calls:
                    for g in self.resolve_call(fi, c):
                        extra = self.may_acquire[id(g)] - acq
                        if extra:
                            acq |= extra
                            changed = True
                        for op, ev in self.may_block[id(g)].items():
                            if op not in blk:
                                blk[op] = ev
                                changed = True

    # -- lock-order edges ------------------------------------------------

    def _build_edges(self) -> None:
        """edges[(a, b)] = evidence: a held while b acquired, directly
        or through a resolved call chain."""
        self.edges: Dict[Tuple[str, str], dict] = {}

        def add(a: str, b: str, ev: dict) -> None:
            self.edges.setdefault((a, b), ev)

        for mi in self.infos:
            for fi in mi.funcs:
                for acq in fi.acquires:
                    for a in acq.held:
                        if a != acq.lock:
                            add(a, acq.lock, {
                                "file": fi.rel_path, "line": acq.line,
                                "context": acq.context, "via": None})
                for c in fi.calls:
                    if not c.held:
                        continue
                    for g in self.resolve_call(fi, c):
                        for b in self.may_acquire[id(g)]:
                            for a in c.held:
                                if a != b:
                                    add(a, b, {
                                        "file": fi.rel_path,
                                        "line": c.line,
                                        "context": c.context,
                                        "via": f"{g.module}."
                                               f"{g.qualname}"})

    # -- cycles ----------------------------------------------------------

    def cycles(self) -> List[List[str]]:
        """Elementary cycles in the edge graph, canonicalized (rotated
        to the lexicographically smallest node) and deduplicated;
        deterministic order."""
        adj: Dict[str, List[str]] = {}
        for (a, b) in self.edges:
            adj.setdefault(a, []).append(b)
        for v in adj.values():
            v.sort()
        seen: Set[Tuple[str, ...]] = set()
        out: List[List[str]] = []

        def canon(path: List[str]) -> Tuple[str, ...]:
            i = path.index(min(path))
            return tuple(path[i:] + path[:i])

        def dfs(start: str, node: str, path: List[str],
                onpath: Set[str]) -> None:
            for nxt in adj.get(node, ()):
                if nxt == start:
                    key = canon(path)
                    if key not in seen:
                        seen.add(key)
                        out.append(list(key))
                elif nxt not in onpath and nxt > start:
                    # only explore nodes > start: each cycle found
                    # exactly once, from its smallest node
                    path.append(nxt)
                    onpath.add(nxt)
                    dfs(start, nxt, path, onpath)
                    onpath.discard(nxt)
                    path.pop()

        for n in sorted(adj):
            dfs(n, n, [n], {n})
        out.sort()
        return out

    # -- artifact --------------------------------------------------------

    def to_doc(self) -> dict:
        """The LOCK_ORDER.json document: nodes, ordered edges with
        first-evidence provenance, and (expected-empty) cycles."""
        nodes = [{"id": lid, "kind": kind, "file": path, "line": line}
                 for lid, (kind, line, path) in sorted(self.locks.items())]
        edges = [{"from": a, "to": b, **ev}
                 for (a, b), ev in sorted(self.edges.items())]
        return {"version": 1, "nodes": nodes, "edges": edges,
                "cycles": self.cycles()}


def build_program(sources: Sequence[ModuleSource]) -> LockProgram:
    """Two-phase build: collect every module's class-lock attrs first
    (so receiver resolution can see cross-module owners), then analyze
    with the program-wide attr map."""
    pre = []
    program_classes: Set[str] = set()
    for ms in sources:
        stem = _stem(ms.rel_path)
        _, attrs, _ = _collect_locks(ms, stem)
        pre.append(attrs)
        program_classes |= {n.name for n in ast.walk(ms.tree)
                            if isinstance(n, ast.ClassDef)}
    program_attrs: Dict[str, List[Tuple[str, str]]] = {}
    for attrs in pre:
        for attr, owners in attrs.items():
            program_attrs.setdefault(attr, []).extend(owners)
    infos = [analyze_module(ms, program_attrs, program_classes)
             for ms in sources]
    return LockProgram(infos)
