"""H001: no host round-trips in the code a lowered closure runs.

Counterpart of presto_tpu/lint/passes/host_sync.py, in torch terms. The
reference compiles a query fragment to one XLA program, and a host read
inside it splits the program. The port lowers a plan to a Python
closure (exec/planner.py) that queues ops on the card's stream; a read
of a device value on the host waits for that stream to drain, and the
host stops feeding the card until it has. K002 of the kernel audit
(audit/passes/host_callback.py) sees those reads in the dispatched op
stream at run time; this pass finds them in the source.

Scope (``core.traced_closure``): every function of ``ops/`` and
``expr/``, except the plan-time host code in ``HOST_OK_FUNCS``; in
``exec/planner.py`` the closures ``compile_plan`` builds; a file
outside the port (a fixture, an explicit path) whole.

Flagged, on a tensor:

  * ``.item()``, ``.tolist()``, ``.cpu()`` (or ``.to("cpu")``) and
    ``.numpy()`` -- ``.numpy()`` of a ``.cpu()`` is the same read, and
    counts once;
  * ``bool()``, ``int()`` and ``float()`` of a tensor, and a tensor as
    the test of ``if``, ``while``, a conditional expression or
    ``assert``;
  * ``np.asarray`` / ``np.array`` of a tensor;
  * the ops whose output size depends on the data, which sync to size
    it: K002's ``SIZE_SYNC_OPS`` (nonzero, argwhere, masked_select,
    unique, unique_consecutive; ``torch.where`` with one argument), and
    ``repeat_interleave`` without ``output_size``;
  * ``torch.cuda.synchronize()`` and ``.synchronize()``.

What is a tensor is inferred, not known: the result of a ``torch.*``
call or of a tensor's method, a parameter annotated ``torch.Tensor``,
a function of the module annotated to return one, a column field of
block.py (``values``, ``nulls``, ...) and anything computed from
those. A numpy value (an ``np.*`` result, a ``.numpy()``) is host
data: ``int()`` of it is not flagged, nor ``.tolist()``. ``.item()``,
``.cpu()`` and the size-syncing methods are flagged on any receiver
that is not known to be numpy. Boolean-mask indexing (``x[mask]``),
which K002 sees, is not told apart from integer indexing here.

The whitelist is K002's ``SYNC_OK_SITES``, read from the audit pass:
a site whose enclosing function or class is listed there for its file
is a sanctioned sync, found and not reported. ``sites()`` returns every
site with its standing (reported, suppressed, whitelisted), which the
kernel audit's sites on the card are held against.
"""

from __future__ import annotations

import ast
import functools
import os
from typing import Dict, List, Optional, Set, Tuple

from ..core import (PACKAGE, REPO, Finding, LintPass, ModuleSource,
                    dotted_context, register, traced_closure)

__all__ = ["HostSyncPass", "HOST_OK_FUNCS", "sync_ok_sites", "sites"]

# plan-time host code inside ops/ and expr/ modules, by basename: it
# runs once per plan on host data, not per dispatch
HOST_OK_FUNCS: Dict[str, Set[str]] = {
    # DFA construction runs once per pattern at plan time; the tables
    # it builds are constants the kernel closes over
    "regex.py": {"compile_dfa"},
    # constant folding evaluates a literal subexpression once, at plan
    # time, on a one-row CPU batch
    "logical.py": {"fold_constants"},
}

_TENSOR, _HOST = "tensor", "host"

# torch.<name> callables that return no tensor
_TORCH_NON_TENSOR = {
    "device", "dtype", "iinfo", "finfo", "Size", "is_tensor",
    "is_floating_point", "is_complex", "get_default_dtype",
    "get_num_threads", "set_num_threads", "no_grad", "inference_mode",
    "enable_grad", "Generator", "manual_seed", "promote_types",
    "result_type", "can_cast", "is_grad_enabled", "compile",
    "get_device", "numel", "typename", "use_deterministic_algorithms",
}
# torch.<sub>.* namespaces whose callables return tensors
_TORCH_TENSOR_NS = {"nn", "linalg", "special", "fft"}
# tensor methods and attributes whose result lives on the host
_TENSOR_HOST_METHODS = {
    "item", "tolist", "numpy", "dim", "numel", "nelement", "size",
    "element_size", "data_ptr", "stride", "storage_offset",
    "is_contiguous", "get_device", "is_floating_point", "untyped_storage",
    "type",
}
_TENSOR_HOST_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda",
                      "layout", "requires_grad", "names"}

_COERCIONS = {"int", "float", "bool"}
_HOST_READS = {
    "item": ".item() forces a device->host sync",
    "tolist": ".tolist() copies a device tensor to host lists, a "
              "device->host sync",
    "cpu": ".cpu() copies a device tensor to host memory, a "
           "device->host sync",
    "numpy": ".numpy() of a device tensor needs a copy to host memory "
             "first, a device->host sync",
}


@functools.lru_cache(maxsize=1)
def sync_ok_sites() -> Dict[str, Dict[str, str]]:
    """K002's whitelist, {file: {function: reason}}: the single source."""
    from ...audit.passes.host_callback import SYNC_OK_SITES
    return SYNC_OK_SITES


@functools.lru_cache(maxsize=1)
def _size_sync_names() -> Set[str]:
    """torch spellings of K002's SIZE_SYNC_OPS: ``aten._unique2`` is
    ``unique``, ``aten.unique_dim`` is ``unique(dim=...)``."""
    from ...audit.passes.host_callback import SIZE_SYNC_OPS
    out = set()
    for op in SIZE_SYNC_OPS:
        name = op.split(".", 1)[1].lstrip("_").rstrip("0123456789")
        out.add("unique" if name.startswith("unique_dim") else name)
    return out


@functools.lru_cache(maxsize=4)
def _tensor_fields(repo: str) -> Set[str]:
    """Field names annotated ``torch.Tensor`` on block.py's columns and
    batch: the attributes that hold a tensor on every column."""
    path = os.path.join(repo, PACKAGE, "block.py")
    try:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
    except OSError:
        return set()
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            for st in node.body:
                if isinstance(st, ast.AnnAssign) and \
                        isinstance(st.target, ast.Name) and \
                        "Tensor" in ast.unparse(st.annotation):
                    out.add(st.target.id)
    return out


def _root_chain(fn: ast.AST) -> List[str]:
    """``torch.nn.functional.pad`` -> ["torch", "nn", "functional",
    "pad"]; [] unless the chain is rooted at a name."""
    parts: List[str] = []
    node = fn
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return []
    parts.append(node.id)
    return parts[::-1]


def _annotation_kind(ann: Optional[ast.AST]) -> Optional[str]:
    if ann is None:
        return None
    text = ast.unparse(ann)
    if "Tensor" in text:
        return _TENSOR
    if "ndarray" in text:
        return _HOST
    return None


class _Kinds:
    """What each expression of one function is: a tensor, host data
    (numpy or a Python value read off a tensor), or unknown (None)."""

    def __init__(self, fields: Set[str], returns: Dict[str, str],
                 outer: Optional["_Kinds"] = None):
        self.fields = fields
        self.returns = returns
        self.outer = outer
        self.env: Dict[str, Optional[str]] = {}

    def lookup(self, name: str) -> Optional[str]:
        k = self
        while k is not None:
            if name in k.env:
                return k.env[name]
            k = k.outer
        return None

    def bind(self, target: ast.AST, kind: Optional[str]) -> None:
        if isinstance(target, ast.Name):
            self.env[target.id] = kind
        elif isinstance(target, (ast.Tuple, ast.List)):
            for t in target.elts:
                self.bind(t, kind)
        elif isinstance(target, ast.Starred):
            self.bind(target.value, None)

    def of(self, e: ast.AST) -> Optional[str]:
        if isinstance(e, ast.Name):
            return self.lookup(e.id)
        if isinstance(e, ast.Call):
            return self._call(e)
        if isinstance(e, ast.Attribute):
            base = self.of(e.value)
            if e.attr in _TENSOR_HOST_ATTRS:
                return _HOST if base is not None else None
            if base == _TENSOR:
                return _TENSOR
            if base == _HOST:
                return _HOST
            if e.attr in self.fields:
                return _TENSOR
            return None
        if isinstance(e, ast.Subscript):
            return self.of(e.value)
        if isinstance(e, (ast.BinOp, ast.Compare, ast.BoolOp)):
            parts = [e.left, e.right] if isinstance(e, ast.BinOp) else \
                [e.left, *e.comparators] if isinstance(e, ast.Compare) \
                else list(e.values)
            kinds = {self.of(p) for p in parts}
            return _TENSOR if _TENSOR in kinds else \
                (_HOST if _HOST in kinds else None)
        if isinstance(e, ast.UnaryOp):
            return self.of(e.operand)
        if isinstance(e, ast.IfExp):
            kinds = {self.of(e.body), self.of(e.orelse)}
            return _TENSOR if _TENSOR in kinds else None
        if isinstance(e, ast.NamedExpr):
            return self.of(e.value)
        return None

    def _call(self, e: ast.Call) -> Optional[str]:
        fn = e.func
        chain = _root_chain(fn)
        if chain and chain[0] == "torch":
            if len(chain) == 2:
                return None if chain[1] in _TORCH_NON_TENSOR else _TENSOR
            return _TENSOR if chain[1] in _TORCH_TENSOR_NS else None
        if chain and chain[0] in ("np", "numpy"):
            return _HOST
        if isinstance(fn, ast.Name):
            if fn.id in ("int", "float", "bool", "len", "str", "range"):
                return _HOST
            return self.returns.get(fn.id)
        if isinstance(fn, ast.Attribute):
            recv = self.of(fn.value)
            if recv == _TENSOR:
                return _HOST if fn.attr in _TENSOR_HOST_METHODS \
                    else _TENSOR
            if recv == _HOST:
                return _HOST
            if fn.attr == "numpy":
                return _HOST
        return None


def _function_returns(tree: ast.Module) -> Dict[str, str]:
    """Module functions annotated to return a tensor or an ndarray."""
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            k = _annotation_kind(node.returns)
            if k is not None and "Tuple" not in ast.unparse(node.returns):
                out[node.name] = k
    return out


def _is_cpu_move(call: ast.Call) -> bool:
    """``x.cpu()``, ``x.to("cpu")``, ``x.to(device="cpu")``."""
    fn = call.func
    if not isinstance(fn, ast.Attribute):
        return False
    if fn.attr == "cpu" and not call.args:
        return True
    if fn.attr == "to":
        for a in [*call.args, *(k.value for k in call.keywords
                                if k.arg == "device")]:
            if isinstance(a, ast.Constant) and a.value == "cpu":
                return True
    return False


@register
class HostSyncPass(LintPass):
    code = "H001"
    name = "host-sync"
    description = ("host reads of device tensors (.item/.tolist/.cpu/"
                   "bool()/if tensor/size-syncing ops) in the code a "
                   "lowered closure runs")
    TARGETS = ("presto_tpu_torch/ops/*.py", "presto_tpu_torch/expr/*.py",
               "presto_tpu_torch/exec/planner.py")

    def run(self, ms: ModuleSource) -> List[Finding]:
        return [f for f, why in self.scan(ms) if why is None]

    def scan(self, ms: ModuleSource
             ) -> List[Tuple[Finding, Optional[str]]]:
        """Every site with the whitelist's reason, None where it is not
        whitelisted."""
        in_port = ms.rel_path.startswith(f"{PACKAGE}/")
        host_ok = HOST_OK_FUNCS.get(ms.basename, set()) if in_port \
            else set()
        allowed = sync_ok_sites().get(ms.rel_path, {})
        fields = _tensor_fields(REPO)
        returns = _function_returns(ms.tree)
        size_sync = _size_sync_names()
        out: List[Tuple[Finding, Optional[str]]] = []
        stack: List[str] = []
        funcs: List[ast.AST] = []
        kinds: List[_Kinds] = [_Kinds(fields, returns)]

        def active() -> bool:
            if stack and stack[0] in host_ok:
                return False
            if not in_port:
                return True
            return traced_closure(ms.rel_path, funcs)

        def emit(node: ast.AST, message: str) -> None:
            why = next((allowed[s] for s in stack if s in allowed), None)
            out.append((ms.finding("H001", node, dotted_context(stack),
                                   message), why))

        def kind(e: ast.AST) -> Optional[str]:
            return kinds[-1].of(e)

        def check_test(test: ast.AST, what: str) -> None:
            if active() and kind(test) == _TENSOR:
                emit(test, f"a tensor as the test of {what} forces a "
                           f"device->host sync")

        class V(ast.NodeVisitor):
            def visit_FunctionDef(self, node):
                stack.append(node.name)
                funcs.append(node)
                k = _Kinds(fields, returns, outer=kinds[-1])
                a = node.args
                for arg in [*a.posonlyargs, *a.args, *a.kwonlyargs]:
                    k.env[arg.arg] = _annotation_kind(arg.annotation)
                kinds.append(k)
                for d in node.decorator_list:
                    self.visit(d)
                for st in node.body:
                    self.visit(st)
                kinds.pop()
                funcs.pop()
                stack.pop()

            visit_AsyncFunctionDef = visit_FunctionDef

            def visit_Lambda(self, node):
                k = _Kinds(fields, returns, outer=kinds[-1])
                for arg in node.args.args:
                    k.env[arg.arg] = None
                kinds.append(k)
                self.visit(node.body)
                kinds.pop()

            def visit_ClassDef(self, node):
                stack.append(node.name)
                self.generic_visit(node)
                stack.pop()

            def visit_Assign(self, node):
                self.visit(node.value)
                k = kind(node.value)
                for t in node.targets:
                    kinds[-1].bind(t, k)
                    self.visit(t)

            def visit_AnnAssign(self, node):
                if node.value is not None:
                    self.visit(node.value)
                kinds[-1].bind(node.target,
                               _annotation_kind(node.annotation) or
                               (kind(node.value) if node.value else None))

            def visit_For(self, node):
                self.visit(node.iter)
                kinds[-1].bind(node.target, None)
                for st in [*node.body, *node.orelse]:
                    self.visit(st)

            def visit_If(self, node):
                check_test(node.test, "`if`")
                self.generic_visit(node)

            def visit_While(self, node):
                check_test(node.test, "`while`")
                self.generic_visit(node)

            def visit_IfExp(self, node):
                check_test(node.test, "a conditional expression")
                self.generic_visit(node)

            def visit_Assert(self, node):
                check_test(node.test, "`assert`")
                self.generic_visit(node)

            def visit_Call(self, node):
                if active():
                    self._check(node)
                self.generic_visit(node)

            def _check(self, node: ast.Call) -> None:
                fn = node.func
                chain = _root_chain(fn)
                if isinstance(fn, ast.Attribute):
                    recv = kind(fn.value)
                    if fn.attr in _HOST_READS and not node.args and \
                            recv != _HOST:
                        if fn.attr == "numpy" and \
                                isinstance(fn.value, ast.Call) and \
                                _is_cpu_move(fn.value):
                            return  # the .cpu() before it is the read
                        if fn.attr == "tolist" and recv != _TENSOR:
                            return
                        emit(node, _HOST_READS[fn.attr])
                        return
                    if fn.attr == "to" and _is_cpu_move(node) and \
                            recv != _HOST:
                        emit(node, _HOST_READS["cpu"])
                        return
                    if fn.attr == "synchronize":
                        emit(node, f"{'.'.join(chain) or '.synchronize'}"
                                   f"() stalls the host on the device")
                        return
                    if chain[:1] in (["np"], ["numpy"]) and \
                            fn.attr in ("asarray", "array") and \
                            node.args and kind(node.args[0]) == _TENSOR:
                        emit(node, f"np.{fn.attr}(...) of a tensor copies "
                                   f"device data to host mid-pipeline")
                        return
                    torch_fn = chain[:1] == ["torch"] and len(chain) == 2
                    if recv == _HOST or (not torch_fn and
                                         chain[:1] in (["np"], ["numpy"])):
                        return
                    if fn.attr in size_sync:
                        emit(node, f"{fn.attr}() sizes its output by the "
                                   f"data, so the host waits for the "
                                   f"device to count it")
                    elif torch_fn and fn.attr == "where" and \
                            len(node.args) == 1 and not node.keywords:
                        emit(node, "torch.where(cond) is nonzero(): it "
                                   "sizes its output by the data, so the "
                                   "host waits for the device to count "
                                   "it")
                    elif fn.attr == "repeat_interleave" and \
                            not any(k.arg == "output_size"
                                    for k in node.keywords) and \
                            any(kind(a) == _TENSOR for a in node.args):
                        emit(node, "repeat_interleave() without "
                                   "output_size sizes its output by the "
                                   "data, so the host waits for the "
                                   "device to count it")
                elif isinstance(fn, ast.Name) and fn.id in _COERCIONS \
                        and len(node.args) == 1 \
                        and kind(node.args[0]) == _TENSOR:
                    emit(node, f"{fn.id}(...) of a tensor forces a "
                               f"device->host sync")

        V().visit(ms.tree)
        return out


def sites(repo: str = REPO) -> Dict[Tuple[str, int], List[dict]]:
    """Every H001 site of the port's targets, {(path, line): [{code,
    context, message, standing}]}, standing one of "reported",
    "suppressed" or "whitelisted" (with the reason)."""
    p = HostSyncPass()
    out: Dict[Tuple[str, int], List[dict]] = {}
    for rel in p.target_files(repo):
        ms = ModuleSource(rel, repo)
        for f, why in p.scan(ms):
            standing = "whitelisted" if why is not None else (
                "suppressed" if ms.suppressed(f.code, f.line)
                else "reported")
            out.setdefault((f.path, f.line), []).append(
                {"context": f.context, "message": f.message,
                 "standing": standing, "reason": why})
    return out
