"""kernaudit core for the port: KernelTrace (the dispatched op stream of
one run of a lowered closure, with provenance), the audit-pass registry
and the run engine.

Counterpart of presto_tpu/audit/core.py. The reference audits a closed
jaxpr, traced without running. The port lowers a plan to a Python
closure over tensors (exec/planner.py), so there is no IR to trace: its
counterpart of the jaxpr is the stream of aten ops the closure
dispatches when it runs. ``KernelTrace.run`` runs the closure once over
the staged batches under a ``TorchDispatchMode`` and records, for each
op, its name, each input's and output's dtype, shape, device, storage
identity (``untyped_storage().data_ptr()``) and bytes, and the
provenance: the first Python frame inside the repository outside
``presto_tpu_torch/audit/`` (file, line, ``co_qualname``). The
hand-written kernels are called through ctypes and never reach the
dispatcher; ``ops/kernels.py::TRACE_HOOK`` hands each launch to the
trace, so a launch is a record too. The mode stack is thread-local, so
a trace records only its own thread's ops, and the kernel hook routes a
launch to the trace of the thread that made it.

The run is a real run: its result is discarded. Errors raised by the
closure (a CUDA error, a kernel's refusal) propagate; the passes run
afterwards over the records.

  * ``AuditPass`` -- subclass per rule (K001...), registered with
    ``@register``; ``audit.passes`` imports every pass module.
  * ``run_audit`` -- map the selected passes over traces, drop findings
    whose provenance line carries ``# kernaudit: disable=CODE``.

Findings are ``lint.core.Finding``s (the reference's fingerprint law):
``path`` is the KERNEL label, ``line`` and ``context`` the source site
the op traces to, and the message names the source file, so
fingerprints survive edits above a site.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import sys
import threading
import weakref
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, \
    Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..lint.core import REPO, Finding, dotted_context, parse_suppressions

__all__ = ["KernelTrace", "IRFinding", "OpRecord", "TensorMeta",
           "AuditPass", "register", "all_passes", "get_pass",
           "AuditResult", "run_audit", "COPY_OPS"]

_AUDIT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "")

# the ops that move a tensor's bytes to another tensor, perhaps on
# another device
COPY_OPS = frozenset(["aten._to_copy", "aten.copy_", "aten._copy_from",
                      "aten._copy_from_and_resize"])


@dataclasses.dataclass(frozen=True)
class IRFinding(Finding):
    """A Finding plus the source file its op traces to (for
    ``--format github``); not part of the fingerprint or the JSON."""

    src_path: str = ""


class TensorMeta(NamedTuple):
    dtype: torch.dtype
    shape: Tuple[int, ...]
    device: torch.device
    storage: int      # untyped_storage().data_ptr(), 0 where it has none
    nbytes: int       # the storage's bytes


class OpRecord(NamedTuple):
    index: int
    op: str                      # "aten.mul.Tensor", "kernel.fused_limb_sums"
    base: str                    # "aten.mul", "kernel.fused_limb_sums"
    inputs: Tuple[TensorMeta, ...]
    outputs: Tuple[TensorMeta, ...]
    src: str                     # repo-relative file ("" outside)
    line: int
    stack: Tuple[str, ...]       # co_qualname's segments, <locals> dropped
    kwargs: dict                 # the op's non-tensor keyword arguments


def _meta(t: torch.Tensor) -> TensorMeta:
    try:
        st = t.untyped_storage()
        ptr, nbytes = st.data_ptr(), st.nbytes()
    except (RuntimeError, NotImplementedError):  # sparse, nested
        ptr, nbytes = 0, 0
    return TensorMeta(t.dtype, tuple(t.shape), t.device, ptr, nbytes)


@functools.lru_cache(maxsize=4096)
def _code_site(filename: str) -> Optional[str]:
    """The repo-relative path of a source file whose frames count as
    provenance, else None (outside the repository, or the audit)."""
    path = os.path.abspath(filename)
    if not path.startswith(REPO + os.sep) or path.startswith(_AUDIT_DIR):
        return None
    return os.path.relpath(path, REPO).replace(os.sep, "/")


def _provenance(depth: int = 2) -> Tuple[str, int, Tuple[str, ...]]:
    """(repo-relative file, line, qualname segments) of the innermost
    frame inside the repository outside the audit package."""
    f = sys._getframe(depth)
    while f is not None:
        code = f.f_code
        rel = _code_site(code.co_filename)
        if rel is not None:
            return rel, f.f_lineno, tuple(
                s for s in code.co_qualname.split(".") if s != "<locals>")
        f = f.f_back
    return "", 0, ()


@functools.lru_cache(maxsize=256)
def _suppressions(abs_path: str) -> Dict[int, frozenset]:
    try:
        with open(abs_path, encoding="utf-8") as f:
            lines = f.read().splitlines()
    except OSError:
        return {}
    return {k: frozenset(v)
            for k, v in parse_suppressions(lines, "kernaudit").items()}


def tensors_of(obj) -> List[torch.Tensor]:
    """Every tensor of a batch, block, list or dict, children included,
    in order. An explicit stack, not a recursive closure: a closure
    that calls itself is a reference cycle, which would keep the list
    it fills, and so the tensors, alive until the cycle collector
    runs."""
    out: List[torch.Tensor] = []
    stack = [obj]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            stack.extend(getattr(x, fld.name)
                         for fld in reversed(dataclasses.fields(x)))
    return out


def _clone_tree(obj):
    """A copy of a batch with every tensor cloned (K006's stand-in for
    an input the region is handed)."""
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, list):
        return [_clone_tree(y) for y in obj]
    if isinstance(obj, tuple):
        return tuple(_clone_tree(y) for y in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            fld.name: _clone_tree(getattr(obj, fld.name))
            for fld in dataclasses.fields(obj) if fld.init})
    return obj


# -- the kernel hook: one per process, routed by thread ------------------

_tls = threading.local()
_HOOK_LOCK = threading.Lock()
_HOOK_USERS = [0]


def _kernel_hook(name: str, reads, writes) -> None:
    trace = getattr(_tls, "trace", None)
    if trace is not None:
        trace._note("kernel." + name, "kernel." + name, reads, {}, writes)


def _install_hook(trace: "KernelTrace"):
    from ..ops import kernels
    prev = getattr(_tls, "trace", None)
    _tls.trace = trace
    with _HOOK_LOCK:
        _HOOK_USERS[0] += 1
        kernels.TRACE_HOOK = _kernel_hook
    return prev


def _remove_hook(prev) -> None:
    from ..ops import kernels
    _tls.trace = prev
    with _HOOK_LOCK:
        _HOOK_USERS[0] -= 1
        if not _HOOK_USERS[0]:
            kernels.TRACE_HOOK = None


class _Recorder(TorchDispatchMode):
    def __init__(self, trace: "KernelTrace"):
        super().__init__()
        self.trace = trace

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.trace._note(str(func), str(func.overloadpacket), (args, kwargs),
                         kwargs, out)
        return out


class KernelTrace:
    """One lowered closure under audit: its recorded op stream plus the
    facts the passes read.

    `exchange_devices` are the devices the closure is sanctioned to
    move rows between (a mesh's; empty for a single-device closure,
    where any copy between devices is a finding); `footprint_budget_
    bytes` gates K005 (0 = report only). `notes` carries what the
    passes observe (`peak_bytes_estimate`, `donation_plan`, ...) to the
    staging hook. `members` is the member axis of a batch's one program
    (exec/batching.py), 1 for a closure of one query."""

    def __init__(self, label: str, *, device=None,
                 exchange_devices: Iterable = (),
                 footprint_budget_bytes: int = 0, repo: str = REPO,
                 members: int = 1):
        self.label = label
        self.members = int(members)
        self.device = torch.device(device) if device is not None else None
        self.exchange_devices = frozenset(str(torch.device(d))
                                          for d in exchange_devices)
        self.footprint_budget_bytes = int(footprint_budget_bytes)
        self.repo = repo
        self.notes: Dict[str, object] = {}
        self.records: List[OpRecord] = []
        self.fn = None
        # K003: up-cast outputs by tensor identity -> (record, weakref)
        self.upcasts: Dict[int, Tuple[int, weakref.ref]] = {}
        self.consumers: Dict[int, List[int]] = {}
        self.upcasts_returned: set = set()
        # K005: live storages on the trace's device
        self.live_bytes = 0
        self.peak_bytes = 0
        self.peak_at = -1
        self.over_at = -1     # the op that first took it over the budget
        self._live: Dict[tuple, List[int]] = {}
        self._seen: Dict[int, weakref.ref] = {}
        self._finalizers: List[weakref.finalize] = []
        # K006: donated inputs' storages -> input position; those freed
        # during the run (an address the allocator reuses later is a new
        # storage, not the donated one); those alive at its end -> why
        self.donated: Dict[tuple, int] = {}
        self.donated_freed: set = set()
        self.donated_alive: Dict[tuple, str] = {}
        self._open = False

    @classmethod
    def trace(cls, fn, batches: Sequence, label: str,
              donate: Iterable[int] = (), **kw) -> "KernelTrace":
        """Run ``fn(batches)`` once under the recorder (see `run`)."""
        k = cls(label, **kw)
        k.run(fn, batches, donate)
        return k

    # -- recording ------------------------------------------------------

    def run(self, fn, batches: Sequence, donate: Iterable[int] = ()) -> None:
        """Run the closure once over `batches`, recording every op it
        dispatches and every kernel it launches. Each input position in
        `donate` is handed to the closure as a one-shot handoff
        (exec/donation.py) holding a copy of its batch, as the region
        executor hands a dead intermediate over; K006 then reads which
        of the copy's storages outlived the run. The result is
        discarded; an error of the closure propagates."""
        from ..exec.donation import Handoff
        self.fn = fn
        inputs = list(batches)
        donate = sorted(set(int(i) for i in donate))
        if self.device is None:
            ts = tensors_of(inputs)
            self.device = ts[0].device if ts else torch.device("cpu")
        self._track_all(inputs)
        for i in donate:
            inputs[i] = Handoff(_clone_tree(batches[i]))
            self._track_all(inputs[i]._batch, donated=i)
        self.peak_bytes = self.live_bytes
        self._open = True
        prev = _install_hook(self)
        try:
            with _Recorder(self):
                out = fn(inputs)
        finally:
            _remove_hook(prev)
            self._open = False
        del inputs
        out_tensors = tensors_of(out)
        out_ids = {id(t) for t in out_tensors}
        out_keys = {self._key(t) for t in out_tensors}
        for rec, w in self.upcasts.values():
            t = w()
            if t is not None and id(t) in out_ids:
                self.upcasts_returned.add(rec)
        for key, pos in self.donated.items():
            if key not in self.donated_freed:
                self.donated_alive[key] = ("returned in the region's "
                                           "output" if key in out_keys
                                           else "held elsewhere")
        del out, out_tensors
        for fin in self._finalizers:
            fin.detach()
        self._finalizers.clear()
        self._seen.clear()

    def _track_all(self, obj, donated: Optional[int] = None) -> None:
        """Track every tensor of `obj` (a function of its own, so that
        no local of `run` keeps a donated copy alive)."""
        for t in tensors_of(obj):
            self._track(t)
            if donated is not None:
                self.donated.setdefault(self._key(t), donated)

    def _key(self, t: torch.Tensor) -> tuple:
        try:
            ptr = t.untyped_storage().data_ptr()
        except (RuntimeError, NotImplementedError):
            ptr = 0
        return (t.device.type, t.device.index, ptr)

    def _track(self, t: torch.Tensor) -> None:
        """Count `t`'s storage live from now until its last tracked
        tensor dies (K005's liveness; K006 reads it too)."""
        tid = id(t)
        w = self._seen.get(tid)
        if w is not None and w() is t:
            return
        key = self._key(t)
        if key[2] == 0:
            return
        self._seen[tid] = weakref.ref(t)
        entry = self._live.get(key)
        if entry is None:
            try:
                nbytes = t.untyped_storage().nbytes()
            except (RuntimeError, NotImplementedError):
                nbytes = 0
            if t.device != self.device:
                nbytes = 0  # the footprint is the trace device's
            entry = self._live[key] = [0, nbytes]
            self.live_bytes += nbytes
        entry[0] += 1
        self._finalizers.append(
            weakref.finalize(t, self._release, key, tid))

    def _release(self, key: tuple, tid: int) -> None:
        self._seen.pop(tid, None)
        entry = self._live.get(key)
        if entry is None:
            return
        entry[0] -= 1
        if entry[0] <= 0:
            del self._live[key]
            self.live_bytes -= entry[1]
            if key in self.donated:
                self.donated_freed.add(key)

    def _note(self, op: str, base: str, args, kwargs: dict, out) -> None:
        ins = [x for x in tree_leaves(args) if isinstance(x, torch.Tensor)]
        outs = [x for x in tree_leaves(out) if isinstance(x, torch.Tensor)]
        index = len(self.records)
        for t in ins:
            hit = self.upcasts.get(id(t))
            if hit is not None and hit[1]() is t:
                self.consumers.setdefault(hit[0], []).append(index)
        src, line, stack = _provenance(3)
        plain_kw = {k: v for k, v in kwargs.items()
                    if not isinstance(v, torch.Tensor)}
        rec = OpRecord(index, op, base, tuple(_meta(t) for t in ins),
                       tuple(_meta(t) for t in outs), src, line, stack,
                       plain_kw)
        self.records.append(rec)
        for t in outs:
            self._track(t)
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
            self.peak_at = index
            if self.over_at < 0 and self.footprint_budget_bytes and \
                    self.live_bytes > self.footprint_budget_bytes:
                self.over_at = index
        if base == "aten._to_copy" and ins and outs and \
                outs[0].dtype.itemsize > ins[0].dtype.itemsize:
            self.upcasts[id(outs[0])] = (index, weakref.ref(outs[0]))

    # -- provenance helpers for the passes -------------------------------

    def suppressed(self, finding: IRFinding) -> bool:
        """True when the source line a finding traces to carries a
        ``# kernaudit: disable=<code>`` comment."""
        if not finding.src_path or not finding.line:
            return False
        abs_path = finding.src_path if os.path.isabs(finding.src_path) \
            else os.path.join(self.repo, finding.src_path)
        codes = _suppressions(abs_path).get(finding.line)
        return bool(codes) and (finding.code in codes or "all" in codes)

    def finding(self, code: str, rec: OpRecord, message: str) -> IRFinding:
        """A finding anchored at the op's provenance; the source file
        rides in the message (line-independent)."""
        if rec.src:
            message = f"{message} [at {rec.src}]"
        return IRFinding(code=code, path=self.label, line=rec.line, col=0,
                         context=dotted_context(rec.stack), message=message,
                         src_path=rec.src)

    def code_finding(self, code: str, co, message: str) -> IRFinding:
        """A finding anchored at a function's definition (K006, K007:
        the closure that holds or captures the tensor)."""
        rel = _code_site(co.co_filename) if co is not None else None
        stack = tuple(s for s in co.co_qualname.split(".")
                      if s != "<locals>") if co is not None else ()
        if rel:
            message = f"{message} [at {rel}]"
        return IRFinding(code=code, path=self.label,
                         line=co.co_firstlineno if rel else 0, col=0,
                         context=dotted_context(stack) if stack
                         else "<kernel>", message=message,
                         src_path=rel or "")


class AuditPass:
    """Base class: subclass, set the class attributes, implement
    ``run(trace) -> [Finding]``. Inline suppression is the engine's
    job -- passes just report."""

    code: str = "K000"
    name: str = "unnamed"
    description: str = ""

    def run(self, kernel: KernelTrace) -> List[Finding]:
        raise NotImplementedError


_REGISTRY: Dict[str, AuditPass] = {}


def register(cls):
    """Class decorator: instantiate and index the pass by its code."""
    inst = cls()
    assert inst.code not in _REGISTRY or \
        type(_REGISTRY[inst.code]) is cls, \
        f"duplicate audit pass code {inst.code}"
    _REGISTRY[inst.code] = inst
    return cls


def all_passes() -> List[AuditPass]:
    _load_builtin_passes()
    return [_REGISTRY[c] for c in sorted(_REGISTRY)]


def get_pass(code: str) -> AuditPass:
    _load_builtin_passes()
    return _REGISTRY[code]


def _load_builtin_passes() -> None:
    from . import passes  # noqa: F401


@dataclasses.dataclass
class AuditResult:
    findings: List[Finding]
    suppressed: int
    kernels: List[str]        # labels actually audited
    pass_codes: List[str]

    @property
    def kernels_audited(self) -> int:
        return len(self.kernels)


def run_audit(kernels: Sequence[KernelTrace],
              codes: Optional[Iterable[str]] = None) -> AuditResult:
    """Run the selected passes (all registered, by default) over the
    traces; source-comment suppressions are applied here, baselining
    is the caller's (lint/baseline.py)."""
    _load_builtin_passes()
    selected = [get_pass(c) for c in sorted(codes)] if codes else \
        all_passes()
    findings: List[Finding] = []
    suppressed = 0
    labels: List[str] = []
    for k in kernels:
        labels.append(k.label)
        for p in selected:
            for f in p.run(k):
                if isinstance(f, IRFinding) and k.suppressed(f):
                    suppressed += 1
                else:
                    findings.append(f)
    findings.sort(key=Finding.sort_key)
    return AuditResult(findings=findings, suppressed=suppressed,
                       kernels=labels,
                       pass_codes=[p.code for p in selected])
