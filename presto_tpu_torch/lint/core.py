"""tpulint core of the port: the pass registry, the finding model and
the run engine.

Counterpart of presto_tpu/lint/core.py, with the same fingerprint law
(every field except the line and column), so a baseline written by
either package reads in the other, and of presto_tpu/lint/cli.py's
`github_annotation`. The kernel audit (presto_tpu_torch/audit/)
reports through the same `Finding`.

  * ``Finding`` -- one diagnostic: pass code, file, line, enclosing
    context (dotted function path), message. Its ``fingerprint``
    hashes everything EXCEPT the line and column.
  * ``LintPass`` -- one per rule family: ``code``, ``TARGETS``
    (repo-relative globs over the port's own files) and
    ``run(module) -> [Finding]``, registered with ``@register``;
    importing ``presto_tpu_torch.lint.passes`` registers the eleven.
  * ``ModuleSource`` -- one parsed file shared by every pass, with its
    suppressions pre-extracted.
  * ``run_passes`` -- map the passes over files, drop the findings the
    source suppressed inline, return a ``LintResult``.
  * ``traced_closure`` / ``lowering_scope`` -- where the port's
    counterparts of a jitted body are: the code a lowered closure runs
    (H001), and the code that runs once while it is lowered (R001).

Suppressions: ``# tpulint: disable=H001`` (or ``disable=H001,W001``,
or ``disable=all``) on the finding's own line; the kernel audit's
comments are ``# kernaudit: disable=K001`` on the source line an op
traces back to (audit/core.py). The passes read source only: nothing
here touches a device.
"""

from __future__ import annotations

import ast
import dataclasses
import glob as _glob
import hashlib
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set

__all__ = ["REPO", "PACKAGE", "Finding", "ModuleSource", "LintPass",
           "register", "all_passes", "get_pass", "LintResult",
           "run_passes", "dotted_context", "parse_suppressions",
           "github_annotation", "traced_closure", "lowering_scope",
           "LOWERING_MODULE"]

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PACKAGE = "presto_tpu_torch"

# the module whose compile_plan lowers a plan to the closure the plan
# cache keeps (exec/plan_cache.py)
LOWERING_MODULE = f"{PACKAGE}/exec/planner.py"
LOWERING_FUNC = "compile_plan"
# the modules whose functions a lowered closure calls op by op
_CLOSURE_TIERS = (f"{PACKAGE}/ops/", f"{PACKAGE}/expr/")


def dotted_context(stack) -> str:
    """Human context for a class/function name stack: the last two
    segments dotted (``Cls.method``), or ``<module>`` at top level."""
    stack = list(stack)
    if len(stack) > 1:
        return ".".join(stack[-2:])
    return stack[0] if stack else "<module>"


def _jit_decorated(node: ast.AST) -> bool:
    """A jit decorator in any spelling (``@jax.jit``, ``@jit``,
    ``@partial(jax.jit, ...)``): how a file outside the port, the
    reference's lint fixtures among them, marks a traced body."""
    for dec in getattr(node, "decorator_list", ()):
        for sub in ast.walk(dec):
            if isinstance(sub, ast.Attribute) and sub.attr == "jit":
                return True
            if isinstance(sub, ast.Name) and sub.id == "jit":
                return True
    return False


def traced_closure(rel_path: str, funcs: Sequence[ast.AST]) -> bool:
    """Whether code inside ``funcs`` (the enclosing function defs,
    outermost first) runs inside a lowered closure -- the port's
    counterpart of a jitted body, which H001 reads.

    The port lowers a plan to a Python closure (exec/planner.py's
    ``compile_plan``), which calls the functions of ``ops/`` and
    ``expr/`` op by op on every dispatch. So: every function of those
    two tiers; in exec/planner.py the closures ``compile_plan`` builds
    (its nested defs), not its own body, which runs once per lowering;
    elsewhere a function under a jit decorator."""
    if not funcs:
        return False
    if rel_path.startswith(_CLOSURE_TIERS):
        return True
    if rel_path == LOWERING_MODULE:
        return len(funcs) > 1 and \
            getattr(funcs[0], "name", None) == LOWERING_FUNC
    return any(_jit_decorated(f) for f in funcs)


def lowering_scope(rel_path: str, funcs: Sequence[ast.AST]) -> bool:
    """Whether code inside ``funcs`` runs once, when a closure is
    lowered, so that what it reads is kept in the cached closure and
    served on every cache hit: the body of exec/planner.py's
    ``compile_plan`` outside the closures it builds; elsewhere a jit
    decorated body (its trace)."""
    if not funcs:
        return False
    if rel_path == LOWERING_MODULE:
        return len(funcs) == 1 and \
            getattr(funcs[0], "name", None) == LOWERING_FUNC
    if rel_path.startswith(f"{PACKAGE}/"):
        return False
    return any(_jit_decorated(f) for f in funcs)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic. ``path`` is repo-relative with forward slashes
    (for the kernel audit: the kernel's label); ``context`` is the
    dotted enclosing function/class path (``<module>`` at top level)."""

    code: str
    path: str
    line: int
    col: int
    context: str
    message: str

    @property
    def fingerprint(self) -> str:
        """Line-independent identity: survives edits that only move a
        grandfathered site. Two identical findings in the same function
        share a fingerprint -- the baseline stores a count."""
        raw = f"{self.code}|{self.path}|{self.context}|{self.message}"
        return hashlib.sha1(raw.encode()).hexdigest()[:16]

    def sort_key(self):
        return (self.path, self.line, self.col, self.code, self.message)

    def to_json(self) -> dict:
        return {"code": self.code, "path": self.path, "line": self.line,
                "col": self.col, "context": self.context,
                "message": self.message, "fingerprint": self.fingerprint}

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.code} "
                f"[{self.context}] {self.message}")


def parse_suppressions(lines: Iterable[str], tool: str = "tpulint"
                       ) -> Dict[int, Set[str]]:
    """{line number: codes} of ``# <tool>: disable=...`` comments, 1-based,
    ``all`` kept as a code of its own."""
    pat = re.compile(r"#\s*" + re.escape(tool)
                     + r":\s*disable=([A-Za-z0-9_,\s]+|all)")
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(lines, start=1):
        if tool not in line:
            continue
        m = pat.search(line)
        if m:
            out[i] = {c.strip() for c in m.group(1).split(",") if c.strip()}
    return out


def _gh_escape(s: str, prop: bool = False) -> str:
    """GitHub workflow-command data escaping: %, CR, LF everywhere;
    property values additionally escape ',' and ':'."""
    out = (str(s).replace("%", "%25").replace("\r", "%0D")
           .replace("\n", "%0A"))
    if prop:
        out = out.replace(",", "%2C").replace(":", "%3A")
    return out


def github_annotation(path: str, line: int, title: str,
                      message: str) -> str:
    """One ``::error`` GitHub Actions annotation line, the ``--format
    github`` output unit."""
    return (f"::error file={_gh_escape(path, prop=True)},"
            f"line={int(line)},"
            f"title={_gh_escape(title, prop=True)}::{_gh_escape(message)}")


class ModuleSource:
    """One parsed source file, shared by every pass that targets it."""

    def __init__(self, rel_path: str, repo: str = REPO,
                 text: Optional[str] = None):
        self.rel_path = rel_path.replace(os.sep, "/")
        self.abs_path = os.path.join(repo, rel_path)
        if text is None:
            with open(self.abs_path, encoding="utf-8") as f:
                text = f.read()
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=self.rel_path)
        self._suppressions = parse_suppressions(self.lines)

    @property
    def basename(self) -> str:
        return os.path.basename(self.rel_path)

    def suppressed(self, code: str, line: int) -> bool:
        codes = self._suppressions.get(line)
        return bool(codes) and (code in codes or "all" in codes)

    def finding(self, code: str, node: ast.AST, context: str,
                message: str) -> Finding:
        return Finding(code=code, path=self.rel_path,
                       line=getattr(node, "lineno", 0),
                       col=getattr(node, "col_offset", 0),
                       context=context, message=message)


class LintPass:
    """Base class: subclass, set the class attributes, implement run().

    ``TARGETS`` are repo-relative globs the pass scans when the CLI is
    given no files. An explicit file outside every selected pass's
    targets runs through all of them (how the fixtures exercise each
    pass)."""

    code: str = "X000"
    name: str = "unnamed"
    description: str = ""
    TARGETS: Sequence[str] = ()

    def target_files(self, repo: str = REPO) -> List[str]:
        files: List[str] = []
        for pat in self.TARGETS:
            matches = sorted(_glob.glob(os.path.join(repo, pat)))
            files.extend(os.path.relpath(m, repo).replace(os.sep, "/")
                         for m in matches if m.endswith(".py"))
        return files

    def run(self, module: ModuleSource) -> List[Finding]:
        raise NotImplementedError


_REGISTRY: Dict[str, LintPass] = {}


def register(cls):
    """Class decorator: instantiate and index the pass by its code."""
    inst = cls()
    assert inst.code not in _REGISTRY or \
        type(_REGISTRY[inst.code]) is cls, \
        f"duplicate pass code {inst.code}"
    _REGISTRY[inst.code] = inst
    return cls


def all_passes() -> List[LintPass]:
    _load_builtin_passes()
    return [_REGISTRY[c] for c in sorted(_REGISTRY)]


def get_pass(code: str) -> LintPass:
    _load_builtin_passes()
    return _REGISTRY[code]


def _load_builtin_passes() -> None:
    # importing the package registers every built-in pass exactly once
    from . import passes  # noqa: F401


@dataclasses.dataclass
class LintResult:
    findings: List[Finding]
    suppressed: int
    files: List[str]  # repo-relative paths actually scanned
    pass_codes: List[str]

    @property
    def files_scanned(self) -> int:
        return len(self.files)


def run_passes(codes: Optional[Iterable[str]] = None,
               paths: Optional[Sequence[str]] = None,
               repo: str = REPO) -> LintResult:
    """Run the selected passes (all registered, by default) over their
    targets, or over ``paths`` (repo-relative or absolute). Inline
    suppressions apply here; the baseline is the caller's concern.

    An explicit file inside SOME selected pass's targets is scanned
    only by the passes that own it; a file outside every one (a
    fixture, a scratch file) runs through all of them. An unreadable or
    unparseable file raises (the CLI exits 2)."""
    _load_builtin_passes()
    selected = [get_pass(c) for c in sorted(codes)] if codes else \
        all_passes()
    sources: Dict[str, ModuleSource] = {}

    def source_of(rel: str) -> ModuleSource:
        if rel not in sources:
            sources[rel] = ModuleSource(rel, repo)
        return sources[rel]

    explicit: Optional[List[str]] = None
    if paths is not None:
        explicit = []
        for p in paths:
            ap = p if os.path.isabs(p) else os.path.join(os.getcwd(), p)
            explicit.append(
                os.path.relpath(ap, repo).replace(os.sep, "/"))

    target_sets: Dict[str, Set[str]] = {}
    union: Set[str] = set()
    if explicit is not None:
        for p in selected:
            target_sets[p.code] = set(p.target_files(repo))
            union |= target_sets[p.code]

    findings: List[Finding] = []
    suppressed = 0
    for p in selected:
        if explicit is not None:
            files = [f for f in explicit
                     if f in target_sets[p.code] or f not in union]
        else:
            files = p.target_files(repo)
        for rel in files:
            ms = source_of(rel)
            for f in p.run(ms):
                if ms.suppressed(f.code, f.line):
                    suppressed += 1
                else:
                    findings.append(f)
    findings.sort(key=Finding.sort_key)
    return LintResult(findings=findings, suppressed=suppressed,
                      files=sorted(sources),
                      pass_codes=[p.code for p in selected])
