"""The finding model: one diagnostic, its line-independent fingerprint,
inline suppressions and the GitHub annotation line.

Counterpart of presto_tpu/lint/core.py's `Finding`, its suppression
comments and presto_tpu/lint/cli.py's `github_annotation`, with the
same fingerprint law (every field except the line and column), so a
baseline written by either package reads in the other.

Suppressions: ``# tpulint: disable=H001`` (or ``disable=H001,W001``,
or ``disable=all``) on the finding's own line; the kernel audit's
comments are ``# kernaudit: disable=K001`` on the source line an op
traces back to (audit/core.py).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import re
from typing import Dict, Iterable, Set

__all__ = ["REPO", "Finding", "dotted_context", "parse_suppressions",
           "github_annotation"]

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def dotted_context(stack) -> str:
    """Human context for a class/function name stack: the last two
    segments dotted (``Cls.method``), or ``<module>`` at top level."""
    stack = list(stack)
    if len(stack) > 1:
        return ".".join(stack[-2:])
    return stack[0] if stack else "<module>"


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
