"""Pattern-matching DSL for optimizer rules.

The port's copy of presto_tpu/plan/matching.py (presto-matching's
Pattern, Matcher and Capture): a tree-shaped Pattern matched directly
against plan nodes, which are plain dataclasses."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

from . import nodes as N

__all__ = ["Capture", "Match", "Pattern", "node"]


class Capture:
    """An opaque handle naming a sub-match (presto-matching Capture)."""
    __slots__ = ("name",)

    def __init__(self, name: str = ""):
        self.name = name

    def __repr__(self):
        return f"Capture({self.name})"


@dataclasses.dataclass
class Match:
    """A successful match: the matched node + captured sub-nodes."""
    node: N.PlanNode
    captures: Dict[Capture, N.PlanNode]

    def __getitem__(self, c: Capture) -> N.PlanNode:
        return self.captures[c]


@dataclasses.dataclass(frozen=True)
class Pattern:
    """Matches a node by class, optional predicate, optional per-source
    sub-patterns, and optional capture."""
    klass: Optional[type] = None
    predicate: Optional[Callable[[N.PlanNode], bool]] = None
    source_patterns: Tuple["Pattern", ...] = ()
    capture: Optional[Capture] = None

    def matching(self, predicate: Callable[[N.PlanNode], bool]) -> "Pattern":
        prev = self.predicate
        pred = predicate if prev is None else \
            (lambda n, a=prev, b=predicate: a(n) and b(n))
        return dataclasses.replace(self, predicate=pred)

    def with_source(self, *patterns: "Pattern") -> "Pattern":
        """Constrain the node's sources positionally (one pattern per
        source; fewer patterns than sources leaves the rest free)."""
        return dataclasses.replace(self, source_patterns=patterns)

    def captured_as(self, capture: Capture) -> "Pattern":
        return dataclasses.replace(self, capture=capture)

    def match(self, n: N.PlanNode) -> Optional[Match]:
        caps: Dict[Capture, N.PlanNode] = {}
        return Match(n, caps) if self._match_into(n, caps) else None

    def _match_into(self, n, caps) -> bool:
        if self.klass is not None and not isinstance(n, self.klass):
            return False
        if self.predicate is not None and not self.predicate(n):
            return False
        if self.source_patterns:
            srcs = n.sources
            if len(srcs) < len(self.source_patterns):
                return False
            for p, s in zip(self.source_patterns, srcs):
                if not p._match_into(s, caps):
                    return False
        if self.capture is not None:
            caps[self.capture] = n
        return True


def node(klass: Optional[type] = None) -> Pattern:
    """Entry point: `node(N.FilterNode)` / `node()` (any node)."""
    return Pattern(klass)
