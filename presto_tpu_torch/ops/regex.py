"""Regular expressions over string columns: compile to a DFA on the
host, scan the byte columns on the device.

The port's own copy of presto_tpu/ops/regex.py: the parser, the Thompson
epsilon-NFA and the subset construction are host-only Python (copied,
not imported); `regexp_like_kernel` is the torch scan. A CONSTANT
pattern compiles once into a DFA over bytes with search semantics (the
start set stays live at every byte, and the accept state is sticky), and
matching every row is then one pass over the W byte columns: per column
one gather `state = table[state, byte]` and an accept-flag OR, with the
virtual BOL and EOL symbols consumed before the first and after the last
byte of each row.

Supported syntax: literals, '.', escapes (\\d \\D \\w \\W \\s \\S and
escaped metacharacters), classes [a-z0-9_] with negation and ranges,
grouping (), alternation |, quantifiers * + ? and bounded {m,n}, anchors
^ $. A pattern outside it, or one that needs more than 255 DFA states,
raises RegexUnsupported, as in the reference; nothing falls back to
Python's `re`.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np
import torch

__all__ = ["compile_dfa", "regexp_like_kernel", "RegexUnsupported"]

_MAX_DFA_STATES = 255


class RegexUnsupported(ValueError):
    pass


# ---------------------------------------------------------------------------
# pattern -> AST
# ---------------------------------------------------------------------------
# AST: ("char", frozenset(bytes)) | ("cat", [a..]) | ("alt", [a..])
#      | ("star", a) | ("plus", a) | ("opt", a) | ("empty",)
#      | ("bol",) | ("eol",)

_ALL = frozenset(range(256))
_DIGIT = frozenset(range(ord("0"), ord("9") + 1))
_WORD = (_DIGIT | frozenset(range(ord("a"), ord("z") + 1))
         | frozenset(range(ord("A"), ord("Z") + 1)) | {ord("_")})
_SPACE = frozenset(b" \t\n\r\f\v")
_ESCAPES = {
    ord("d"): _DIGIT, ord("D"): _ALL - _DIGIT,
    ord("w"): _WORD, ord("W"): _ALL - _WORD,
    ord("s"): _SPACE, ord("S"): _ALL - _SPACE,
}


class _Parser:
    def __init__(self, pat: bytes):
        self.p = pat
        self.i = 0

    def peek(self) -> Optional[int]:
        return self.p[self.i] if self.i < len(self.p) else None

    def next(self) -> int:
        c = self.p[self.i]
        self.i += 1
        return c

    def parse(self):
        ast = self.alt()
        if self.i != len(self.p):
            raise RegexUnsupported(f"trailing {self.p[self.i:]!r}")
        return ast

    def alt(self):
        parts = [self.cat()]
        while self.peek() == ord("|"):
            self.next()
            parts.append(self.cat())
        return parts[0] if len(parts) == 1 else ("alt", parts)

    def cat(self):
        parts = []
        while self.peek() is not None and self.peek() not in (ord("|"),
                                                              ord(")")):
            parts.append(self.repeat())
        if not parts:
            return ("empty",)
        return parts[0] if len(parts) == 1 else ("cat", parts)

    def repeat(self):
        a = self.atom()
        while self.peek() in (ord("*"), ord("+"), ord("?"), ord("{")):
            c = self.next()
            if c == ord("*"):
                a = ("star", a)
            elif c == ord("+"):
                a = ("plus", a)
            elif c == ord("?"):
                a = ("opt", a)
            else:  # {m}, {m,}, {m,n}
                spec = b""
                while self.peek() is not None and self.peek() != ord("}"):
                    spec += bytes([self.next()])
                if self.peek() is None:
                    raise RegexUnsupported("unterminated {")
                self.next()
                txt = spec.decode()
                if "," in txt:
                    lo_s, hi_s = txt.split(",", 1)
                    lo = int(lo_s or 0)
                    hi = int(hi_s) if hi_s else None
                else:
                    lo = hi = int(txt)
                if hi is not None and hi < lo:
                    raise RegexUnsupported("{m,n} with n < m")
                if (hi or lo) > 64:
                    raise RegexUnsupported("{m,n} bound > 64")
                parts = [a] * lo
                if hi is None:
                    parts.append(("star", a))
                else:
                    parts.extend([("opt", a)] * (hi - lo))
                a = ("cat", parts) if parts else ("empty",)
        return a

    def atom(self):
        c = self.next()
        if c == ord("("):
            # non-capturing prefix (?: accepted; captures not tracked
            if self.peek() == ord("?"):
                self.next()
                if self.peek() == ord(":"):
                    self.next()
                else:
                    raise RegexUnsupported("(?...) extension")
            a = self.alt()
            if self.peek() != ord(")"):
                raise RegexUnsupported("unbalanced (")
            self.next()
            return a
        if c == ord("["):
            return ("char", self.char_class())
        if c == ord("."):
            return ("char", _ALL)
        if c == ord("^"):
            return ("bol",)
        if c == ord("$"):
            return ("eol",)
        if c == ord("\\"):
            e = self.next()
            if e in _ESCAPES:
                return ("char", _ESCAPES[e])
            return ("char", frozenset([e]))
        if c in b"*+?{":
            raise RegexUnsupported(f"dangling quantifier {chr(c)!r}")
        return ("char", frozenset([c]))

    def char_class(self):
        neg = False
        if self.peek() == ord("^"):
            neg = True
            self.next()
        chars: Set[int] = set()
        first = True
        while True:
            c = self.peek()
            if c is None:
                raise RegexUnsupported("unterminated [")
            if c == ord("]") and not first:
                self.next()
                break
            first = False
            c = self.next()
            if c == ord("\\"):
                e = self.next()
                if e in _ESCAPES:
                    chars |= _ESCAPES[e]
                    continue
                c = e
            if self.peek() == ord("-") and self.i + 1 < len(self.p) \
                    and self.p[self.i + 1] != ord("]"):
                self.next()
                hi = self.next()
                if hi == ord("\\"):
                    hi = self.next()
                chars |= set(range(c, hi + 1))
            else:
                chars.add(c)
        return frozenset(chars) if not neg else _ALL - frozenset(chars)


# ---------------------------------------------------------------------------
# AST -> epsilon-NFA -> DFA
# ---------------------------------------------------------------------------

# sentinel byte values for anchors (outside 0..255)
_BOL, _EOL = 256, 257


class _NFA:
    def __init__(self):
        self.eps: List[Set[int]] = []
        self.edges: List[List[Tuple[FrozenSet[int], int]]] = []

    def state(self) -> int:
        self.eps.append(set())
        self.edges.append([])
        return len(self.eps) - 1

    def build(self, ast, s: int, t: int):
        """Wire `ast` between states s -> t."""
        kind = ast[0]
        if kind == "empty":
            self.eps[s].add(t)
        elif kind == "char":
            self.edges[s].append((ast[1], t))
        elif kind in ("bol", "eol"):
            self.edges[s].append((frozenset([_BOL if kind == "bol"
                                             else _EOL]), t))
        elif kind == "cat":
            cur = s
            for part in ast[1][:-1]:
                nxt = self.state()
                self.build(part, cur, nxt)
                cur = nxt
            self.build(ast[1][-1], cur, t)
        elif kind == "alt":
            for part in ast[1]:
                a, b = self.state(), self.state()
                self.eps[s].add(a)
                self.eps[b].add(t)
                self.build(part, a, b)
        elif kind == "star":
            a, b = self.state(), self.state()
            self.eps[s].update((a, t))
            self.eps[b].update((a, t))
            self.build(ast[1], a, b)
        elif kind == "plus":
            a, b = self.state(), self.state()
            self.eps[s].add(a)
            self.eps[b].update((a, t))
            self.build(ast[1], a, b)
        elif kind == "opt":
            self.eps[s].add(t)
            self.build(ast[1], s, t)
        else:  # pragma: no cover
            raise RegexUnsupported(kind)


def _eclose(nfa: _NFA, states: FrozenSet[int]) -> FrozenSet[int]:
    out = set(states)
    work = list(states)
    while work:
        s = work.pop()
        for t in nfa.eps[s]:
            if t not in out:
                out.add(t)
                work.append(t)
    return frozenset(out)


@lru_cache(maxsize=256)
def compile_dfa(pattern: str):
    """Pattern -> (table (S, 258) uint8, accepting (S,) bool). Symbol
    258/257 columns are the virtual BOL/EOL anchors consumed before the
    first and after the last char of each row. Search semantics: the
    DFA is for `.*(pattern)` with a sticky accept state. Cached: the
    validator pre-compiles the same pattern the evaluator uses."""
    try:
        ast = _Parser(pattern.encode("utf-8")).parse()
    except (IndexError, ValueError) as e:
        if isinstance(e, RegexUnsupported):
            raise
        raise RegexUnsupported(
            f"malformed pattern {pattern!r}: {type(e).__name__}") from e
    nfa = _NFA()
    start, accept = nfa.state(), nfa.state()
    # search: allow skipping any prefix BEFORE consuming BOL is wrong --
    # instead: optional ^: if the pattern starts with BOL, no skip; the
    # generic transform is (.*)pattern, with .* built as a start
    # self-loop added AFTER the BOL anchor step below.
    nfa.build(ast, start, accept)

    d0 = _eclose(nfa, frozenset([start]))
    states: Dict[FrozenSet[int], int] = {d0: 0}
    order: List[FrozenSet[int]] = [d0]
    table_rows: List[List[int]] = []
    accepting: List[bool] = []
    ACCEPT_SINK = None

    i = 0
    while i < len(order):
        cur = order[i]
        i += 1
        row = [0] * 258
        acc = accept in cur
        for sym in range(258):
            targets: Set[int] = set()
            for s in cur:
                for chars, t in nfa.edges[s]:
                    if sym in chars:
                        targets.add(t)
            if sym < 256:
                # search semantics: a new match may start at any
                # position -> the start set is always live
                targets |= set(d0)
            else:
                # anchors: states that don't consume the anchor persist
                targets |= set(cur)
            nxt = _eclose(nfa, frozenset(targets))
            if nxt not in states:
                if len(states) > _MAX_DFA_STATES:
                    raise RegexUnsupported(
                        f"pattern needs > {_MAX_DFA_STATES} DFA states")
                states[nxt] = len(order)
                order.append(nxt)
            row[sym] = states[nxt]
        table_rows.append(row)
        accepting.append(acc)

    table = np.asarray(table_rows, dtype=np.uint8)
    return table, np.asarray(accepting, dtype=bool)


def regexp_like_kernel(chars: torch.Tensor, lengths: torch.Tensor,
                       table: np.ndarray, accepting: np.ndarray
                       ) -> torch.Tensor:
    """(N,) bool: the DFA of `compile_dfa` finds a match in the row.
    One gather of the flattened table per byte column; a byte past the
    row's length leaves the state as it is."""
    n, w = chars.shape
    dev = chars.device
    tbl = torch.from_numpy(table.astype(np.int64).reshape(-1)).to(dev)
    acc = torch.from_numpy(accepting).to(dev)
    nsym = table.shape[1]
    state = tbl[256].expand(n)  # consume BOL from state 0
    matched = acc[state]
    cols = chars.to(torch.int64)
    for j in range(w):
        live = j < lengths
        state = torch.where(live, tbl[state * nsym + cols[:, j]], state)
        matched = matched | (live & acc[state])
    state = tbl[state * nsym + 257]  # consume EOL
    return matched | acc[state]
