"""SQL-invoked functions and the function namespace manager.

The port's copy of presto_tpu/sql/udf.py. A SQL function is a typed
macro (CREATE FUNCTION ... RETURNS ... RETURN <expr>): at plan time
its body expands inline with the parameters bound to the argument
expressions, so the plan holds only ordinary expressions.

    CREATE FUNCTION my.math.double_it(x bigint) RETURNS bigint
        RETURN x * 2
    SELECT my.math.double_it(nationkey) FROM nation
    DROP FUNCTION my.math.double_it

Unqualified names register under the default namespace
`presto.default` and are callable unqualified."""

from __future__ import annotations

import dataclasses
import re
import threading
from typing import Dict, List, Optional, Tuple

from .. import types as T

__all__ = ["SqlFunction", "FunctionNamespaceManager",
           "get_function_namespace_manager", "reset_functions",
           "parse_create_function", "parse_drop_function"]

DEFAULT_NAMESPACE = "presto.default"


@dataclasses.dataclass(frozen=True)
class SqlFunction:
    qualified_name: str                 # catalog.schema.name
    parameters: Tuple[Tuple[str, T.Type], ...]
    return_type: T.Type
    body_sql: str                       # the RETURN expression text


class FunctionNamespaceManager:
    """In-memory namespace registry (the mysql/rest-backed managers'
    serving surface; storage is not the architecture)."""

    def __init__(self):
        self._fns: Dict[str, SqlFunction] = {}
        self._lock = threading.Lock()

    def register(self, fn: SqlFunction, replace: bool = False) -> None:
        with self._lock:
            old = self._fns.get(fn.qualified_name)
            if old is not None and not replace:
                raise KeyError(
                    f"function {fn.qualified_name!r} already exists")
            if old is not None:
                _evict_ast(old)
            self._fns[fn.qualified_name] = fn

    def drop(self, qualified_name: str, if_exists: bool = False) -> None:
        with self._lock:
            old = self._fns.pop(self._resolve_key(qualified_name), None)
            if old is None and not if_exists:
                raise KeyError(f"no function {qualified_name!r}")
            if old is not None:
                _evict_ast(old)

    def _resolve_key(self, name: str) -> str:
        if "." not in name:
            return f"{DEFAULT_NAMESPACE}.{name}"
        return name

    def lookup(self, name: str) -> Optional[SqlFunction]:
        with self._lock:
            return self._fns.get(self._resolve_key(name.lower()))

    def list_functions(self) -> List[SqlFunction]:
        with self._lock:
            return sorted(self._fns.values(),
                          key=lambda f: f.qualified_name)


_manager = FunctionNamespaceManager()

# parsed-body cache: bodies parse ONCE (at registration, which also
# surfaces syntax errors at CREATE FUNCTION time, and on first lookup
# after an engine restart)
_AST_CACHE: Dict[str, object] = {}


def _evict_ast(fn: SqlFunction) -> None:
    _AST_CACHE.pop(f"{fn.qualified_name}\x00{fn.body_sql}", None)


def body_ast(fn: SqlFunction):
    key = f"{fn.qualified_name}\x00{fn.body_sql}"
    hit = _AST_CACHE.get(key)
    if hit is None:
        from .parser import parse_expression
        hit = _AST_CACHE[key] = parse_expression(fn.body_sql)
    return hit


def get_function_namespace_manager() -> FunctionNamespaceManager:
    return _manager


def reset_functions() -> None:
    _manager._fns.clear()
    _AST_CACHE.clear()


_CREATE_RE = re.compile(
    r"^\s*create\s+(or\s+replace\s+)?function\s+([\w.]+)\s*\((.*?)\)\s*"
    r"returns\s+(.+?)\s+return\s+(.*)$",
    re.IGNORECASE | re.DOTALL)
_DROP_RE = re.compile(
    r"^\s*drop\s+function\s+(if\s+exists\s+)?([\w.]+)\s*$",
    re.IGNORECASE)


def _split_params(text: str) -> List[Tuple[str, T.Type]]:
    out = []
    depth = 0
    cur: List[str] = []
    parts: List[str] = []
    for ch in text:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    tail = "".join(cur).strip()
    if tail:
        parts.append(tail)
    for p in parts:
        p = p.strip()
        if not p:
            continue
        bits = p.split(None, 1)  # any whitespace (tabs, newlines)
        if len(bits) != 2:
            raise ValueError(f"parameter {p!r} needs `name type`")
        out.append((bits[0].lower(), T.parse_type(bits[1].strip())))
    return out


def parse_create_function(text: str) -> Optional[Tuple[SqlFunction, bool]]:
    """CREATE [OR REPLACE] FUNCTION f(a t, ...) RETURNS t RETURN expr
    -> (SqlFunction, replace) or None when `text` is something else."""
    m = _CREATE_RE.match(text.strip().rstrip(";"))
    if not m:
        return None
    replace = bool(m.group(1))
    name = m.group(2).lower()
    if "." not in name:
        name = f"{DEFAULT_NAMESPACE}.{name}"
    params = tuple(_split_params(m.group(3)))
    rty = T.parse_type(m.group(4).strip())
    fn = SqlFunction(name, params, rty, m.group(5).strip())
    body_ast(fn)  # syntax errors surface at CREATE FUNCTION time
    return fn, replace


def parse_drop_function(text: str) -> Optional[Tuple[str, bool]]:
    m = _DROP_RE.match(text.strip().rstrip(";"))
    if not m:
        return None
    return m.group(2).lower(), bool(m.group(1))
