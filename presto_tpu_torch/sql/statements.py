"""Meta statements: SHOW / DESCRIBE rewrites and prepared statements.

The port's copy of presto_tpu/sql/statements.py. `preprocess` is the
one entry: given raw statement text it returns either rewritten SQL to
execute, or an immediate acknowledgment (PREPARE, DEALLOCATE, CREATE
and DROP FUNCTION), or the text untouched. Prepared statements
substitute `?` parameters textually with the EXECUTE ... USING
expressions before parsing.

SHOW CATALOGS, SHOW SESSION and SHOW FUNCTIONS read the system
connector's `catalogs`, `session_properties` and `functions` tables,
as in the reference; SHOW SCHEMAS, TABLES and COLUMNS and DESCRIBE
read information_schema.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Tuple

__all__ = ["Preprocessed", "preprocess", "PreparedStatements"]


class PreparedStatements(dict):
    """Session-scoped name -> statement text registry."""


# the sql() front door's process-wide session (server sessions carry
# their own PreparedStatements)
_DEFAULT_PREPARED = PreparedStatements()


_SHOW_RE = re.compile(
    r"^\s*show\s+(catalogs|schemas|tables|columns|session|functions)\b(.*)$",
    re.IGNORECASE | re.DOTALL)
_DESCRIBE_RE = re.compile(r"^\s*(?:describe|desc)\s+([\w.]+)\s*$",
                          re.IGNORECASE)
_PREPARE_RE = re.compile(r"^\s*prepare\s+(\w+)\s+from\s+(.*)$",
                         re.IGNORECASE | re.DOTALL)
_EXECUTE_RE = re.compile(r"^\s*execute\s+(\w+)(?:\s+using\s+(.*))?\s*$",
                         re.IGNORECASE | re.DOTALL)
_DEALLOC_RE = re.compile(r"^\s*deallocate\s+prepare\s+(\w+)\s*$",
                         re.IGNORECASE)


@dataclasses.dataclass
class Preprocessed:
    text: Optional[str] = None      # SQL to run (rewritten or original)
    ack: Optional[str] = None       # immediate update-type acknowledgment
    columns: Optional[List[str]] = None


def _split_table(name: str, catalog: str) -> Tuple[str, str]:
    parts = name.split(".")
    if len(parts) == 1:
        return catalog, parts[0]
    if len(parts) == 2:
        return parts[0], parts[1]
    # catalog.schema.table: the single-schema registry ignores schema
    return parts[0], parts[2]


def _split_using(args: str) -> List[str]:
    """Split EXECUTE ... USING arguments on top-level commas (strings
    and parens respected)."""
    out, depth, cur, i = [], 0, [], 0
    in_str = False
    while i < len(args):
        ch = args[i]
        if in_str:
            cur.append(ch)
            if ch == "'":
                if i + 1 < len(args) and args[i + 1] == "'":
                    cur.append("'")
                    i += 1
                else:
                    in_str = False
        elif ch == "'":
            in_str = True
            cur.append(ch)
        elif ch == "(":
            depth += 1
            cur.append(ch)
        elif ch == ")":
            depth -= 1
            cur.append(ch)
        elif ch == "," and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
        i += 1
    tail = "".join(cur).strip()
    if tail:
        out.append(tail)
    return out


def _substitute_params(text: str, params: List[str]) -> str:
    """Replace `?` placeholders (outside string literals) in order."""
    out, i, p = [], 0, 0
    in_str = False
    while i < len(text):
        ch = text[i]
        if in_str:
            out.append(ch)
            if ch == "'":
                in_str = False
        elif ch == "'":
            in_str = True
            out.append(ch)
        elif ch == "?":
            if p >= len(params):
                raise ValueError(
                    f"prepared statement has more parameters than the "
                    f"{len(params)} provided")
            out.append(f"({params[p]})")
            p += 1
        else:
            out.append(ch)
        i += 1
    if p != len(params):
        raise ValueError(f"prepared statement takes {p} parameter(s), "
                         f"{len(params)} provided")
    return "".join(out)


_FROM_LIKE_RE = re.compile(
    r"^(?:(?:from|in)\s+([\w.]+))?\s*(?:like\s+'((?:[^']|'')*)')?\s*$",
    re.IGNORECASE)


def _from_and_like(rest: str, default_catalog: str):
    """Parse the [FROM catalog] [LIKE 'pattern'] tail of SHOW
    TABLES/SCHEMAS. Unrecognized tails raise instead of silently
    returning the unfiltered set."""
    m = _FROM_LIKE_RE.match(rest)
    if not m:
        raise ValueError(f"cannot parse SHOW clause tail: {rest!r}")
    cat = (m.group(1) or default_catalog).split(".")[0]
    return cat, m.group(2)


def preprocess(text: str, catalog: str = "tpch",
               prepared: Optional[PreparedStatements] = None
               ) -> Preprocessed:
    from .udf import (get_function_namespace_manager,
                      parse_create_function, parse_drop_function)
    cf = parse_create_function(text)
    if cf is not None:
        fn, replace = cf
        get_function_namespace_manager().register(fn, replace=replace)
        return Preprocessed(ack="CREATE FUNCTION")
    df = parse_drop_function(text)
    if df is not None:
        name, if_exists = df
        get_function_namespace_manager().drop(name, if_exists=if_exists)
        return Preprocessed(ack="DROP FUNCTION")
    m = _PREPARE_RE.match(text)
    if m:
        if prepared is None:
            raise ValueError("no prepared-statement session")
        prepared[m.group(1).lower()] = m.group(2).strip()
        return Preprocessed(ack="PREPARE")
    m = _DEALLOC_RE.match(text)
    if m:
        if prepared is None or m.group(1).lower() not in prepared:
            raise KeyError(f"prepared statement {m.group(1)!r} not found")
        del prepared[m.group(1).lower()]
        return Preprocessed(ack="DEALLOCATE")
    m = _EXECUTE_RE.match(text)
    if m:
        if prepared is None or m.group(1).lower() not in prepared:
            raise KeyError(f"prepared statement {m.group(1)!r} not found")
        body = prepared[m.group(1).lower()]
        params = _split_using(m.group(2)) if m.group(2) else []
        return Preprocessed(text=_substitute_params(body, params))
    m = _DESCRIBE_RE.match(text)
    if m:
        cat, tab = _split_table(m.group(1), catalog)
        return Preprocessed(text=(
            "SELECT column_name AS Column, data_type AS Type, "
            "is_nullable AS Null FROM information_schema.columns "
            f"WHERE table_catalog = '{cat}' AND table_name = '{tab}' "
            "ORDER BY ordinal_position"))
    m = _SHOW_RE.match(text)
    if m:
        kind = m.group(1).lower()
        rest = m.group(2).strip().rstrip(";").strip()
        if kind == "catalogs":
            return Preprocessed(text=(
                "SELECT catalog_name AS Catalog FROM system.catalogs "
                "ORDER BY catalog_name"))
        if kind == "schemas":
            cat, like = _from_and_like(rest, catalog)
            return Preprocessed(text=(
                "SELECT schema_name AS Schema FROM "
                "information_schema.schemata "
                f"WHERE catalog_name = '{cat}'"
                + (f" AND schema_name LIKE '{like}'" if like else "")
                + " ORDER BY schema_name"))
        if kind == "tables":
            cat, like = _from_and_like(rest, catalog)
            return Preprocessed(text=(
                "SELECT table_name AS Table FROM information_schema.tables "
                f"WHERE table_catalog = '{cat}'"
                + (f" AND table_name LIKE '{like}'" if like else "")
                + " ORDER BY table_name"))
        if kind == "columns":
            mm = re.match(r"(?:from|in)\s+([\w.]+)$", rest, re.IGNORECASE)
            if not mm:
                raise ValueError("SHOW COLUMNS needs FROM <table>")
            cat, tab = _split_table(mm.group(1), catalog)
            return Preprocessed(text=(
                "SELECT column_name AS Column, data_type AS Type, "
                "is_nullable AS Null FROM information_schema.columns "
                f"WHERE table_catalog = '{cat}' AND table_name = '{tab}' "
                "ORDER BY ordinal_position"))
        if kind == "session":
            return Preprocessed(text=(
                "SELECT name AS Name, default_value AS Value, type AS Type, "
                "description AS Description FROM system.session_properties "
                "ORDER BY name"))
        if kind == "functions":
            return Preprocessed(text=(
                "SELECT function_name AS Function, kind AS Kind "
                "FROM system.functions ORDER BY function_name"))
    return Preprocessed(text=text)
