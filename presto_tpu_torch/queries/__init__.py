"""The corpora the port is held to: the reference's own plans and rows,
committed as data.

`tpch_sf1.json` holds, for each query of the corpus that the port runs,
its SQL text ("sql"), the plan-fragment JSON that presto_tpu prepares
for it at SF1 and the rows presto_tpu's run_query returns for that
plan, in an exact form:
integers and decimals as their scaled integers, dates as days since
epoch, strings as text, booleans as booleans, doubles as `float.hex`
and NULL as null. `scripts/make_tpch_corpus.py` writes the file from
presto_tpu; this module only reads it, so the port needs nothing of
the reference to check itself against it.

`functions.json` holds the statements of the scalar function library:
the reference's flat function tests ("statements": plan and rows at sf
0.01), those of its tests that take arrays, maps, rows or lambdas
("later": plan and rows at sf 0.01, nested values in the exact form of
`exact_value`), and the statements the card times ("timed": plan and
rows at sf 0.01 and at SF1); `scripts/make_functions_corpus.py`
writes it and `load_functions_corpus` reads it.

`tpcds.json` holds, for each of the 99 TPC-DS queries, its SQL text
("sql"), the reference's prepared plan and rows at the query's suite
scale factor, and its plan
prepared at the scale the card times it at, SF1 but for q72
(`scripts/make_tpcds_corpus.py` writes it; plans and
rows are zlib-compressed, base64-encoded JSON, decoded by
`load_tpcds_corpus`).
"""

from __future__ import annotations

import base64
import json
import os
import zlib
from typing import Dict, List

import numpy as np

from .. import types as T

__all__ = ["CORPUS_PATH", "TPCDS_CORPUS_PATH", "FUNCTIONS_CORPUS_PATH",
           "load_corpus", "load_tpcds_corpus", "load_functions_corpus",
           "exact_rows", "exact_value"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CORPUS_PATH = os.path.join(_HERE, "tpch_sf1.json")
TPCDS_CORPUS_PATH = os.path.join(_HERE, "tpcds.json")
FUNCTIONS_CORPUS_PATH = os.path.join(_HERE, "functions.json")


def exact_value(v, ty: T.Type):
    """One result value in the corpus's exact, JSON-able form: an array
    is a list of exact values, a map a list of [key, value] pairs in
    entry order (JSON has no integer keys), and a row a list."""
    if v is None:
        return None
    if ty.base == "array":
        return [exact_value(x, ty.element_type) for x in v]
    if ty.base == "map":
        return [[exact_value(k, ty.key_type), exact_value(x, ty.value_type)]
                for k, x in v.items()]
    if ty.base == "row":
        return [exact_value(x, f) for x, f in zip(v, ty.field_types)]
    if ty.is_floating:
        return float(v).hex()
    if ty.is_string:
        return str(v)
    if ty == T.BOOLEAN:
        return bool(v)
    return int(v)


def exact_rows(columns: List[np.ndarray], nulls: List[np.ndarray],
               types: List[T.Type], row_count: int) -> List[list]:
    """A query result's rows (its columns, null masks and logical
    types, as both packages' QueryResult carries them) in exact form."""
    return [[exact_value(None if nulls[c][i] else columns[c][i], types[c])
             for c in range(len(columns))] for i in range(row_count)]


def load_corpus(path: str = CORPUS_PATH) -> Dict[str, dict]:
    """{query name: {"plan", "names", "types", "rows", ...}} of the
    committed corpus, with "sf" and "source" on each entry."""
    with open(path) as f:
        data = json.load(f)
    out = {}
    for name, q in data["queries"].items():
        out[name] = {**q, "sf": data["sf"], "source": data["source"]}
    return out


def _unpack(packed: str):
    return json.loads(zlib.decompress(base64.b64decode(packed)))


def load_tpcds_corpus(path: str = TPCDS_CORPUS_PATH) -> Dict[str, dict]:
    """{query name: {"sf", "plan", "names", "types", "rows",
    "max_groups", "join_capacity", "plan_timed", "timed_sf",
    "timed_max_groups", "timed_join_capacity"}} of the committed TPC-DS
    corpus (the plan the card times, at timed_sf: SF1, q72 at 0.2), plans
    decoded to plan-fragment JSON dicts and rows to lists."""
    with open(path) as f:
        data = json.load(f)
    return {name: {**q, **{k: _unpack(q[k])
                           for k in ("plan", "rows", "plan_timed")}}
            for name, q in data["queries"].items()}


def load_functions_corpus(path: str = FUNCTIONS_CORPUS_PATH
                          ) -> Dict[str, Dict[str, dict]]:
    """{"statements", "later", "timed"} -> {name: entry} of the committed
    function corpus. An entry has "sql", "sf" and "plan" (plan-fragment
    JSON) and "names", "types" and "rows";
    timed entries also "sf1", "plan_sf1", "rows_sf1" and "sample" (the
    BERNOULLI ratio of a plan with a SampleNode, else None)."""
    with open(path) as f:
        data = json.load(f)
    return {k: data[k] for k in ("statements", "later", "timed")}
