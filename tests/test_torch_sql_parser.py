"""The port's SQL parser (presto_tpu_torch/sql/parser.py) against the
reference's (presto_tpu/sql/parser.py): over every statement text of
the corpora the two ASTs are equal, compared as nested (class name,
fields) tuples, and malformed texts raise the same exception type."""

import dataclasses
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))

from _torch_sql_common import STATEMENT_TEXTS  # noqa: E402

from presto_tpu.queries.tpch_sql import TPCH_QUERIES  # noqa: E402
from presto_tpu.queries.tpcds_queries import TPCDS_QUERIES  # noqa: E402
from presto_tpu.sql import parser as RP  # noqa: E402
from presto_tpu.sql import statements as RS  # noqa: E402
from presto_tpu.verifier import DEFAULT_CORPUS  # noqa: E402

from presto_tpu_torch.queries import (load_corpus,  # noqa: E402
                                      load_functions_corpus)
from presto_tpu_torch.sql import parser as PP  # noqa: E402


def _texts():
    """(id, SELECT text) of every corpus: TPC-H, the TPC-H corpus's
    probes, statements and aggregates, DEFAULT_CORPUS, TPC-DS, the
    function statements, and the reference's SQL tests (their meta
    statements after the SHOW/DESCRIBE rewrite; PREPARE, EXECUTE and
    DEALLOCATE have no SELECT of their own)."""
    out = [(f"tpch_q{n}", q.text) for n, q in TPCH_QUERIES.items()]
    out += [(f"tpch_corpus_{k}", e["sql"]) for k, e in
            sorted(load_corpus().items()) if not k.endswith("_two_stage")
            and not k[1:].isdigit()]
    out += [(f"verifier_{i}", t) for i, t in enumerate(DEFAULT_CORPUS)]
    out += [(f"tpcds_{k}", t) for k, t in sorted(TPCDS_QUERIES.items())]
    for group, entries in load_functions_corpus().items():
        out += [(f"fn_{group}_{k}", e["sql"]) for k, e in
                sorted(entries.items())]
    for name, text, _kw in STATEMENT_TEXTS:
        try:
            pre = RS.preprocess(text)
        except (KeyError, ValueError):
            continue  # EXECUTE without its PREPARE; a malformed SHOW
        if pre.text is not None:
            out.append((name, pre.text))
    return out


TEXTS = _texts()


def ast_tuple(x):
    """An AST as nested (class name, ((field, value), ...)) tuples."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, ast_tuple(getattr(x, f.name)))
                      for f in dataclasses.fields(x)))
    if isinstance(x, (list, tuple)):
        return tuple(ast_tuple(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, ast_tuple(v)) for k, v in x.items()))
    return x


def test_the_corpora_are_all_here():
    assert len(TEXTS) >= 22 + 22 + 99 + 94 + 40


@pytest.mark.parametrize("text", [t for _, t in TEXTS],
                         ids=[i for i, _ in TEXTS])
def test_ast_equals_the_reference(text):
    assert ast_tuple(PP.parse_sql(text)) == ast_tuple(RP.parse_sql(text))


@pytest.mark.parametrize("text", [
    "SELECT a FROM", "SELEC 1", "SELECT (1 + 2 FROM t",
    "SELECT 'abc FROM t", "SELECT 1 FROM t WHERE", "",
    "SELECT a FROM t GROUP", "SELECT CAST(a AS) FROM t",
    "SELECT a FROM t JOIN u", "SELECT a FROM t;;",
    "SELECT a FROM t WHERE a IN ()", "SELECT CASE WHEN a THEN 1 FROM t",
    "WITH x AS SELECT 1 SELECT 1", "SELECT a FROM t t2 t3",
    "SELECT @ FROM t", "SELECT a FROM (SELECT b FROM u"])
def test_malformed_text_raises_what_the_reference_raises(text):
    with pytest.raises(Exception) as want:
        RP.parse_sql(text)
    with pytest.raises(Exception) as got:
        PP.parse_sql(text)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
