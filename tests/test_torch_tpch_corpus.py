"""The reference's 22-query TPC-H corpus through the port, on the CPU.

Each query of presto_tpu/queries/tpch_sql.py::TPCH_QUERIES is planned
by the reference (plan_sql with the query's own max_groups and
join_capacity, then prepare_plan at sf 0.01), crosses to the port as
plan-fragment JSON, and runs through presto_tpu_torch.run_query on the
CPU:

every query returns the reference run_query's rows exactly, doubles
bit for bit.

A drift guard holds the committed SF1 corpus (presto_tpu_torch/queries/
tpch_sf1.json, which chip_smoke.py runs on the card) to the reference:
its plans are the reference's prepare_plan at SF1, node ids aside, and
its rows are in the exact form. The corpus's probes (q11 and q18 with
the one constant moved that leaves them empty at SF1, scripts/
make_tpch_corpus.py::PROBES) also equal the reference at sf 0.01; its
statements (scripts/make_tpch_corpus.py::STATEMENTS) are held at sf
0.01 by tests/test_torch_misc.py, its two-stage plans and aggregate
statements (TWO_STAGE_QUERIES, AGGREGATES) by
tests/test_torch_two_stage.py.
"""

import json

import numpy as np
import pytest

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
from presto_tpu.exec import run_query as ref_run_query
from presto_tpu.plan import nodes as RN
from presto_tpu.queries.tpch_sql import TPCH_QUERIES

from presto_tpu_torch import types as PT
from presto_tpu_torch.exec import run_query
from presto_tpu_torch.plan import from_json
from presto_tpu_torch.queries import exact_rows, load_corpus

from make_tpch_corpus import (AGGREGATES, AGGREGATES_TWO_STAGE, PROBES,
                              SF as CORPUS_SF, STATEMENTS, TWO_STAGE,
                              TWO_STAGE_QUERIES, entry_kind, entry_names,
                              entry_source, prepared_entry)

SF = 0.01
PORTED = tuple(range(1, 23))
# query -> the ROADMAP queue 1 item of the first piece it lacks
UNPORTED = {}
# the queries chip_smoke.py checks against numpy oracles of its own
ORACLE_CHECKED = (1, 3, 6, 14)


def _prepared_entry(name, sf):
    """The reference's prepared plan of a corpus entry: a query (qN), a
    probe, a statement, or the two-stage form of one."""
    return prepared_entry(name, sf)


def _prepared(n, sf):
    return _prepared_entry(f"q{n}", sf)


# the corpus's entries: the queries chip_smoke.py does not check
# against a numpy oracle, then the probes, then the statements; then
# every query's two-stage plan and the aggregate statements
CORPUS = [f"q{n}" for n in PORTED if n not in ORACLE_CHECKED] + \
    sorted(PROBES) + sorted(STATEMENTS) + \
    [f"q{n}{TWO_STAGE}" for n in TWO_STAGE_QUERIES] + sorted(AGGREGATES) + \
    [a + TWO_STAGE for a in AGGREGATES_TWO_STAGE]


def _exact(res):
    types = [PT.parse_type(str(t)) for t in res.types]
    return exact_rows(res.columns, res.nulls, types, res.row_count)


@pytest.fixture(scope="module")
def reference():
    """Per ported query: its plan JSON and the reference's rows at SF,
    computed once for the module."""
    out = {}
    for n in PORTED:
        prepared = _prepared(n, SF)
        res = ref_run_query(prepared, sf=SF, prepared=True)
        out[n] = (RN.to_json(prepared), res)
    return out


def test_corpus_partition():
    assert sorted(PORTED + tuple(UNPORTED)) == sorted(TPCH_QUERIES)


@pytest.mark.parametrize("n", PORTED, ids=lambda n: f"q{n}")
def test_query_returns_the_reference_rows(reference, n):
    plan, want = reference[n]
    got = run_query(from_json(plan), sf=SF, device="cpu", prepared=True)
    assert got.names == list(want.names)
    assert [str(t) for t in got.types] == [str(t) for t in want.types]
    assert got.row_count == want.row_count
    assert _exact(got) == _exact(want)  # doubles as float.hex


@pytest.mark.parametrize("name", sorted(PROBES))
def test_probe_returns_the_reference_rows(name):
    prepared = _prepared_entry(name, SF)
    want = ref_run_query(prepared, sf=SF, prepared=True)
    assert want.row_count > 0
    got = run_query(from_json(RN.to_json(prepared)), sf=SF, device="cpu",
                    prepared=True)
    assert _exact(got) == _exact(want)


def _without_ids(j):
    if isinstance(j, dict):
        return {k: _without_ids(v) for k, v in j.items() if k != "id"}
    if isinstance(j, list):
        return [_without_ids(v) for v in j]
    return j


@pytest.fixture(scope="module")
def corpus():
    return load_corpus()


def test_sf1_corpus_holds_every_ported_query_off_the_oracles(corpus):
    assert sorted(corpus) == sorted(CORPUS) == sorted(entry_names())


@pytest.mark.parametrize("name", CORPUS)
def test_sf1_corpus_plan_is_the_reference_plan(corpus, name):
    """No drift: the committed plan is the reference's prepare_plan at
    SF1 of the query (or probe) as it stands, node ids aside; the port
    reads it and names the committed column types; every value is in
    the exact form of its type; a probe returns rows."""
    entry = corpus[name]
    assert entry["sf"] == CORPUS_SF == 1.0
    assert entry["kind"] == entry_kind(name)
    assert (entry["max_groups"], entry["join_capacity"]) == \
        entry_source(name)[1:]
    if name in PROBES or name in STATEMENTS or name.startswith("agg"):
        assert entry["rows"]
    if entry["kind"] == "two_stage":
        # a two-stage plan has its exchanges, and a PARTIAL/FINAL pair
        # for each aggregation (q16's count(DISTINCT) moves raw rows to
        # one SINGLE step instead)
        text = json.dumps(entry["plan"])
        assert '"exchange"' in text
        assert text.count('"FINAL"') == text.count('"PARTIAL"') > 0 or \
            name == "q16" + TWO_STAGE
        if name[:-len(TWO_STAGE)] in corpus:
            single = corpus[name[:-len(TWO_STAGE)]]
            assert (entry["rows"], entry["types"]) == \
                (single["rows"], single["types"])
    want = _without_ids(RN.to_json(_prepared_entry(name, 1.0)))
    assert json.dumps(_without_ids(entry["plan"]), sort_keys=True) == \
        json.dumps(want, sort_keys=True)
    root = from_json(entry["plan"])
    types = [PT.parse_type(t) for t in entry["types"]]
    assert [str(t) for t in root.output_types()] == entry["types"]
    assert len(entry["names"]) == len(types)
    for row in entry["rows"]:
        assert len(row) == len(types)
        for v, ty in zip(row, types):
            if v is None:
                continue
            if ty.is_floating:
                assert float.fromhex(v).hex() == v
            elif ty.is_string:
                assert isinstance(v, str)
            elif ty == PT.BOOLEAN:
                assert isinstance(v, bool)
            else:
                assert isinstance(v, int) and not isinstance(v, bool)


def test_exact_form_round_trips():
    """Scaled integers stay integers, doubles keep every bit, NULL is
    None: the form the card is held to."""
    cols = [np.array([1, -2], np.int64), np.array([0.1, -3e-300]),
            np.array(["a", "b"], dtype=object),
            np.array([(1 << 100), -5], dtype=object)]
    nulls = [np.array([False, True])] + [np.zeros(2, bool)] * 3
    types = [PT.BIGINT, PT.DOUBLE, PT.varchar(3), PT.decimal(38, 2)]
    rows = exact_rows(cols, nulls, types, 2)
    assert rows == [[1, (0.1).hex(), "a", 1 << 100],
                    [None, (-3e-300).hex(), "b", -5]]
    assert float.fromhex(rows[1][1]) == -3e-300
