"""The port's planner and plan passes against the reference's.

* Whole plans: for every statement text of the corpora, the port's
  `prepare_plan(plan_sql(text))` equals the reference's at sf 0.01
  under the comparison of tests/_torch_sql_common.py (ids renumbered,
  not dropped); TPC-H and TPC-DS also at SF1 (planning only), and the
  committed plans of the TPC-H and TPC-DS corpora from their "sql".
* Each pass alone and constant folding: tests/test_torch_sql_passes.py.

Left out of the comparisons, by name:
* PREPARE, DEALLOCATE and EXECUTE have no plan of their own (their rows
  are held in tests/test_torch_sql.py); `SHOW TABLES WHERE x` is
  malformed in both.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))

from _torch_sql_common import (STATEMENT_TEXTS, assert_same_plan,  # noqa
                               canonical, plan_differences, port_json,
                               port_prepared)

from presto_tpu.queries.tpch_sql import TPCH_QUERIES  # noqa: E402
from presto_tpu.queries.tpcds_queries import TPCDS_QUERIES  # noqa: E402
from presto_tpu.verifier import DEFAULT_CORPUS  # noqa: E402

from presto_tpu_torch.plan import nodes as PN  # noqa: E402
from presto_tpu_torch.queries import (load_corpus,  # noqa: E402
                                      load_functions_corpus,
                                      load_tpcds_corpus)

SF = 0.01
# q24 is planned without join reordering, as the corpus plans it
# (scripts/make_tpcds_corpus.py::SESSIONS)
TPCDS_SESSIONS = {"q24": {"join_reordering_strategy": "NONE"}}
# planning keywords of the TPC-DS corpus: suite plans and timed plans
TPCDS_SMALL = dict(max_groups=1 << 13, join_capacity=1 << 18)
TPCDS_TIMED = dict(max_groups=1 << 16, join_capacity=1 << 22)
# the statements whose plans hold a folded double one ulp from the
# reference's (XLA's cbrt(27.0) is 3.0000000000000004; the port's 3.0)
ONE_ULP = {"fn_statements_scalar_math"}
NOT_COMPARED = {
    "test_meta_statements::test_prepare_execute_end_to_end",
    "test_meta_statements::test_prepare_execute_end_to_end#1",
    "test_meta_statements::test_prepare_execute_end_to_end#2",
    "test_meta_statements::test_prepare_execute_end_to_end#3",
    "test_meta_statements::test_show_tables_like_filters",
}

TPCH_CORPUS = load_corpus()
TPCDS_CORPUS = load_tpcds_corpus()


def _cases():
    """(id, text, planning keywords) of every statement compared at
    sf 0.01."""
    out = [(f"tpch_q{n}", q.text, dict(max_groups=q.max_groups,
                                       join_capacity=q.join_capacity))
           for n, q in TPCH_QUERIES.items()]
    out += [(f"tpch_corpus_{k}", e["sql"],
             dict(max_groups=e["max_groups"],
                  join_capacity=e["join_capacity"]))
            for k, e in sorted(TPCH_CORPUS.items())
            if not k.endswith("_two_stage") and not k[1:].isdigit()]
    out += [(f"verifier_{i}", t, {}) for i, t in enumerate(DEFAULT_CORPUS)]
    out += [(f"tpcds_{k}", t, dict(catalog="tpcds",
                                   session=TPCDS_SESSIONS.get(k),
                                   **TPCDS_SMALL))
            for k, t in sorted(TPCDS_QUERIES.items())]
    for group, entries in load_functions_corpus().items():
        out += [(f"fn_{group}_{k}", e["sql"], {})
                for k, e in sorted(entries.items())]
    out += [(name, text, kw) for name, text, kw in STATEMENT_TEXTS
            if name not in NOT_COMPARED]
    return out


CASES = _cases()


def test_every_corpus_is_compared():
    names = {c[0] for c in CASES}
    assert len([n for n in names if n.startswith("tpch_q")]) == 22
    assert len([n for n in names if n.startswith("tpcds_")]) == 99
    assert len([n for n in names if n.startswith("verifier_")]) == 22
    assert len([n for n in names if n.startswith("fn_")]) == 94
    assert len(STATEMENT_TEXTS) - len(NOT_COMPARED) == 51


@pytest.mark.parametrize("name,text,kw", CASES, ids=[c[0] for c in CASES])
def test_prepared_plan_equals_the_reference(name, text, kw):
    ulps = []
    assert_same_plan(text, SF, ulps=ulps, **kw)
    assert bool(ulps) == (name in ONE_ULP), ulps


@pytest.mark.parametrize("n", sorted(TPCH_QUERIES))
def test_tpch_plan_at_sf1_equals_the_reference(n):
    q = TPCH_QUERIES[n]
    assert_same_plan(q.text, 1.0, max_groups=q.max_groups,
                     join_capacity=q.join_capacity)


@pytest.mark.parametrize("name", sorted(TPCDS_QUERIES, key=lambda q:
                                        int(q[1:])))
def test_tpcds_timed_plan_equals_the_reference(name):
    e = TPCDS_CORPUS[name]
    assert_same_plan(TPCDS_QUERIES[name], e["timed_sf"], catalog="tpcds",
                     session=TPCDS_SESSIONS.get(name), **TPCDS_TIMED)


def _committed(plan_json):
    return canonical(PN.to_json(PN.from_json(plan_json)))


@pytest.mark.parametrize("name", sorted(
    k for k in TPCH_CORPUS if not k.endswith("_two_stage")))
def test_tpch_corpus_plan_from_its_sql(name):
    """The committed SF1 plan (the reference's) from the entry's "sql",
    through the port alone. The two-stage entries are left out: their
    plans come from the reference's add_exchanges (item 14)."""
    e = TPCH_CORPUS[name]
    got = port_json(port_prepared(e["sql"], e["sf"],
                                  max_groups=e["max_groups"],
                                  join_capacity=e["join_capacity"]))
    d = plan_differences(got, _committed(e["plan"]))
    assert d is None, d


@pytest.mark.parametrize("name", sorted(TPCDS_CORPUS, key=lambda q:
                                        int(q[1:])))
def test_tpcds_corpus_plans_from_their_sql(name):
    e = TPCDS_CORPUS[name]
    for key, sf, kw in (("plan", e["sf"], TPCDS_SMALL),
                        ("plan_timed", e["timed_sf"], TPCDS_TIMED)):
        got = port_json(port_prepared(e["sql"], sf, catalog="tpcds",
                                      session=TPCDS_SESSIONS.get(name), **kw))
        d = plan_differences(got, _committed(e[key]))
        assert d is None, (key, d)


# ---- the SQL text in the committed corpora ---------------------------------

# sha256 of each corpus file as it was before its entries gained "sql"
# (scripts/make_tpch_corpus.py and make_tpcds_corpus.py --add-sql)
CORPUS_SHA256 = {
    "tpch_sf1.json":
        "5c65338a1967a63b341aa5b553741304888b5567f51458c7d1cac1baf51929ae",
    "tpcds.json":
        "9f2385e9ad7520de31013d9a0ab8f065dd9ac14803f1253e28f50902a6ef76e6",
}


@pytest.mark.parametrize("name", sorted(CORPUS_SHA256))
def test_corpus_files_only_gained_their_sql(name):
    """Without "sql" each file is byte for byte what it was: every
    committed plan and row is unchanged."""
    import hashlib
    import json
    from presto_tpu_torch.queries import CORPUS_PATH
    path = os.path.join(os.path.dirname(CORPUS_PATH), name)
    with open(path) as f:
        data = json.load(f)
    for e in data["queries"].values():
        assert isinstance(e.pop("sql"), str)
    raw = json.dumps(data, separators=(",", ":"), sort_keys=True) + "\n"
    assert hashlib.sha256(raw.encode()).hexdigest() == CORPUS_SHA256[name]


def test_corpus_sql_is_the_text_the_plans_came_from():
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts"))
    from make_tpch_corpus import entry_source
    for name, e in TPCH_CORPUS.items():
        assert e["sql"] == entry_source(name)[0], name
    for name, e in TPCDS_CORPUS.items():
        assert e["sql"] == TPCDS_QUERIES[name], name
