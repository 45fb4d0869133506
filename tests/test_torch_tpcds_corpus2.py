"""The reference's TPC-DS corpus through the port, on the CPU: q34-q71
(tests/test_torch_tpcds_corpus.py holds the rest and says how), and
the corpus's drift guard: DRIFT_GUARD re-planned with the live
reference and re-run there must give the committed plans (node ids
aside; the small and the timed plan) and rows.
"""

import json

import pytest

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
from presto_tpu.plan import nodes as RN

from make_tpcds_corpus import (SMALL_JOIN_CAPACITY, SMALL_MAX_GROUPS,
                               TIMED_JOIN_CAPACITY, TIMED_MAX_GROUPS,
                               prepared, reference_rows)
from test_torch_tpcds_corpus import (CORPUS, check_query, corpus_slice,
                                     one_torch_thread)  # noqa: F401

DRIFT_GUARD = ("q3", "q12", "q24", "q36", "q51", "q67", "q98")


@pytest.mark.parametrize("name", corpus_slice(34, 71))
def test_tpcds_query_returns_the_reference_rows(name):
    check_query(name)


def _shape(j):
    def strip(v):
        if isinstance(v, dict):
            return {k: strip(x) for k, x in v.items() if k != "id"}
        if isinstance(v, list):
            return [strip(x) for x in v]
        return v
    return json.dumps(strip(j), sort_keys=True)


@pytest.mark.parametrize("name", DRIFT_GUARD)
def test_committed_corpus_is_the_live_reference(name):
    e = CORPUS[name]
    small = prepared(name, e["sf"], SMALL_MAX_GROUPS, SMALL_JOIN_CAPACITY)
    assert _shape(RN.to_json(small)) == _shape(e["plan"])
    names, types, rows = reference_rows(small, e["sf"], SMALL_JOIN_CAPACITY)
    assert (names, types, rows) == (e["names"], e["types"], e["rows"])
    big = prepared(name, e["timed_sf"], TIMED_MAX_GROUPS,
                   TIMED_JOIN_CAPACITY)
    assert _shape(RN.to_json(big)) == _shape(e["plan_timed"])
