"""Two-stage plans through the port on one device, against presto_tpu.

The reference distributes a plan with plan/distribute.py::add_exchanges:
every aggregation splits into PARTIAL -> REMOTE exchange -> FINAL
(count(DISTINCT) moves raw rows to one step), TopN and Limit into a
partial under a GATHER, an ordered root into a MERGE over a local Sort.
Without a mesh an exchange is the identity, so each of the 22 TPC-H
queries must return the rows of its single plan: the port's two-stage
rows are held to the reference's single rows at sf 0.01, exactly
(computed once for the module); chip_smoke.py's numpy oracles hold the
two-stage plans of q1, q3, q6 and q14 here as on the card. The
aggregate statements, the exchange and second-channel JSON and the
INTERMEDIATE step: tests/test_torch_agg_statements.py.
"""

import json

import pytest

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
from presto_tpu.exec import run_query as ref_run_query
from presto_tpu.plan import nodes as RN

from presto_tpu_torch import types as PT
from presto_tpu_torch.connectors.tpch import generator
from presto_tpu_torch.exec import run_query
from presto_tpu_torch.plan import from_json
from presto_tpu_torch.queries import exact_rows

import chip_smoke
from make_tpch_corpus import TWO_STAGE, TWO_STAGE_QUERIES, prepared_entry

SF = 0.01


def _exact(res):
    types = [PT.parse_type(str(t)) for t in res.types]
    return exact_rows(res.columns, res.nulls, types, res.row_count)


@pytest.fixture(scope="module")
def single_rows():
    """The reference's rows of each query's single plan at SF."""
    return {n: _exact(ref_run_query(prepared_entry(f"q{n}", SF), sf=SF,
                                    prepared=True))
            for n in TWO_STAGE_QUERIES}


def _two_stage_json(name):
    return RN.to_json(prepared_entry(name + TWO_STAGE, SF))


@pytest.mark.parametrize("n", TWO_STAGE_QUERIES, ids=lambda n: f"q{n}")
def test_two_stage_query_returns_the_single_rows(single_rows, n):
    plan = _two_stage_json(f"q{n}")
    assert '"exchange"' in json.dumps(plan)
    got = run_query(from_json(plan), sf=SF, device="cpu", prepared=True)
    assert _exact(got) == single_rows[n]


ORACLES = {1: (lambda t: [r[:5] + r[9:] for r in chip_smoke.numpy_q1(t)],
               chip_smoke.Q1_TABLES),
           3: (chip_smoke.numpy_q3, chip_smoke.Q3_TABLES),
           6: (chip_smoke.numpy_q6, chip_smoke.Q6_TABLES),
           14: (chip_smoke.numpy_q14, chip_smoke.Q14_TABLES)}


@pytest.mark.parametrize("n", sorted(ORACLES), ids=lambda n: f"q{n}")
def test_chip_smoke_oracles_hold_the_two_stage_plans(n):
    """chip_smoke.py holds these four two-stage plans to its numpy
    oracles on the card (q1's SQL keeps columns 0-4 and 9 of the
    oracle's row); the same oracles hold them here at sf 0.01."""
    oracle, tables = ORACLES[n]
    got = run_query(from_json(_two_stage_json(f"q{n}")), sf=SF,
                    device="cpu", prepared=True)
    want = oracle({t: generator.generate_columns(t, SF, cols)
                   for t, cols in tables.items()})
    assert chip_smoke._plain_rows(got) == want
