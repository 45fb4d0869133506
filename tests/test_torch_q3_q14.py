"""TPC-H q3 and q14 (BASELINE config 2) end to end through the port on
the CPU, against presto_tpu.

* The reference plans each query through its SQL front door
  (prepare_plan(plan_sql(...))), ships it as plan-fragment JSON, and the
  port runs it with run_query(device="cpu"): rows equal the reference
  run_query's exactly, q14's double bit for bit.
* chip_smoke.py's hand-built plans serialize to that same JSON (node ids
  aside), and its numpy oracles give the reference's rows.
"""

import json

import numpy as np
import pytest
import torch

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
from presto_tpu.connectors import tpch as rtpch
from presto_tpu.exec import run_query as ref_run_query
from presto_tpu.exec.runner import prepare_plan
from presto_tpu.plan import nodes as RN
from presto_tpu.sql import plan_sql

import bench
import chip_smoke
import presto_tpu_torch
from presto_tpu_torch.exec import run_query
from presto_tpu_torch.plan import from_json, to_json
from presto_tpu_torch.plan.widths import annotate_widths

SF = 0.01
QUERIES = {"q3": (bench.TPCH_Q3, chip_smoke.q3_plan, chip_smoke.numpy_q3),
           "q14": (bench.TPCH_Q14, chip_smoke.q14_plan,
                   chip_smoke.numpy_q14)}
TABLES = {"q3": {"lineitem": ["orderkey", "extendedprice", "discount",
                              "shipdate"],
                 "orders": ["orderdate", "shippriority", "custkey",
                            "orderkey"],
                 "customer": ["custkey", "mktsegment"]},
          "q14": {"lineitem": ["extendedprice", "discount", "partkey",
                               "shipdate"],
                  "part": ["type", "partkey"]}}


@pytest.fixture(scope="module")
def reference():
    """Per query: the reference's prepared plan and its rows at SF."""
    out = {}
    for name, (sql, _, _) in QUERIES.items():
        prepared = prepare_plan(plan_sql(sql), sf=SF)
        out[name] = (prepared, ref_run_query(prepared, sf=SF, prepared=True))
    return out


def _plain(rows):
    return [tuple(v.item() if isinstance(v, np.generic) else v for v in r)
            for r in rows]


@pytest.mark.parametrize("name", ["q3", "q14"])
def test_reference_planned_query_matches_reference(reference, name):
    prepared, want = reference[name]
    got = run_query(from_json(RN.to_json(prepared)), sf=SF, device="cpu",
                    prepared=True)
    assert got.names == want.names
    assert [str(t) for t in got.types] == [str(t) for t in want.types]
    assert _plain(got.rows()) == _plain(want.rows())  # the double bitwise
    assert got.row_count == (10 if name == "q3" else 1)


def _without_ids(j):
    if isinstance(j, dict):
        return {k: _without_ids(v) for k, v in j.items() if k != "id"}
    if isinstance(j, list):
        return [_without_ids(v) for v in j]
    return j


@pytest.mark.parametrize("sf", [SF, chip_smoke.SF_JOIN])
@pytest.mark.parametrize("name", ["q3", "q14"])
def test_hand_built_plan_is_the_prepared_plan(name, sf):
    """chip_smoke.py's plan, with the port's narrow lanes, is the plan
    the reference's SQL front door prepares (at sf 0.01 and at SF10)."""
    sql, make, _ = QUERIES[name]
    want = _without_ids(RN.to_json(prepare_plan(plan_sql(sql), sf=sf)))
    got = _without_ids(to_json(annotate_widths(make(), sf)))
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


@pytest.mark.parametrize("name", ["q3", "q14"])
def test_numpy_oracle_matches_reference(reference, name):
    _, want = reference[name]
    tables = {t: rtpch.generate_columns(t, SF, cols)
              for t, cols in TABLES[name].items()}
    assert QUERIES[name][2](tables) == _plain(want.rows())


def test_run_query_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        presto_tpu_torch.run_query(chip_smoke.q3_plan(), sf=SF)
