"""TPC-H q1 and q6 end to end through the port on the CPU, against
presto_tpu.exec.run_query on the same plan.

Plans are built with the reference's nodes and handed to the port as
the plan-fragment JSON (presto_tpu.plan.nodes.to_json ->
presto_tpu_torch.plan.from_json), so both packages run the same plan.
Rows must be equal exactly.
"""

import numpy as np
import pytest
import torch

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
from presto_tpu import types as RT
from presto_tpu.connectors import tpch as rtpch
from presto_tpu.exec import run_query as ref_run_query
from presto_tpu.expr import call, const, input_ref, special
from presto_tpu.ops.aggregation import AggSpec
from presto_tpu.plan import nodes as RN
from presto_tpu.queries.tpch_queries import Q1_COLUMNS, Q6_COLUMNS

import presto_tpu_torch
from presto_tpu_torch import types as PT
from presto_tpu_torch.exec import run_query
from presto_tpu_torch.plan import from_json
from presto_tpu_torch.plan import nodes as PN

SF = 0.01
D2 = RT.decimal(12, 2)


def _scan(cols):
    return RN.TableScanNode("tpch", "lineitem", cols,
                            [rtpch.column_type("lineitem", c) for c in cols])


def q1_plan(max_groups=16):
    qty, price = input_ref(2, D2), input_ref(3, D2)
    disc, tax = input_ref(4, D2), input_ref(5, D2)
    one = const(100, D2)
    filt = RN.FilterNode(_scan(Q1_COLUMNS),
                         call("le", RT.BOOLEAN, input_ref(6, RT.DATE),
                              const("1998-09-02", RT.DATE)))
    disc_price = call("multiply", RT.decimal(24, 4), price,
                      call("subtract", D2, one, disc))
    charge = call("multiply", RT.decimal(36, 6), disc_price,
                  call("add", D2, one, tax))
    proj = RN.ProjectNode(filt, [input_ref(0, RT.char(1)),
                                 input_ref(1, RT.char(1)), qty, price,
                                 disc_price, charge, disc])
    aggs = [AggSpec("sum", 2, RT.decimal(38, 2)),
            AggSpec("sum", 3, RT.decimal(38, 2)),
            AggSpec("sum", 4, RT.decimal(38, 4)),
            AggSpec("sum", 5, RT.decimal(38, 6)),
            AggSpec("avg", 2, D2), AggSpec("avg", 3, D2),
            AggSpec("avg", 6, D2), AggSpec("count_star", None, RT.BIGINT)]
    agg = RN.AggregationNode(proj, [0, 1], aggs, max_groups=max_groups)
    return RN.OutputNode(RN.SortNode(agg, [(0, False, True),
                                           (1, False, True)]),
                         ["returnflag", "linestatus", "sum_qty",
                          "sum_base_price", "sum_disc_price", "sum_charge",
                          "avg_qty", "avg_price", "avg_disc", "count_order"])


def q6_plan():
    ship = input_ref(0, RT.DATE)
    disc, qty, price = input_ref(1, D2), input_ref(2, D2), input_ref(3, D2)
    filt = RN.FilterNode(_scan(Q6_COLUMNS), special(
        "AND", RT.BOOLEAN,
        call("ge", RT.BOOLEAN, ship, const("1994-01-01", RT.DATE)),
        call("lt", RT.BOOLEAN, ship, const("1995-01-01", RT.DATE)),
        special("BETWEEN", RT.BOOLEAN, disc, const(5, D2), const(7, D2)),
        call("lt", RT.BOOLEAN, qty, const(2400, D2))))
    proj = RN.ProjectNode(filt, [call("multiply", RT.decimal(24, 4), price,
                                      disc)])
    agg = RN.AggregationNode(proj, [], [AggSpec("sum", 0,
                                                RT.decimal(38, 4))])
    return RN.OutputNode(agg, ["revenue"])


def _port(plan_json, **kw):
    return run_query(from_json(plan_json), sf=SF, device="cpu", **kw)


@pytest.mark.parametrize("form", ["narrow", "wide"])
@pytest.mark.parametrize("make", [q1_plan, q6_plan], ids=["q1", "q6"])
def test_hand_built_plan_matches_reference(make, form):
    want = ref_run_query(make(), sf=SF)
    got = _port(RN.to_json(make()), limb_form=form)
    assert got.names == want.names
    assert got.canonical_rows() == want.canonical_rows()
    assert [str(t) for t in got.types] == [str(t) for t in want.types]


def test_sql_planned_q1_matches_reference():
    """q1 planned by the reference's SQL front door and shipped as the
    plan-fragment JSON (narrow widths and max_groups included)."""
    import bench
    from presto_tpu.exec.runner import prepare_plan
    from presto_tpu.sql import plan_sql
    prepared = prepare_plan(plan_sql(bench.TPCH_Q1), sf=SF)
    plan = from_json(RN.to_json(prepared))
    assert plan.source.source.max_groups == 16
    assert plan.source.source.source.source.source.physical_dtypes
    want = ref_run_query(prepared, sf=SF, prepared=True)
    got = run_query(plan, sf=SF, device="cpu", prepared=True)
    assert got.rows() == want.rows()
    assert got.canonical_rows() == want.canonical_rows()


def test_overflow_reruns_with_more_groups():
    """max_groups=2 under q1's four groups: the ladder's first 4x rerun
    (8 groups) fits."""
    want = ref_run_query(q1_plan(), sf=SF)
    got = _port(RN.to_json(q1_plan(max_groups=2)))
    assert got.canonical_rows() == want.canonical_rows()


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        presto_tpu_torch.run_query(from_json(RN.to_json(q6_plan())), sf=SF)


def _orders_between(lo, hi, cols):
    key = input_ref(0, RT.BIGINT)
    return RN.FilterNode(_scan(["orderkey"] + cols), special(
        "BETWEEN", RT.BOOLEAN, key, const(lo, RT.BIGINT),
        const(hi, RT.BIGINT)))


def test_out_of_slice_plans_raise_naming_the_roadmap():
    """A left join, a LimitNode, a count_distinct in the sorted
    group-by, an approx_distinct, the PARTIAL step and an unnest, which
    earlier slices refused, equal the reference (a PARTIAL at the root
    returns its state columns; the two-stage plan of q1, PARTIAL ->
    exchange -> FINAL, returns q1's rows); what is still out of the
    slice raises naming its ROADMAP item."""
    from presto_tpu.plan.distribute import add_exchanges
    join = RN.JoinNode(_orders_between(1, 40, ["linenumber"]),
                       _orders_between(20, 70, ["quantity"]), [0], [0],
                       join_type="left")
    limit = RN.LimitNode(_scan(["orderkey", "linenumber"]), 5)
    big = RN.to_json(q1_plan(max_groups=1 << 10))
    big["source"]["source"]["aggregates"].append(
        {"name": "count_distinct", "input": 2, "type": "bigint"})
    big["names"].append("distinct_qty")
    approx = RN.to_json(q1_plan(max_groups=1 << 10))
    approx["source"]["source"]["aggregates"].append(
        {"name": "approx_distinct", "input": 2, "type": "bigint"})
    approx["names"].append("approx_qty")
    partial = RN.to_json(q1_plan())
    partial["source"]["source"]["step"] = "PARTIAL"
    two_stage = RN.to_json(add_exchanges(q1_plan()))
    for plan in (RN.to_json(join), RN.to_json(limit), big, approx, partial,
                 two_stage):
        want = ref_run_query(RN.from_json(plan), sf=SF)
        got = _port(plan)
        assert want.row_count > 0
        assert got.rows() == want.rows()
    assert len(_port(partial).columns) == 2 + 4 + 3 * 2 + 1
    # an unnest, which the slices before the nested half refused, runs:
    # ARRAY[orderkey, linenumber] of the limited rows, unnested WITH
    # ORDINALITY
    arrays = RN.ProjectNode(limit, [
        input_ref(0, RT.BIGINT),
        call("array_constructor", RT.array_of(RT.BIGINT),
             input_ref(0, RT.BIGINT), input_ref(1, RT.INTEGER))])
    unnest = RN.to_json(RN.OutputNode(RN.UnnestNode(
        arrays, 1, with_ordinality=True), ["orderkey", "e", "ord"]))
    want = ref_run_query(RN.from_json(unnest), sf=SF)
    assert want.row_count == 10
    assert _port(unnest).rows() == want.rows()
    # a mesh, which earlier slices refused, runs q6 on two CPU workers;
    # a fragment's remote source, which earlier slices refused, reads
    # the batch the worker tier hands it, and names a missing one
    from presto_tpu_torch.block import batch_from_numpy
    from presto_tpu_torch.parallel import make_mesh
    mesh = run_query(from_json(RN.to_json(q6_plan())), sf=SF,
                     mesh=make_mesh(2, devices=("cpu", "cpu")))
    assert mesh.rows() == ref_run_query(q6_plan(), sf=SF).rows()
    src = PN.RemoteSourceNode([PT.BIGINT], 0)
    remote = PN.OutputNode(src, ["x"])
    with pytest.raises(KeyError, match="no remote source batch"):
        run_query(remote, sf=SF, device="cpu", prepared=True)
    fed = batch_from_numpy([PT.BIGINT], [np.arange(3, dtype=np.int64)],
                           capacity=8, device="cpu")
    assert run_query(remote, sf=SF, device="cpu", prepared=True,
                     remote_sources={src.id: fed}).rows() == \
        [(0,), (1,), (2,)]
