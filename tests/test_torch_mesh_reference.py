"""Mesh rows of the port against the reference's mesh rows.

Each case runs through the reference's `sql`/`run_query(mesh=mesh8)`
(one shard_map program over the 8-device CPU mesh) and the port's
`sql`/`run_query(mesh=)` over eight CPU workers: TPC-H q1 (q21 and q3
in tests/test_torch_mesh_reference2.py), an ORDER BY over NULLs and strings (a MERGE: range
exchange and a sort per worker, in global order), a TopN and a Limit
(partial, GATHER, final), a partitioned window, a FULL join, and a
SampleNode over a scan (each worker hashes its own row slots, so the
mesh keeps other rows than one device). The rows must be the
reference's, in order where the statement orders them, and the
exchange-slot ladder must rerun where the reference's does. A RIGHT or
FULL join over a replicated build, and a SINGLE global aggregation, are
refused on a mesh, as in the reference.
"""

import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.exec import run_query as ref_run_query
from presto_tpu.expr import call, const, input_ref
from presto_tpu.plan import nodes as RN
from presto_tpu.sql import sql as ref_sql

from presto_tpu_torch import sql
from presto_tpu_torch import types as PT
from presto_tpu_torch.exec import run_query
from presto_tpu_torch.exec.planner import compile_plan
from presto_tpu_torch.exec.runner import stage_scans
from presto_tpu_torch.ops.aggregation import AggSpec
from presto_tpu_torch.plan import nodes as PN
from presto_tpu_torch.queries import load_corpus

from _torch_mesh_common import canon, port_mesh

SF = 0.01
CORPUS = load_corpus()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while the module runs: eight workers' small ops
    only oversubscribe the cores under the parallel test run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(res):
    return [tuple(canon(v) for v in r) for r in res.rows()]


def _slot_reruns(res):
    """exchange_slot_reruns of either package's result (the reference
    keeps a counter's count, total and max)."""
    v = res.stats.get("exchange_slot_reruns", 0)
    return int(v["total"]) if isinstance(v, dict) else v


def tpch_case(n, **session):
    """(text, keywords, ordered) of TPC-H qn as the corpus plans it."""
    e = CORPUS[f"q{n}_two_stage"]
    return e["sql"], dict(max_groups=e["max_groups"],
                          join_capacity=e["join_capacity"],
                          session=session or None), n != 1


CASES = {
    "q1": tpch_case(1),
    "order_by_nulls_strings": (
        "SELECT orderkey, linenumber, CASE WHEN linenumber > 2 THEN "
        "shipmode END AS m FROM lineitem WHERE quantity < 5 "
        "ORDER BY m DESC, orderkey, linenumber", {}, True),
    "topn": ("SELECT orderkey, extendedprice FROM lineitem "
             "ORDER BY extendedprice DESC, orderkey LIMIT 23", {}, True),
    "limit": ("SELECT orderkey, custkey FROM orders LIMIT 17", {}, False),
    "partitioned_window": (
        "SELECT orderkey, suppkey, rank() OVER (PARTITION BY suppkey "
        "ORDER BY extendedprice DESC) r FROM lineitem WHERE quantity < 5",
        {}, False),
    "full_join": (
        "SELECT o.orderkey, c.custkey, c.name FROM orders o FULL OUTER "
        "JOIN customer c ON o.custkey = c.custkey", {}, False),
}


def assert_mesh_rows_equal_the_references(mesh8, text, kw, ordered):
    want = ref_sql(text, sf=SF, mesh=mesh8, **kw)
    got = sql(text, sf=SF, mesh=port_mesh(), **kw)
    assert got.row_count == want.row_count > 0
    if ordered:
        assert _rows(got) == _rows(want)
    else:
        assert sorted(_rows(got), key=repr) == sorted(_rows(want), key=repr)
    assert _slot_reruns(got) == _slot_reruns(want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_rows_equal_the_references(mesh8, name):
    assert_mesh_rows_equal_the_references(mesh8, *CASES[name])


def _sample_plan():
    from presto_tpu.connectors import tpch
    cols = ["orderkey", "linenumber", "quantity"]
    scan = RN.TableScanNode("tpch", "lineitem", cols,
                            [tpch.column_type("lineitem", c) for c in cols])
    f = RN.FilterNode(scan, call("lt", RT.BOOLEAN,
                                 input_ref(2, tpch.column_type("lineitem",
                                                               "quantity")),
                                 const(20, RT.BIGINT)))
    return RN.OutputNode(RN.SampleNode(f, 0.3), cols)


def test_sample_keeps_the_references_mesh_rows(mesh8):
    plan = _sample_plan()
    want = ref_run_query(plan, sf=SF, mesh=mesh8)
    port_plan = PN.from_json(RN.to_json(plan))
    got = run_query(port_plan, sf=SF, mesh=port_mesh())
    assert sorted(_rows(got)) == sorted(_rows(want))
    one = run_query(PN.from_json(RN.to_json(plan)), sf=SF, device="cpu")
    assert sorted(_rows(one)) != sorted(_rows(got))


def test_exchange_slot_ladder_reruns_where_the_references_does(mesh8):
    """ORDER BY a key in storage order: each worker's rows fall in one
    range, more than the MERGE's default slot of half a shard holds at
    sf 0.002, so both ladders double the slots until the rows fit."""
    text = ("SELECT orderkey, linenumber FROM lineitem WHERE quantity < 30 "
            "ORDER BY orderkey, linenumber")
    want = ref_sql(text, sf=0.002, mesh=mesh8)
    got = sql(text, sf=0.002, mesh=port_mesh())
    assert _rows(got) == _rows(want)
    assert _slot_reruns(got) == _slot_reruns(want) > 0


def test_mesh_refuses_what_the_reference_refuses():
    mesh = port_mesh(2)
    cols = ["regionkey", "name"]
    scan = PN.TableScanNode("tpch", "region", cols,
                            [PT.BIGINT, PT.parse_type("varchar(25)")])
    other = PN.TableScanNode("tpch", "region", cols,
                             [PT.BIGINT, PT.parse_type("varchar(25)")])
    full = PN.OutputNode(PN.JoinNode(scan, PN.ExchangeNode(
        other, kind="REPLICATE", scope="REMOTE"), [0], [0], "full",
        right_output_channels=[1]), ["a", "b", "c"])
    agg = PN.OutputNode(PN.AggregationNode(
        scan, [], [AggSpec("count_star", None, PT.BIGINT)], "SINGLE", 1),
        ["n"])
    for plan, match in ((full, "RIGHT or FULL"), (agg, "SINGLE global")):
        batches = stage_scans(plan, SF, "cpu", mesh=mesh)
        with pytest.raises(ValueError, match=match):
            compile_plan(plan, mesh=mesh).fn(batches)
