"""ValuesNode and SampleNode through the port's run_query against the
reference's rows: their plan JSON, the VALUES batch the runner stages
(every flat type, NULLs, a node without columns), and BERNOULLI
sampling by the hash of the row slot."""

import dataclasses

import pytest
import torch

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
from presto_tpu import types as RT
from presto_tpu.exec import run_query as ref_run_query
from presto_tpu.exec.runner import prepare_plan
from presto_tpu.ops.aggregation import AggSpec
from presto_tpu.expr import call, input_ref
from presto_tpu.plan import nodes as RN
from presto_tpu.sql import plan_sql

from presto_tpu_torch import types as PT
from presto_tpu_torch.exec import run_query
from presto_tpu_torch.plan import from_json, to_json
from presto_tpu_torch.queries import exact_rows

SF = 0.01
SIGS = ["bigint", "varchar(5)", "decimal(12, 2)", "decimal(38, 2)", "date",
        "double", "boolean", "timestamp", "integer", "varbinary"]
ROWS = [
    [1, "a", 250, 10 ** 30 + 7, 18262, 2.5, True, 1583065845000000, 7,
     "ab"],
    [None, None, None, None, None, None, None, None, None, None],
    [-(1 << 63), "", -125, -(10 ** 30), -1, -0.0, False, -1, -(1 << 31),
     ""],
    [(1 << 63) - 1, "héllo", 99999999, 5, 0, float("inf"), True, 0,
     (1 << 31) - 1, "xyz"],
]


def _exact(res):
    types = [PT.parse_type(str(t)) for t in res.types]
    return exact_rows(res.columns, res.nulls, types, res.row_count)


def _both(plan, sf=SF):
    """(reference rows, port rows) of a reference plan, the port reading
    its JSON."""
    want = _exact(ref_run_query(plan, sf=sf, prepared=True))
    got = _exact(run_query(from_json(RN.to_json(plan)), sf=sf,
                           device="cpu", prepared=True))
    return want, got


def _values(rows=ROWS, sigs=SIGS):
    return RN.ValuesNode([RT.parse_type(s) for s in sigs],
                         [list(r) for r in rows])


def test_values_and_sample_json_round_trips():
    plan = RN.OutputNode(RN.SampleNode(_values(), 0.25),
                         [f"c{i}" for i in range(len(SIGS))])
    j = RN.to_json(plan)
    assert to_json(from_json(j)) == j


@pytest.mark.parametrize("n_rows", [1, 4, 9])
def test_values_rows_equal_the_reference(n_rows):
    rows = (ROWS * 3)[:n_rows]
    want, got = _both(RN.OutputNode(_values(rows),
                                    [f"c{i}" for i in range(len(SIGS))]))
    assert got == want and len(got) == n_rows


def test_values_feed_expressions_and_aggregation_like_the_reference():
    vals = _values(ROWS * 5)
    proj = RN.ProjectNode(vals, [
        call("add", RT.BIGINT, input_ref(8, RT.INTEGER),
             input_ref(8, RT.INTEGER)),
        call("upper", RT.parse_type("varchar(5)"),
             input_ref(1, RT.parse_type("varchar(5)"))),
        input_ref(3, RT.parse_type("decimal(38, 2)"))])
    agg = RN.AggregationNode(proj, [1], [
        AggSpec("count_star", None, RT.BIGINT),
        AggSpec("sum", 0, RT.BIGINT),
        AggSpec("max", 2, RT.parse_type("decimal(38, 2)"))], "SINGLE", 16)
    plan = RN.OutputNode(RN.SortNode(agg, [(0, False, True)]),
                         ["k", "n", "s", "m"])
    want, got = _both(plan)
    assert got == want and len(got) == 4


def test_a_values_node_without_columns_is_its_rows():
    """A FROM-less SELECT reads one row of no columns."""
    plan = prepare_plan(plan_sql("SELECT 1 + 2 AS x, 'x' AS y, "
                                 "date '2020-02-29' + interval '1' year "
                                 "AS d"), sf=SF)
    want, got = _both(plan)
    assert got == want == [[3, "x", 18686]]  # 2021-02-28


def _sampled(table, columns, ratio, rows_sql=None):
    """The reference's prepared plan of an aggregate over `table`, with a
    SampleNode over its scan."""
    sql = rows_sql or (f"SELECT count(*) c, sum({columns[0]}) s, "
                       f"min({columns[1]}) m FROM {table}")
    plan = prepare_plan(plan_sql(sql), sf=SF)

    def walk(n):
        if isinstance(n, RN.TableScanNode):
            return RN.SampleNode(n, ratio)
        changes = {f.name: walk(getattr(n, f.name))
                   for f in dataclasses.fields(n)
                   if isinstance(getattr(n, f.name), RN.PlanNode)}
        return dataclasses.replace(n, **changes) if changes else n
    return walk(plan)


@pytest.mark.parametrize("ratio", [0.0, 0.01, 0.1, 0.5, 0.9, 0.999999])
@pytest.mark.parametrize("table,columns", [
    ("lineitem", ["quantity", "shipdate"]),
    ("orders", ["totalprice", "orderpriority"])])
def test_sample_keeps_the_reference_rows(table, columns, ratio):
    want, got = _both(_sampled(table, columns, ratio))
    assert got == want
    if 0.0 < ratio < 0.999:
        total = ref_run_query(prepare_plan(plan_sql(
            f"SELECT count(*) FROM {table}"), sf=SF), sf=SF,
            prepared=True).rows()[0][0]
        assert 0 < got[0][0] < total


def test_sample_over_values_and_grouped_rows_match_the_reference():
    plan = RN.OutputNode(RN.SampleNode(_values(ROWS * 8), 0.4),
                         [f"c{i}" for i in range(len(SIGS))])
    want, got = _both(plan)
    assert got == want and 0 < len(got) < 32
    grouped = _sampled("lineitem", None, 0.3, rows_sql=(
        "SELECT returnflag, count(*) c, sum(extendedprice) s FROM lineitem "
        "GROUP BY returnflag ORDER BY returnflag"))
    want, got = _both(grouped)
    assert got == want and len(got) == 3


def test_a_ratio_of_one_keeps_every_row():
    """The reference's threshold int(1.0 * (2^64 - 1)) is 2^64, which its
    uint64 cannot hold (it raises); the port keeps every row."""
    plan = _sampled("orders", ["totalprice", "orderdate"], 1.0)
    with pytest.raises(OverflowError):
        ref_run_query(plan, sf=SF, prepared=True)
    got = _exact(run_query(from_json(RN.to_json(plan)), sf=SF,
                           device="cpu", prepared=True))
    whole = _exact(ref_run_query(prepare_plan(plan_sql(
        "SELECT count(*) c, sum(totalprice) s, min(orderdate) m "
        "FROM orders"), sf=SF), sf=SF, prepared=True))
    assert got == whole


def test_sample_decides_by_the_slot_hash():
    """Row slot i stays where splitmix64(i), read unsigned, is at most
    ratio * (2^64 - 1): the rule the reference applies."""
    from presto_tpu_torch.exec.planner import sample
    from presto_tpu_torch.block import Batch
    n = 4096
    batch = Batch((), torch.ones(n, dtype=torch.bool))
    kept = sample(batch, 0.25).active.numpy()

    def mix(z):
        m = (1 << 64) - 1
        z = (z + 0x9E3779B97F4A7C15) & m
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & m
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m
        return z ^ (z >> 31)
    thresh = int(0.25 * float(2 ** 64 - 1))
    assert kept.tolist() == [mix(i) <= thresh for i in range(n)]
    assert abs(kept.mean() - 0.25) < 0.03
