"""The port's plan passes and constant folding against the reference's.

* Each pass alone: on one input plan, the reference's planner output
  read by each package as its own objects, `optimize_plan`,
  `reorder_joins`, `refine_capacities` and `validate_plan` give what the
  reference's give (TPC-H's 22 queries and TPC-DS's 99).
* Folding: `fold_constants` of constant expressions (math, dates,
  strings, casts, special forms) equals the reference's, doubles within
  one ulp (only `cbrt(27.0)` differs, by one ulp: XLA's is
  3.0000000000000004, the port's 3.0).
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))

from _torch_sql_common import (pinned_clock, plan_differences,  # noqa
                               port_json, ref_json)

from presto_tpu.expr import ir as RE  # noqa: E402
from presto_tpu.expr import logical as RL  # noqa: E402
from presto_tpu.plan import nodes as RN  # noqa: E402
from presto_tpu.plan.reorder import reorder_joins as ref_reorder  # noqa
from presto_tpu.plan.rules import optimize_plan as ref_optimize  # noqa
from presto_tpu.plan.stats import refine_capacities as ref_refine  # noqa
from presto_tpu.plan.validator import validate_plan as ref_validate  # noqa
from presto_tpu.queries.tpch_sql import TPCH_QUERIES  # noqa: E402
from presto_tpu.queries.tpcds_queries import TPCDS_QUERIES  # noqa: E402
from presto_tpu.sql import plan_sql as ref_plan_sql  # noqa: E402

from presto_tpu_torch.expr import ir as PE  # noqa: E402
from presto_tpu_torch.expr import logical as PL  # noqa: E402
from presto_tpu_torch.plan import nodes as PN  # noqa: E402
from presto_tpu_torch.plan.reorder import reorder_joins  # noqa: E402
from presto_tpu_torch.plan.rules import optimize_plan  # noqa: E402
from presto_tpu_torch.plan.stats import refine_capacities  # noqa: E402
from presto_tpu_torch.plan.validator import validate_plan  # noqa: E402


def _pass_inputs():
    out = [(f"tpch_q{n}", q.text, None, dict(max_groups=q.max_groups,
                                             join_capacity=q.join_capacity))
           for n, q in TPCH_QUERIES.items()]
    out += [(f"tpcds_{k}", t, "tpcds", {}) for k, t in
            sorted(TPCDS_QUERIES.items(), key=lambda kv: int(kv[0][1:]))]
    return out


PASS_INPUTS = _pass_inputs()


@pytest.fixture(scope="module")
def unprepared():
    """name -> the reference's unprepared plan (plan_sql's output)."""
    out = {}
    with pinned_clock():
        for name, text, catalog, kw in PASS_INPUTS:
            out[name] = ref_plan_sql(text, catalog=catalog, **kw)
    return out


PASSES = {
    "optimize_plan": (lambda p: optimize_plan(p), lambda p: ref_optimize(p)),
    "reorder_joins": (lambda p: reorder_joins(p, 1.0),
                      lambda p: ref_reorder(p, 1.0)),
    "refine_capacities": (lambda p: refine_capacities(p, 1.0),
                          lambda p: ref_refine(p, 1.0)),
}


@pytest.mark.parametrize("pass_name", sorted(PASSES))
@pytest.mark.parametrize("name", [c[0] for c in PASS_INPUTS])
def test_one_pass_equals_the_reference(unprepared, pass_name, name):
    """The pass over the plan the reference's planner wrote, each
    package reading it as its own objects."""
    port_pass, ref_pass = PASSES[pass_name]
    ref_in = unprepared[name]
    port_in = PN.from_json(RN.to_json(ref_in))
    # both outputs read through from_json: a pass keeps the id of a node
    # it changes, and the reading gives such a copy its own id
    got = port_json(PN.from_json(PN.to_json(port_pass(port_in))))
    d = plan_differences(got, ref_json(ref_pass(ref_in)))
    assert d is None, d


@pytest.mark.parametrize("name", [c[0] for c in PASS_INPUTS])
def test_validate_plan_equals_the_reference(unprepared, name):
    ref_in = unprepared[name]
    got = validate_plan(PN.from_json(RN.to_json(ref_in)))
    assert got == ref_validate(ref_in) == []


def _scan(table, cols):
    from presto_tpu.connectors import tpch
    return RN.TableScanNode("tpch", table, cols,
                            [tpch.column_type(table, c) for c in cols])


def test_validate_plan_finds_what_the_reference_finds():
    """Violations: an unknown connector, an unregistered function, a
    non-constant LIKE pattern, an unsupported aggregate, a date_format
    specifier and a date_trunc unit neither package runs."""
    from presto_tpu import types as RT
    from presto_tpu.expr import call, const, input_ref
    from presto_tpu.ops.aggregation import AggSpec
    scan = _scan("nation", ["name", "regionkey"])
    bad = RN.TableScanNode("nowhere", "t", ["x"], [RT.BIGINT])
    name = input_ref(0, RT.varchar(25))
    proj = RN.ProjectNode(scan, [
        call("no_such_fn", RT.BIGINT, input_ref(1, RT.BIGINT)),
        call("like", RT.BOOLEAN, name, name),
        call("date_format", RT.varchar(4), const(0, RT.DATE),
             const("%e", RT.varchar(2))),
        call("date_trunc", RT.DATE, const("hour", RT.varchar(4)),
             const(0, RT.DATE))])
    agg = RN.AggregationNode(proj, [], [AggSpec("median", 0, RT.BIGINT)])
    plan = RN.OutputNode(RN.UnionNode([RN.ProjectNode(agg, []),
                                       RN.ProjectNode(bad, [])]), [])
    want = ref_validate(plan)
    assert len(want) == 6
    assert validate_plan(PN.from_json(RN.to_json(plan))) == want


# ---- constant folding ----------------------------------------------------

FOLDED = [
    # math
    "1 + 2 * 3", "7 / 2", "-7 % 3", "1 / 0", "10 % 0", "1.0 / 0.0",
    "2.5 * 4.10", "abs(-9223372036854775807 - 1)", "9223372036854775807 + 1",
    "sqrt(2.0)", "ln(0.0)", "exp(1.0)", "power(2, 70)", "sin(1.0)",
    "log2(8.0)", "cbrt(27.0)", "atan2(1.0, 1.0)", "log(3.0, 81.0)",
    "degrees(3.141592653589793)", "floor(-2.5)", "ceil(2.1)", "sign(-3)",
    "greatest(3, 9, 4)", "least(2.5, 1.5)", "is_nan(0.0 / 0.0)",
    "bitwise_and(12, 10)", "mod(17, 5)",
    # dates and times
    "date '2020-01-31' + interval '1' month", "year(date '1998-12-01')",
    "date '1998-12-01' - interval '90' day",
    "date_trunc('month', date '2020-05-17')",
    "date_add('day', 30, date '2020-02-01')",
    "date_diff('day', date '2020-01-01', date '2020-03-01')",
    "last_day_of_month(date '2024-02-10')", "from_unixtime(0)",
    "date_format(date '2020-01-02', '%Y/%m')", "now()", "current_date",
    "day_of_week(date '2020-01-02')",
    # strings
    "length('abc')", "upper('abc')", "lower('ABC')", "substr('hello', 2, 3)",
    "substr('héllo', 2, 1)", "concat('ab', 'cd')", "trim('  x ')",
    "strpos('hello', 'l')", "chr(65)", "reverse('abc')",
    "json_extract_scalar('{\"a\":1}', '$.a')", "regexp_like('abc', 'b')",
    # casts and special forms
    "cast(2.5 as integer)", "cast('12' as bigint) + 1",
    "cast('abc' as bigint)", "cast('2020-02-30' as date)",
    "cast(7 as double) / 2", "cast(1.5 as decimal(10, 3))",
    "coalesce(NULL, 3)", "nullif(2, 2)", "if(1 > 2, 'a', 'b')",
    "CASE WHEN 2 > 1 THEN 10 ELSE 20 END", "3 BETWEEN 1 AND 5",
    "2 IN (1, 2, 3)", "NULL IS NULL",
]
# The reference folds a number or date cast to an unbounded varchar into
# a constant that keeps the source's number (cast(3.25 AS varchar) folds
# to 69 typed varchar); the port has no such cast and leaves the call
# for the run, which refuses it (ROADMAP queue 3).
NOT_FOLDED_BY_THE_PORT = ["cast(5 as varchar)", "cast(3.25 as varchar)",
                          "cast(date '2020-01-02' as varchar)"]


def _projected(text):
    """The unfolded expression of `SELECT text FROM region`, as the
    reference's planner writes it."""
    plan = ref_plan_sql(f"SELECT {text} AS x FROM region")
    n = plan
    while not isinstance(n, RN.ProjectNode):
        n = n.source
    return n.expressions[0]


@pytest.mark.parametrize("text", FOLDED)
def test_fold_constants_equals_the_reference(text):
    with pinned_clock():
        expr = _projected(text)
        want = RE.to_json(RL.fold_constants(expr))
    got = PE.to_json(PL.fold_constants(PE.from_json(RE.to_json(expr))))
    ulps = []
    d = plan_differences(got, want, ulps=ulps)
    assert d is None, d
    assert not ulps or text == "cbrt(27.0)", ulps


@pytest.mark.parametrize("text", NOT_FOLDED_BY_THE_PORT)
def test_casts_to_varchar_stay_symbolic_in_the_port(text):
    expr = _projected(text)
    assert isinstance(RL.fold_constants(expr), RE.Constant)
    port_expr = PE.from_json(RE.to_json(expr))
    assert PL.fold_constants(port_expr) == port_expr
