"""The port's distributed plans against the committed and the reference's.

* The 23 two-stage entries of presto_tpu_torch/queries/tpch_sf1.json
  (the reference's `add_exchanges` over its prepared SF1 plan): from
  text, the port's `prepare_plan(plan_sql(), mesh=)` (its passes, then
  `plan/distribute.py::add_exchanges` with the default BROADCAST joins,
  then the relabelling) equals the committed plan, node sharing
  included; from JSON, `add_exchanges` over the reference's prepared
  single plan read through the port's `from_json` equals it as a tree
  (ids left out: JSON cannot tell two equal copies of a subtree, which
  AddExchanges rewrites apart, from one shared node, which it keeps
  shared; q15 has the one and q21 the other).
* The 23 statements of the verifier corpus (`DEFAULT_CORPUS` +
  `TPCDS_CORPUS`): the port's `prepare_plan(mesh=)` equals the
  reference's under each join_distribution_type (BROADCAST,
  PARTITIONED, AUTOMATIC).
* `plan/fragment.py::fragment_plan` equals the reference's on
  tests/test_plan_exec.py::test_fragment_plan's plan and on distributed
  verifier plans; `distribute_simple_agg` likewise.

Plans compare as JSON with node ids renumbered by first appearance
(tests/_torch_sql_common.py), the reference's read through the port's
`from_json` first.
"""

import json

import pytest

from presto_tpu import types as RT
from presto_tpu.expr import call, const, input_ref
from presto_tpu.ops.aggregation import AggSpec as RAgg
from presto_tpu.plan import fragment as RF
from presto_tpu.plan import nodes as RN
from presto_tpu.verifier import DEFAULT_CORPUS as REF_DEFAULT
from presto_tpu.verifier import TPCDS_CORPUS as REF_TPCDS

from presto_tpu_torch.exec.runner import _fingerprint, prepare_plan
from presto_tpu_torch.plan import fragment as PF
from presto_tpu_torch.plan import nodes as PN
from presto_tpu_torch.plan.distribute import add_exchanges
from presto_tpu_torch.queries import load_corpus
from presto_tpu_torch.sql import plan_sql
from presto_tpu_torch.verifier import DEFAULT_CORPUS, TPCDS_CORPUS

from _torch_mesh_common import port_mesh
from _torch_sql_common import (pinned_clock, plan_differences, port_json,
                               ref_json, ref_prepared)

CORPUS = load_corpus()
TWO_STAGE = sorted(k for k in CORPUS if k.endswith("_two_stage"))
STATEMENTS = list(DEFAULT_CORPUS) + list(TPCDS_CORPUS)
STRATEGIES = ("BROADCAST", "PARTITIONED", "AUTOMATIC")
VERIFIER_MAX_GROUPS = 1 << 14  # verify_corpus's planning default


def _committed(name):
    return port_json(PN.from_json(CORPUS[name]["plan"]))


def test_the_corpus_has_23_two_stage_entries_and_the_verifier_23():
    assert len(TWO_STAGE) == 23
    assert STATEMENTS == list(REF_DEFAULT) + list(REF_TPCDS)
    assert len(STATEMENTS) == 23


@pytest.mark.parametrize("name", TWO_STAGE)
def test_add_exchanges_from_json_equals_the_committed_plan(name):
    e = CORPUS[name]
    single = ref_prepared(e["sql"], e["sf"], max_groups=e["max_groups"],
                          join_capacity=e["join_capacity"])
    got = add_exchanges(PN.from_json(RN.to_json(single)), sf=e["sf"])
    assert '"exchange"' in json.dumps(PN.to_json(got))
    assert _fingerprint(got) == _fingerprint(PN.from_json(e["plan"]))


@pytest.mark.parametrize("name", TWO_STAGE)
def test_add_exchanges_from_text_equals_the_committed_plan(name):
    e = CORPUS[name]
    got = prepare_plan(plan_sql(e["sql"], max_groups=e["max_groups"],
                                join_capacity=e["join_capacity"]), e["sf"],
                       mesh=port_mesh())
    d = plan_differences(port_json(got), _committed(name))
    assert d is None, d


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("i", range(len(STATEMENTS)),
                         ids=[f"s{i}" for i in range(len(STATEMENTS))])
def test_prepare_plan_on_a_mesh_equals_the_reference(mesh8, i, strategy):
    text = STATEMENTS[i]
    session = {"join_distribution_type": strategy}
    with pinned_clock():
        got = prepare_plan(plan_sql(text, max_groups=VERIFIER_MAX_GROUPS),
                           0.01, session=session, mesh=port_mesh())
        want = ref_prepared(text, 0.01, max_groups=VERIFIER_MAX_GROUPS,
                            session=session)
    from presto_tpu.plan.distribute import add_exchanges as ref_add
    from presto_tpu.plan.validator import validate_plan as ref_validate
    strategy_arg = {"BROADCAST": "broadcast", "PARTITIONED": "partitioned",
                    "AUTOMATIC": "automatic"}[strategy]
    want = ref_add(want, join_strategy=strategy_arg, sf=0.01)
    assert not ref_validate(want, distributed=True)
    d = plan_differences(port_json(got), ref_json(want))
    assert d is None, d
    # the mesh path of the reference's own prepare_plan gives that plan
    from presto_tpu.exec.runner import prepare_plan as ref_prepare_plan
    from presto_tpu.sql import plan_sql as ref_plan_sql
    with pinned_clock():
        direct = ref_prepare_plan(
            ref_plan_sql(text, max_groups=VERIFIER_MAX_GROUPS), sf=0.01,
            mesh=mesh8, session=session)
    assert ref_json(direct) == ref_json(want)


def _q1_plan():
    """tests/test_plan_exec.py::q1_plan(True), built with the
    reference's nodes."""
    d2 = RT.decimal(12, 2)
    cols = ["returnflag", "linestatus", "quantity", "extendedprice",
            "shipdate"]
    from presto_tpu.connectors import tpch
    s = RN.TableScanNode("tpch", "lineitem", cols,
                         [tpch.column_type("lineitem", c) for c in cols])
    f = RN.FilterNode(s, call("le", RT.BOOLEAN, input_ref(4, RT.DATE),
                              const("1998-09-02", RT.DATE)))
    p = RN.ProjectNode(f, [input_ref(0, RT.char(1)),
                           input_ref(1, RT.char(1)), input_ref(2, d2),
                           input_ref(3, d2)])
    aggs = [RAgg("sum", 2, RT.decimal(38, 2)),
            RAgg("count_star", None, RT.BIGINT)]
    partial = RN.AggregationNode(p, [0, 1], aggs, step="PARTIAL",
                                 max_groups=16)
    ex = RN.ExchangeNode(partial, kind="REPARTITION", scope="REMOTE",
                         partition_channels=[0, 1], slot_capacity=16)
    agg = RN.AggregationNode(ex, [0, 1], aggs, step="FINAL", max_groups=16)
    gather = RN.ExchangeNode(agg, kind="GATHER", scope="REMOTE")
    single = RN.OutputNode(RN.AggregationNode(p, [0, 1], aggs, step="SINGLE",
                                              max_groups=16),
                           ["rf", "ls", "sum_qty", "cnt"])
    return RN.OutputNode(gather, ["rf", "ls", "sum_qty", "cnt"]), single


def _fragments_json(frags, read):
    return [{**{k: v for k, v in f.to_json().items() if k != "root"},
             "root": read(f.root)} for f in frags]


def _same_fragments(ref_root):
    port_root = PN.from_json(RN.to_json(ref_root))
    want = _fragments_json(RF.fragment_plan(ref_root), ref_json)
    got = _fragments_json(PF.fragment_plan(port_root), port_json)
    assert got == want
    return got


def test_fragment_plan_equals_the_reference():
    got = _same_fragments(_q1_plan()[0])
    assert [f["partitioning"] for f in got] == ["HASH", "SINGLE", "SINGLE"]
    assert [f["remoteSources"] for f in got] == [[], [0], [1]]


@pytest.mark.parametrize("i", [0, 7, 12, 15, 20, 22])
def test_fragment_plan_of_distributed_statements_equals_the_reference(i):
    with pinned_clock():
        plan = ref_prepared(STATEMENTS[i], 0.01,
                            max_groups=VERIFIER_MAX_GROUPS)
    from presto_tpu.plan.distribute import add_exchanges as ref_add
    _same_fragments(ref_add(plan, join_strategy="partitioned", sf=0.01))


def test_distribute_simple_agg_equals_the_reference():
    single = _q1_plan()[1]
    want = ref_json(RF.distribute_simple_agg(single))
    got = port_json(PF.distribute_simple_agg(
        PN.from_json(RN.to_json(single))))
    assert got == want
    assert "GATHER" in str(got)
