"""The port's ops/misc.py (limit, mark_distinct, distinct),
concat_batches, AssignUniqueId, count_distinct and the set-operation
and outer-join statements of the reference's verifier corpus, against
presto_tpu on the same inputs.

Operators get the same numpy inputs, made from a seed and staged by
both packages on the CPU; statements are planned by the reference
(plan_sql, prepare_plan at sf 0.01) and cross to the port as
plan-fragment JSON. Everything must be equal exactly.
"""

import numpy as np
import pytest
import torch

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
import jax.numpy as jnp
from presto_tpu import block as RB
from presto_tpu import types as RT
from presto_tpu.connectors import tpch as rtpch
from presto_tpu.exec import run_query as ref_run_query
from presto_tpu.exec.runner import prepare_plan
from presto_tpu.expr import call, const, input_ref
from presto_tpu.ops import aggregation as RA
from presto_tpu.ops import misc as RM
from presto_tpu.plan import nodes as RN
from presto_tpu.sql import plan_sql
from presto_tpu.verifier import DEFAULT_CORPUS

from presto_tpu_torch import block as PB
from presto_tpu_torch import types as PT
from presto_tpu_torch.exec import run_query
from presto_tpu_torch.ops import aggregation as PA
from presto_tpu_torch.ops import misc as PM
from presto_tpu_torch.plan import from_json
from presto_tpu_torch.queries import exact_rows

SF = 0.01
WORDS = ["", "a", "abcdefgh", "abcdefghi", "zz", "BUILDINGS", "héllo"]
# values: bigint, varchar, short and long decimal; then two group keys
SIGS = ["bigint", "varchar(12)", "decimal(12, 2)", "decimal(38, 2)",
        "integer", "bigint"]
# every DEFAULT_CORPUS entry runs through the port
VERIFIER_PORTED = list(range(len(DEFAULT_CORPUS)))


def _inputs(seed, n=300, distinct=12, capacity=None, inactive_share=0.1):
    """bigint, varchar, short and long decimal columns with NULLs and
    few distinct values, then a key of 8 groups and a key of about 120,
    staged by both packages."""
    rng = np.random.default_rng(seed)
    ints = rng.integers(-distinct, distinct, n).astype(np.int64)
    strs = np.array([WORDS[i] for i in rng.integers(0, len(WORDS), n)],
                    dtype=object)
    strs[rng.random(n) < 0.1] = None
    short = rng.integers(-distinct, distinct, n).astype(np.int64) * 25
    long_ = np.array([(1 << 80) * int(v) + 7 for v in
                      rng.integers(-distinct, distinct, n)], dtype=object)
    long_[rng.random(n) < 0.1] = None
    nulls = [rng.random(n) < 0.1, None, rng.random(n) < 0.1, None, None,
             None]
    arrays = [ints, strs, short, long_,
              rng.integers(0, 8, n).astype(np.int32),
              rng.integers(0, 120, n).astype(np.int64)]
    nm = [m if m is not None else np.array([v is None for v in a])
          for a, m in zip(arrays, nulls)]
    cap = capacity or n + 8
    rb = RB.batch_from_numpy([RT.parse_type(s) for s in SIGS], arrays,
                             nulls=nm, capacity=cap)
    pb = PB.batch_from_numpy([PT.parse_type(s) for s in SIGS], arrays,
                             nulls=nm, capacity=cap, device="cpu")
    act = np.asarray(rb.active).copy()
    act[rng.integers(0, n, int(n * inactive_share))] = False
    return rb.with_active(jnp.asarray(act)), pb.with_active(
        torch.from_numpy(act))


def _cols(batch, to_numpy):
    """Every slot of every column as (value or None), and the mask."""
    out = []
    for c in batch.columns:
        v, m = to_numpy(c)
        out.append([None if m[i] else (v[i].item()
                                       if isinstance(v[i], np.generic)
                                       else v[i]) for i in range(len(m))])
    return out


def _active_rows(batch, to_numpy):
    act = np.asarray(batch.active)
    return [r for r, a in zip(zip(*_cols(batch, to_numpy)), act) if a]


@pytest.mark.parametrize("n", [0, 1, 57, 10_000])
def test_limit_matches_reference(n):
    rb, pb = _inputs(seed=1)
    r, p = RM.limit(rb, n), PM.limit(pb, n)
    assert np.array_equal(np.asarray(r.active), p.active.numpy())
    assert _active_rows(p, PB.to_numpy) == _active_rows(r, RB.to_numpy)


@pytest.mark.parametrize("keys", [[0], [1], [2, 3], [1, 0], []],
                         ids=["bigint", "varchar", "decimals", "varchar_bigint",
                              "none"])
def test_mark_distinct_and_distinct_match_reference(keys):
    """NULL keys are equal; the marked row is the first active one of
    its key, in row order; inactive rows are never marked."""
    rb, pb = _inputs(seed=2)
    rmask, rover = RM.mark_distinct(rb, keys, 512)
    assert not bool(rover)
    pmask = PM.mark_distinct(pb, keys)
    assert np.array_equal(np.asarray(rmask), pmask.numpy())
    assert 0 < int(pmask.sum()) < int(pb.active.sum())
    rd, _ = RM.distinct(rb, keys, 512)
    pd = PM.distinct(pb, keys)
    assert _active_rows(pd, PB.to_numpy) == _active_rows(rd, RB.to_numpy)


def test_mark_distinct_of_no_active_rows():
    rb, pb = _inputs(seed=3, n=40, inactive_share=0)
    off = np.zeros(pb.capacity, dtype=bool)
    pb = pb.with_active(torch.from_numpy(off))
    assert not PM.mark_distinct(pb, [0, 1]).any()


def test_concat_batches_pads_string_widths_like_the_reference():
    """Three batches whose varchar columns stage at different widths
    (each at its longest value) and whose capacities differ."""
    parts = []
    for seed, n, words in ((4, 20, ["a", "bb"]), (5, 33, WORDS),
                           (6, 9, ["", "xyz"])):
        rng = np.random.default_rng(seed)
        s = np.array([words[i] for i in rng.integers(0, len(words), n)],
                     dtype=object)
        s[::5] = None
        arrays = [rng.integers(0, 9, n).astype(np.int64), s,
                  np.array([(1 << 70) + i for i in range(n)], dtype=object)]
        sigs = ["bigint", "varchar(12)", "decimal(38, 0)"]
        rb = RB.batch_from_numpy([RT.parse_type(t) for t in sigs], arrays,
                                 capacity=n + 3)
        pb = PB.batch_from_numpy([PT.parse_type(t) for t in sigs], arrays,
                                 capacity=n + 3, device="cpu")
        parts.append((rb, pb))
    assert len({p.columns[1].max_len for _, p in parts}) == 3
    r = RB.concat_batches([r for r, _ in parts])
    p = PB.concat_batches([p for _, p in parts])
    assert p.capacity == r.capacity == sum(n + 3 for n in (20, 33, 9))
    assert p.columns[1].max_len == max(q.columns[1].max_len
                                       for _, q in parts)
    assert np.array_equal(np.asarray(r.active), p.active.numpy())
    assert _cols(p, PB.to_numpy) == _cols(r, RB.to_numpy)


def _lineitem_scan(cols):
    return RN.TableScanNode("tpch", "lineitem", cols,
                            [rtpch.column_type("lineitem", c) for c in cols])


def test_assign_unique_id_matches_reference():
    """AssignUniqueId appends the row slot as a BIGINT with no NULLs,
    unique over the active rows, equal to the reference's on one
    device."""
    plan = RN.OutputNode(RN.AssignUniqueIdNode(RN.LimitNode(
        _lineitem_scan(["orderkey", "linenumber"]), 40)),
        ["orderkey", "linenumber", "id"])
    want = ref_run_query(plan, sf=SF)
    got = run_query(from_json(RN.to_json(plan)), sf=SF, device="cpu")
    assert [str(t) for t in got.types][-1] == "bigint"
    assert got.rows() == want.rows()
    ids = got.columns[-1]
    assert len(set(ids.tolist())) == got.row_count == 40
    assert not got.nulls[-1].any()


@pytest.mark.parametrize("value", [0, 1, 2, 3],
                         ids=["bigint", "varchar", "decimal", "long_decimal"])
@pytest.mark.parametrize("path,keys,max_groups", [
    ("sorted", [5], 256), ("small", [4], 16), ("keyless", [], 1)])
def test_count_distinct_matches_reference(path, keys, max_groups, value):
    """count(DISTINCT v) with NULL values (not counted) and inactive
    rows, beside count and sum, in the sorted group-by (> 64 groups),
    the small-table one and the keyless one."""
    rb, pb = _inputs(seed=9, n=400, distinct=30)
    specs = [("count_distinct", value, "bigint"), ("count", value, "bigint"),
             ("count_star", None, "bigint")]
    if value in (0, 2):
        specs.append(("sum", value, "decimal(38, 2)" if value else "bigint"))
    r = RA.group_by(rb, keys, [RA.AggSpec(nm, ch, RT.parse_type(t))
                               for nm, ch, t in specs], max_groups)
    p = PA.group_by(pb, keys, [PA.AggSpec(nm, ch, PT.parse_type(t))
                               for nm, ch, t in specs], max_groups)
    assert not bool(r.overflow) and not bool(p.overflow)
    assert int(p.num_groups) == int(r.num_groups)
    got = _active_rows(p.batch, PB.to_numpy)
    assert got == _active_rows(r.batch, RB.to_numpy)
    counts = [row[len(keys)] for row in got]
    assert max(counts) > 1 and all(c <= row[len(keys) + 1]
                                   for c, row in zip(counts, got))


def _exact(res):
    types = [PT.parse_type(str(t)) for t in res.types]
    return exact_rows(res.columns, res.nulls, types, res.row_count)


def _verifier_plan(i):
    return RN.to_json(prepare_plan(plan_sql(DEFAULT_CORPUS[i]), sf=SF))


@pytest.mark.parametrize("i", VERIFIER_PORTED, ids=lambda i: f"entry{i}")
def test_verifier_statement_returns_the_reference_rows(i):
    """Among them INTERSECT (5), UNION (6), count(DISTINCT) over a
    varchar (8), approx_distinct (9), a reduce lambda (17), RIGHT JOIN
    (19) and FULL OUTER JOIN (20)."""
    plan = _verifier_plan(i)
    want = ref_run_query(RN.from_json(plan), sf=SF, prepared=True)
    got = run_query(from_json(plan), sf=SF, device="cpu", prepared=True)
    assert want.row_count > 0
    assert got.names == list(want.names)
    assert _exact(got) == _exact(want)


def _grouped_count(table, key, max_groups):
    scan = RN.TableScanNode("tpch", table, [key],
                            [rtpch.column_type(table, key)])
    return RN.AggregationNode(scan, [0], [RA.AggSpec("count_star", None,
                                                     RT.BIGINT)],
                              max_groups=max_groups)


def test_ladder_scales_capacities_below_a_union():
    """UNION ALL of two group-bys whose tables overflow: the ladder
    must reach the aggregations inside the UnionNode's list of inputs
    (and the width annotation the scans there), or it would climb to
    its ceiling and raise."""
    from presto_tpu_torch.plan import nodes as PN
    from presto_tpu_torch.plan.stats import capacity_nodes, \
        scale_capacities
    from presto_tpu_torch.plan.widths import annotate_widths
    union = RN.UnionNode([_grouped_count("lineitem", "linenumber", 2),
                          _grouped_count("lineitem", "linenumber", 1)])
    plan = RN.OutputNode(RN.DistinctNode(union), ["k", "n"])
    want = ref_run_query(plan, sf=SF)
    root = from_json(RN.to_json(plan))
    aggs = capacity_nodes(root)
    assert [type(n) for n in aggs] == [PN.AggregationNode] * 2
    scaled = scale_capacities(root, {n.id: 4 for n in aggs}, 1 << 16)
    assert [n.max_groups for n in capacity_nodes(scaled)] == [8, 4]
    widths = annotate_widths(root, SF)
    assert widths.source.source.inputs[0].source.physical_dtypes
    got = run_query(root, sf=SF, device="cpu")
    assert got.stats["capacity_reruns"] == 1  # 4 groups: 2 -> 8, 1 -> 4
    assert want.row_count == 4
    assert sorted(got.rows()) == sorted(want.rows())


def test_repeated_node_id_is_one_shared_node():
    """A node id that repeats in the plan JSON reads as one node whose
    subtree runs once; two different nodes under one id (the reference
    keeps the id of a node its passes change) read as two nodes."""
    from presto_tpu_torch.exec import planner
    filt = RN.FilterNode(_lineitem_scan(["orderkey", "linenumber"]),
                         call("le", RT.BOOLEAN, input_ref(0, RT.BIGINT),
                              const(30, RT.BIGINT)))
    plan = RN.OutputNode(RN.JoinNode(filt, filt, [0], [0],
                                     right_output_channels=[1],
                                     out_capacity=4096),
                         ["orderkey", "linenumber", "linenumber2"])
    j = RN.to_json(plan)  # writes the shared filter under both sides
    assert j["source"]["left"] == j["source"]["right"]
    root = from_json(j)
    assert root.source.left is root.source.right
    filters = []
    real = planner.compile_filter

    def counting(pred):
        filters.append(pred)
        return real(pred)

    planner.compile_filter = counting
    try:
        got = run_query(root, sf=SF, device="cpu")
    finally:
        planner.compile_filter = real
    assert len(filters) == 1
    want = ref_run_query(plan, sf=SF)
    assert want.row_count > 0
    assert sorted(got.rows()) == sorted(want.rows())
    j["source"]["right"]["predicate"]["arguments"][1]["value"] = 31
    root = from_json(j)
    assert root.source.left is not root.source.right
    assert root.source.right.id == root.source.left.id + ".1"
    got = run_query(root, sf=SF, device="cpu")
    want = ref_run_query(RN.from_json(j), sf=SF)
    assert want.row_count > 0
    assert sorted(got.rows()) == sorted(want.rows())
