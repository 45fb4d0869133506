"""The port's join, top-N, sorted group-by and overflow ladder against
presto_tpu's.

The same numpy inputs, made from a seed, are staged through
presto_tpu.block and presto_tpu_torch.block (on the CPU) and go through
the reference's function and the port's counterpart. Rows must be equal
exactly: as multisets for a join (both sides emit probe order, but the
reference's build sort does not fix the order of equal keys), in order
for top-N and the group tables.
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
from presto_tpu.expr import call, const, input_ref
from presto_tpu.ops import aggregation as RA
from presto_tpu.ops import join as RJ
from presto_tpu.ops import sort as RS
from presto_tpu.plan import nodes as RN

from presto_tpu_torch import block as PB
from presto_tpu_torch import types as PT
from presto_tpu_torch.exec import run_query
from presto_tpu_torch.ops import aggregation as PA
from presto_tpu_torch.ops import join as PJ
from presto_tpu_torch.ops import sort as PS
from presto_tpu_torch.plan import from_json
from presto_tpu_torch.plan.stats import _CAPACITY_CEILING

WORDS = ["", "a", "ab", "abcdefgh", "abcdefghi", "abcdefghij", "zz",
         "BUILDING", "BUILDINGS", "héllo"]


def _strings(rng, n, null_rate=0.1):
    s = np.array([WORDS[i] for i in rng.integers(0, len(WORDS), n)],
                 dtype=object)
    s[rng.random(n) < null_rate] = None
    return s


def _stage(sigs, arrays, capacity, nulls=None, inactive=None, widths=None):
    """The same columns staged by both packages. Object arrays take
    their nulls from None; `nulls` gives the others a mask; `inactive`
    live rows are switched off in both; `widths` pads string columns."""
    nulls = nulls or [None] * len(arrays)
    nm = [m if m is not None else (np.array([v is None for v in a])
                                   if a.dtype == object else None)
          for a, m in zip(arrays, nulls)]
    rb = RB.batch_from_numpy([RT.parse_type(s) for s in sigs], arrays,
                             nulls=nm, capacity=capacity)
    pb = PB.batch_from_numpy([PT.parse_type(s) for s in sigs], arrays,
                             nulls=nm, capacity=capacity, device="cpu")
    if widths:
        rc, pc = list(rb.columns), list(pb.columns)
        for i, w in widths.items():
            rc[i] = RJ._pad_chars(rc[i], w)
            pc[i] = PB.pad_chars(pc[i], w)
        rb, pb = RB.Batch(tuple(rc), rb.active), PB.Batch(tuple(pc),
                                                          pb.active)
    if inactive is not None:
        act = np.asarray(rb.active).copy()
        act[inactive] = False
        rb = rb.with_active(jnp.asarray(act))
        pb = pb.with_active(torch.from_numpy(act))
    return rb, pb


def _cell(v):
    return v.item() if isinstance(v, np.generic) else v


def _rows(batch, to_numpy):
    act = batch.active.numpy() if isinstance(batch.active, torch.Tensor) \
        else np.asarray(batch.active)
    cols = [to_numpy(c) for c in batch.columns]
    return [tuple(None if n[i] else _cell(v[i]) for v, n in cols)
            for i in np.flatnonzero(act)]


def _ref_rows(batch):
    return _rows(batch, RB.to_numpy)


def _port_rows(batch):
    return _rows(batch, PB.to_numpy)


def _key(row):
    return tuple((x is None, str(type(x)), x if x is not None else 0)
                 for x in row)


def _join_inputs(kind, seed):
    """(probe, build) staged by both packages, their key channels. Each
    side carries payload columns after its keys: short and long
    decimals and a varchar."""
    rng = np.random.default_rng(seed)
    np_, nb = 300, 120
    if kind in ("bigint", "integer"):
        dt = np.int64 if kind == "bigint" else np.int32
        pk = [rng.integers(0, 40, np_).astype(dt)]
        bk = [rng.integers(20, 60, nb).astype(dt)]
        psig, bsig = [kind], [kind]
        pnull = [rng.random(np_) < 0.1]
        bnull = [rng.random(nb) < 0.1]
        widths = (None, None)
    elif kind == "varchar":
        pk, bk = [_strings(rng, np_)], [_strings(rng, nb)]
        psig, bsig = ["varchar(12)"], ["varchar(20)"]
        pnull = bnull = [None]
        widths = ({0: 12}, {0: 20})
    else:  # two key columns: an integer and a varchar
        pk = [rng.integers(0, 4, np_).astype(np.int64), _strings(rng, np_)]
        bk = [rng.integers(0, 4, nb).astype(np.int32), _strings(rng, nb)]
        psig, bsig = ["bigint", "varchar(12)"], ["integer", "varchar(10)"]
        pnull = bnull = [None, None]
        widths = ({1: 12}, {1: 10})
    big = np.array([(1 << 100) + i for i in range(nb)], dtype=object)
    big[3] = None
    probe = _stage(psig + ["decimal(12, 2)", "varchar(12)"],
                   pk + [rng.integers(-10 ** 9, 10 ** 9, np_),
                         _strings(rng, np_)],
                   np_ + 8, nulls=pnull + [None, None],
                   inactive=rng.integers(0, np_, np_ // 10),
                   widths=widths[0])
    build = _stage(bsig + ["bigint", "decimal(38, 2)", "varchar(12)"],
                   bk + [rng.integers(-10 ** 9, 10 ** 9, nb), big,
                         _strings(rng, nb)],
                   nb + 8, nulls=bnull + [None, None, None],
                   inactive=rng.integers(0, nb, nb // 10),
                   widths=widths[1])
    return probe, build, list(range(len(pk))), list(range(len(bk)))


@pytest.mark.parametrize("kind", ["bigint", "integer", "varchar",
                                  "int_and_varchar"])
def test_hash_join_matches_reference(kind):
    """Duplicate keys on both sides, null keys, inactive rows; int64,
    int32, multi-word varchar keys of two widths, and a two-column key."""
    (rp, pp), (rb, pb), pk, bk = _join_inputs(kind, seed=7)
    outs = [len(rb.columns) - 3, len(rb.columns) - 2, len(rb.columns) - 1]
    r = RJ.hash_join(rp, rb, pk, bk, 4096, "inner", outs)
    p = PJ.hash_join(pp, pb, pk, bk, 4096, "inner", outs)
    assert int(r.num_rows) == int(p.num_rows) > 0
    assert not bool(r.overflow) and not bool(p.overflow)
    got, want = _port_rows(p.batch), _ref_rows(r.batch)
    assert len(got) == int(p.num_rows)
    assert sorted(got, key=_key) == sorted(want, key=_key)


def test_hash_join_flags_overflow():
    (rp, pp), (rb, pb), pk, bk = _join_inputs("bigint", seed=3)
    r = RJ.hash_join(rp, rb, pk, bk, 16)
    p = PJ.hash_join(pp, pb, pk, bk, 16)
    assert bool(r.overflow) and bool(p.overflow)
    assert int(r.num_rows) == int(p.num_rows) > 16
    # the first 16 matches are emitted, the same multiset as the reference
    assert sorted(_port_rows(p.batch), key=_key) == \
        sorted(_ref_rows(r.batch), key=_key)
    # a left join overflows the same way: the same count and first slots
    r = RJ.hash_join(rp, rb, pk, bk, 16, join_type="left")
    p = PJ.hash_join(pp, pb, pk, bk, 16, join_type="left")
    assert bool(r.overflow) and bool(p.overflow)
    assert int(r.num_rows) == int(p.num_rows) > 16
    assert sorted(_port_rows(p.batch), key=_key) == \
        sorted(_ref_rows(r.batch), key=_key)


def _topn_inputs(seed):
    rng = np.random.default_rng(seed)
    n = 200
    pool = [(1 << 90) + 5, -(1 << 90), 12345, -1, 0, (1 << 64) - 1, None]
    dec = np.array([pool[i] for i in rng.integers(0, len(pool), n)],
                   dtype=object)
    date = rng.integers(9000, 9010, n).astype(np.int32)
    ids = np.arange(n, dtype=np.int64)
    return _stage(["decimal(38, 4)", "date", "bigint"], [dec, date, ids],
                  n + 8, inactive=rng.integers(0, n, 20))


@pytest.mark.parametrize("keys,count", [
    ([(0, True, True), (1, False, True)], 10),
    ([(0, True, False), (1, True, True)], 25),
    ([(1, False, True), (0, False, True)], 500),
])
def test_top_n_matches_reference(keys, count):
    """A descending decimal(38, 4) key (Int128 lanes) with ties and
    nulls, a date key, inactive rows; n below and above the capacity."""
    rb, pb = _topn_inputs(seed=11)
    r = RS.top_n(rb, [RS.SortKey(*k) for k in keys], count)
    p = PS.top_n(pb, keys, count)
    assert p.capacity == r.capacity
    assert _port_rows(p) == _ref_rows(r)


def _group_inputs(seed, n=400, groups=100):
    rng = np.random.default_rng(seed)
    k1 = rng.integers(0, groups // 4, n).astype(np.int64)
    k2 = np.array([WORDS[i % 4] for i in rng.integers(0, 4, n)],
                  dtype=object)
    big = np.array([int(v) * (1 << 70) + int(w) for v, w in
                    zip(rng.integers(-5, 5, n), rng.integers(0, 1 << 60, n))],
                   dtype=object)
    big[rng.random(n) < 0.1] = None
    dec = rng.integers(-10 ** 9, 10 ** 9, n)
    cnt = rng.integers(0, 1000, n).astype(np.int32)
    k1n = rng.random(n) < 0.05
    return _stage(["bigint", "varchar(10)", "decimal(38, 4)",
                   "decimal(12, 2)", "integer"], [k1, k2, big, dec, cnt],
                  n + 8, nulls=[k1n, None, None, None, None],
                  inactive=rng.integers(0, n, 30))


def _aggs(mod, T):
    return [mod.AggSpec("sum", 2, T.decimal(38, 4)),
            mod.AggSpec("sum", 3, T.decimal(38, 2)),
            mod.AggSpec("sum", 4, T.BIGINT),
            mod.AggSpec("avg", 3, T.decimal(12, 2)),
            mod.AggSpec("count", 2, T.BIGINT),
            mod.AggSpec("count_star", None, T.BIGINT)]


@pytest.mark.parametrize("max_groups,empty", [(128, False), (16, False),
                                              (128, True)],
                         ids=["fits", "overflow", "empty"])
def test_group_by_sorted_matches_reference(max_groups, empty):
    """128-bit and short-decimal sums, an integer sum, avg, count and
    count(*) per (bigint with nulls, varchar) key; more groups than
    max_groups (overflow), and an input with no active row."""
    rb, pb = _group_inputs(seed=5)
    if empty:
        rb = rb.with_active(jnp.zeros(rb.capacity, dtype=bool))
        pb = pb.with_active(torch.zeros(pb.capacity, dtype=torch.bool))
    r = RA._group_by_sorted(rb, [0, 1], _aggs(RA, RT), max_groups)
    p = PA._group_by_sorted(pb, [0, 1], _aggs(PA, PT), max_groups)
    assert int(r.num_groups) == int(p.num_groups)
    assert bool(r.overflow) == bool(p.overflow) == (
        int(r.num_groups) > max_groups)
    assert _port_rows(p.batch) == _ref_rows(r.batch)
    if max_groups > PA.SMALL_G:  # group_by dispatches to the sorted path
        g = PA.group_by(pb, [0, 1], _aggs(PA, PT), max_groups)
        assert _port_rows(g.batch) == _port_rows(p.batch)


def _wide_q1(max_groups):
    """q1's shape (filter, 128-bit projections, sums, avgs, count(*),
    sort) grouped by four lineitem columns: 3 x 2 x 11 x 9 possible
    groups, far more than 64."""
    d2 = RT.decimal(12, 2)
    cols = ["returnflag", "linestatus", "quantity", "extendedprice",
            "discount", "tax", "shipdate"]
    scan = RN.TableScanNode("tpch", "lineitem", cols,
                            [rtpch.column_type("lineitem", c) for c in cols])
    filt = RN.FilterNode(scan, call("le", RT.BOOLEAN, input_ref(6, RT.DATE),
                                    const("1998-09-02", RT.DATE)))
    disc_price = call("multiply", RT.decimal(24, 4), input_ref(3, d2),
                      call("subtract", d2, const(100, d2), input_ref(4, d2)))
    proj = RN.ProjectNode(filt, [input_ref(0, RT.char(1)),
                                 input_ref(1, RT.char(1)), input_ref(4, d2),
                                 input_ref(5, d2), input_ref(2, d2),
                                 disc_price])
    aggs = [RA.AggSpec("sum", 4, RT.decimal(38, 2)),
            RA.AggSpec("sum", 5, RT.decimal(38, 4)),
            RA.AggSpec("avg", 4, d2),
            RA.AggSpec("count_star", None, RT.BIGINT)]
    agg = RN.AggregationNode(proj, [0, 1, 2, 3], aggs,
                             max_groups=max_groups)
    return RN.OutputNode(RN.SortNode(agg, [(i, False, True)
                                           for i in range(4)]),
                         ["rf", "ls", "disc", "tax", "sum_qty",
                          "sum_disc_price", "avg_qty", "count"])


def test_ladder_scales_capacities_like_the_reference():
    """max_groups=16 over several hundred groups: the reference climbs
    its 4x ladder to rows; so must the port (16 -> 64 on the small-table
    path, then the sorted path), and a repeat starts from the scale that
    worked."""
    want = ref_run_query(_wide_q1(16), sf=0.01)
    assert want.row_count > 256
    from presto_tpu_torch.exec import runner
    runner._CAPACITY_FEEDBACK.clear()
    got = run_query(from_json(RN.to_json(_wide_q1(16))), sf=0.01,
                    device="cpu")
    assert got.rows() == want.rows()
    ladder = ("capacity_reruns", "capacity_scale")
    assert {k: got.stats[k] for k in ladder} == \
        {"capacity_reruns": 3, "capacity_scale": 64}
    again = run_query(from_json(RN.to_json(_wide_q1(16))), sf=0.01,
                      device="cpu")
    assert again.rows() == want.rows()
    assert {k: again.stats[k] for k in ladder} == \
        {"capacity_reruns": 0, "capacity_scale": 64}


@pytest.mark.parametrize("n", [12, 5], ids=lambda n: f"q{n}")
def test_ladder_raises_only_the_capacities_that_overflowed(n):
    """A TPC-H plan at sf 0.01 with its deepest join's out_capacity cut
    to 64 rows: that join overflows and climbs the ladder, each join
    above it (its input cut short) climbs with it, and the small
    aggregation on top keeps its max_groups (the small-table path);
    the rows are the reference's."""
    from presto_tpu.exec.runner import prepare_plan
    from presto_tpu.queries.tpch_sql import TPCH_QUERIES
    from presto_tpu.sql import plan_sql
    from presto_tpu_torch.exec import runner
    from presto_tpu_torch.ops.aggregation import SMALL_G
    from presto_tpu_torch.plan import nodes as PN
    from presto_tpu_torch.plan import to_json
    from presto_tpu_torch.plan.stats import capacity_nodes
    from presto_tpu_torch.plan.widths import annotate_widths
    q = TPCH_QUERIES[n]
    prepared = prepare_plan(plan_sql(q.text, max_groups=q.max_groups,
                                     join_capacity=q.join_capacity),
                            sf=0.01)
    want = ref_run_query(prepared, sf=0.01, prepared=True)
    root = from_json(RN.to_json(prepared))
    nodes = capacity_nodes(root)
    joins = [k for k, x in enumerate(nodes) if isinstance(x, PN.JoinNode)]
    aggs = [k for k, x in enumerate(nodes)
            if isinstance(x, PN.AggregationNode)]
    assert [nodes[k].max_groups for k in aggs] == [8 if n == 12 else 32]
    deepest = joins[-1]
    nodes[deepest].out_capacity = 64
    plan = to_json(root)
    runner._CAPACITY_FEEDBACK.clear()
    got = run_query(from_json(plan), sf=0.01, device="cpu", prepared=True)
    assert got.rows() == want.rows()
    assert got.stats["capacity_reruns"] > 0
    scale = got.stats["capacity_scale"]
    assert scale > 1
    before = [x.out_capacity if k in joins else x.max_groups
              for k, x in enumerate(nodes)]
    fitted = capacity_nodes(runner.capacity_plan(
        annotate_widths(from_json(plan), 0.01)))
    after = [x.out_capacity if k in joins else x.max_groups
             for k, x in enumerate(fitted)]
    for k in aggs:
        assert after[k] == before[k] <= SMALL_G
    for k in joins:  # the chain from the root down to the cut join
        assert after[k] == min(before[k] * scale, _CAPACITY_CEILING)
