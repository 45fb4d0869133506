"""The port's GroupId lowering, block.null_like, the Window/RowNumber/
GroupId plan JSON, the scalar functions negate, abs, upper and concat,
and the casts and comparisons with a double that TPC-DS reaches,
against presto_tpu on the same inputs.

Functions and null_like take seeded numpy columns staged by both
packages; the plans (ROLLUP, CUBE, explicit GROUPING SETS, a bare
GroupId, a RowNumber with a per-partition cap, window frames) are
planned by the reference and cross to the port as plan-fragment JSON.
Everything must be equal exactly.
"""

import numpy as np
import pytest
import torch

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
from presto_tpu import block as RB
from presto_tpu import types as RT
from presto_tpu.connectors import tpch as rtpch
from presto_tpu.exec import run_query as ref_run_query
from presto_tpu.exec.runner import prepare_plan
from presto_tpu.expr import call, const, input_ref
from presto_tpu.expr import compile as RC
from presto_tpu.expr import ir as RIR
from presto_tpu.plan import nodes as RN
from presto_tpu.sql import plan_sql

from presto_tpu_torch import block as PB
from presto_tpu_torch import types as PT
from presto_tpu_torch.exec import run_query
from presto_tpu_torch.expr import compile as PC
from presto_tpu_torch.expr import ir as PIR
from presto_tpu_torch.plan import from_json, to_json
from presto_tpu_torch.queries import exact_rows

SF = 0.01
WORDS = ["", "a", "store", "Mixed Case 9", "abcdefghij", "zZ", "héllo"]
SIGS = ["varchar(10)", "decimal(38, 4)", "bigint", "double",
        "decimal(12, 2)", "varchar(3)"]
STR, LONG, BIG, DBL, SHORT, STR3 = range(6)


def _batches(seed, n=120):
    rng = np.random.default_rng(seed)
    words = np.array([WORDS[i] for i in rng.integers(0, len(WORDS), n)],
                     dtype=object)
    words[rng.random(n) < 0.1] = None
    big = np.array([int(v) * (1 << 66) + int(w) for v, w in
                    zip(rng.integers(-3, 3, n), rng.integers(-9, 9, n))],
                   dtype=object)
    big[rng.random(n) < 0.1] = None
    ints = rng.integers(-10 ** 6, 10 ** 6, n).astype(np.int64)
    dbl = rng.normal(0.0, 50.0, n)
    dbl[:3] = [0.0, -0.0, -1.5]
    short = rng.integers(-10 ** 5, 10 ** 5, n).astype(np.int64)
    tiny = np.array([["ab", "c", ""][i] for i in rng.integers(0, 3, n)],
                    dtype=object)
    arrays = [words, big, ints, dbl, short, tiny]
    nulls = [np.array([v is None for v in words]),
             np.array([v is None for v in big]), rng.random(n) < 0.1,
             rng.random(n) < 0.1, rng.random(n) < 0.1, rng.random(n) < 0.1]
    rb = RB.batch_from_numpy([RT.parse_type(s) for s in SIGS], arrays,
                             nulls=nulls, capacity=n + 8)
    pb = PB.batch_from_numpy([PT.parse_type(s) for s in SIGS], arrays,
                             nulls=nulls, capacity=n + 8, device="cpu")
    return rb, pb


def _same_block(ref, port):
    assert type(port).__name__ == type(ref).__name__
    rv, rn = RB.to_numpy(ref)
    pv, pn = PB.to_numpy(port)
    np.testing.assert_array_equal(rn, pn)
    live = ~rn
    want = [v for v, keep in zip(rv, live) if keep]
    got = [v for v, keep in zip(pv, live) if keep]
    if rv.dtype != object:  # bit for bit: -0.0 stays -0.0
        assert np.array_equal(np.asarray(got, rv.dtype).view(np.uint8),
                              np.asarray(want, rv.dtype).view(np.uint8))
    assert got == want


def _ref(i):
    return input_ref(i, RT.parse_type(SIGS[i]))


def _check(expr, seed=0):
    rb, pb = _batches(seed)
    ref = RC.evaluate(expr, rb)
    port = PC.evaluate(PIR.from_json(RIR.to_json(expr)), pb)
    _same_block(ref, port)
    return ref, port


@pytest.mark.parametrize("name", ["negate", "abs"])
@pytest.mark.parametrize("channel", [LONG, BIG, DBL, SHORT],
                         ids=["decimal38", "bigint", "double", "decimal12"])
def test_negate_and_abs_match_reference(name, channel):
    ty = RT.parse_type(SIGS[channel])
    _check(call(name, ty, _ref(channel)))


def test_negate_of_a_constant():
    _check(call("negate", RT.BIGINT, const(7, RT.BIGINT)))
    _check(call("abs", RT.decimal(12, 2), const(-250, RT.decimal(12, 2))))


def test_upper_matches_reference():
    ref, port = _check(call("upper", RT.varchar(10), _ref(STR)))
    np.testing.assert_array_equal(port.lengths.numpy(),
                                  np.asarray(ref.lengths))


CONCATS = {
    "column_column": lambda: [_ref(STR), _ref(STR3)],
    "constant_column": lambda: [const("store", RT.varchar(5)), _ref(STR)],
    "column_constant_column": lambda: [_ref(STR3), const("-", RT.varchar(1)),
                                       _ref(STR)],
    "null_constant": lambda: [_ref(STR), const(None, RT.varchar(4))],
    "constants": lambda: [const("ab", RT.varchar(2)),
                          const("", RT.varchar(0))],
}


@pytest.mark.parametrize("case", sorted(CONCATS))
def test_concat_matches_reference(case):
    """NULL arguments make the row NULL, constants broadcast (q5's
    concat('store', s_store_id)); the output is as wide as the widths
    together."""
    args = CONCATS[case]()
    ret = RT.varchar(sum(a.type.parameters[0] for a in args))
    ref, port = _check(call("concat", ret, *args))
    assert port.chars.shape == tuple(np.asarray(ref.chars).shape)
    np.testing.assert_array_equal(port.lengths.numpy(),
                                  np.asarray(ref.lengths))


CASTS = [(LONG, "double"), (BIG, "double"), (SHORT, "double"),
         (DBL, "decimal(12, 2)"), (DBL, "bigint"), (SHORT, "bigint"),
         (BIG, "decimal(38, 2)"), (SHORT, "decimal(38, 4)"),
         (LONG, "decimal(38, 6)"), (BIG, "integer")]


@pytest.mark.parametrize("channel,to", CASTS,
                         ids=[f"{SIGS[c]}-{t}" for c, t in CASTS])
def test_numeric_casts_match_reference(channel, to):
    """The casts TPC-DS reaches (q58, q83: to double) and their
    neighbours."""
    _check(call("cast", RT.parse_type(to), _ref(channel)))


@pytest.mark.parametrize("op", ["lt", "ge", "eq"])
@pytest.mark.parametrize("other", [
    const(12.5, RT.DOUBLE), const(1250, RT.decimal(12, 2)),
    const(12, RT.BIGINT), input_ref(SHORT, RT.decimal(12, 2))],
    ids=["double", "decimal", "bigint", "decimal_column"])
def test_comparisons_with_a_double_match_reference(op, other):
    """TPC-DS q21, q31, q39, q53, q63, q73, q89 compare a double with a
    double, a decimal or a bigint."""
    _check(call(op, RT.BOOLEAN, _ref(DBL), other))


def test_null_like_matches_reference_for_every_kind():
    rb, pb = _batches(seed=3)
    for rc, pc in zip(rb.columns, pb.columns):
        r, p = RB.null_like(rc), PB.null_like(pc)
        assert type(p) is type(pc) and p.type == pc.type and len(p) == len(pc)
        assert p.nulls.all() and bool(np.asarray(r.nulls).all())
        if isinstance(p, PB.StringColumn):
            assert not p.lengths.any()
            assert p.chars.shape == pc.chars.shape
    arr = PB.ArrayColumn(torch.ones(5, 3, dtype=torch.int8),
                         torch.zeros(5, 3, dtype=torch.bool),
                         torch.full((5,), 3, dtype=torch.int32),
                         torch.zeros(5, dtype=torch.bool),
                         PT.parse_type("array(tinyint)"))
    a = PB.null_like(arr)
    assert a.nulls.all() and not a.lengths.any()
    assert a.elements.shape == (5, 3) and a.type == arr.type


def _exact(res):
    types = [PT.parse_type(str(t)) for t in res.types]
    return exact_rows(res.columns, res.nulls, types, res.row_count)


def _both(plan_json, sf=SF):
    want = ref_run_query(RN.from_json(plan_json), sf=sf, prepared=True)
    got = run_query(from_json(plan_json), sf=sf, device="cpu", prepared=True)
    assert got.names == list(want.names)
    assert _exact(got) == _exact(want)
    return got


GROUPING = {
    "rollup": "SELECT returnflag, linestatus, shipmode, sum(quantity), "
              "count(*) FROM lineitem GROUP BY ROLLUP(returnflag, "
              "linestatus, shipmode) ORDER BY 1, 2, 3",
    "cube": "SELECT returnflag, linestatus, sum(extendedprice), "
            "avg(discount) FROM lineitem GROUP BY CUBE(returnflag, "
            "linestatus) ORDER BY 1, 2",
    "grouping_sets": "SELECT linestatus, shipmode, max(tax), count(*) FROM "
                     "lineitem GROUP BY GROUPING SETS ((linestatus), "
                     "(shipmode), (linestatus, shipmode), ()) "
                     "ORDER BY 1, 2",
}


@pytest.mark.parametrize("case", sorted(GROUPING))
def test_grouping_sets_match_reference(case):
    plan = prepare_plan(plan_sql(GROUPING[case]), sf=SF)
    assert '"groupid"' in str(RN.to_json(plan)).replace("'", '"')
    got = _both(RN.to_json(plan))
    assert got.row_count > 4


def _nation_scan():
    cols = ["nationkey", "regionkey", "name"]
    return RN.TableScanNode("tpch", "nation", cols,
                            [rtpch.column_type("nation", c) for c in cols])


def test_bare_groupid_rows_match_reference():
    """Each row once per set, the dropped keys NULL, the set's index
    appended; a set may repeat a key and the empty set keeps none."""
    gid = RN.GroupIdNode(_nation_scan(), [[1, 2], [1], [], [2, 1]])
    assert RN.to_json(gid)["groupingSets"] == [[1, 2], [1], [], [2, 1]]
    out = RN.OutputNode(gid, ["nationkey", "regionkey", "name", "gid"])
    got = _both(RN.to_json(out))
    assert got.row_count == 4 * 25
    assert from_json(RN.to_json(gid)).key_channels == [1, 2]


@pytest.mark.parametrize("cap", [None, 2])
def test_row_number_node_matches_reference(cap):
    rn = RN.RowNumberNode(_nation_scan(), [1], [(0, True, False)], cap)
    out = RN.OutputNode(RN.SortNode(rn, [(1, False, False),
                                         (0, False, False)]),
                        ["nationkey", "regionkey", "name", "rn"])
    got = _both(RN.to_json(out))
    assert got.row_count == (25 if cap is None else 10)


def test_window_json_reads_frames_back_as_tuples():
    """A ROWS/RANGE frame crosses as a JSON list and is read back as
    the tuple the reference builds; to_json writes the same dict."""
    sql = ("SELECT orderkey, linenumber, sum(quantity) OVER (PARTITION BY "
           "orderkey ORDER BY linenumber ROWS BETWEEN 1 PRECEDING AND 1 "
           "FOLLOWING), ntile(3) OVER (ORDER BY orderkey), "
           "rank() OVER (PARTITION BY linenumber ORDER BY orderkey DESC) "
           "FROM lineitem WHERE orderkey <= 40")
    j = RN.to_json(prepare_plan(plan_sql(sql), sf=SF))
    node = from_json(j)
    assert to_json(node) == j
    windows = []
    stack = [node]
    while stack:
        n = stack.pop()
        windows += [n] if type(n).__name__ == "WindowNode" else []
        stack.extend(n.sources)
    frames = [f[3] for w in windows for f in w.functions]
    assert ("rows", -1, 1) in frames
    _both(j)
