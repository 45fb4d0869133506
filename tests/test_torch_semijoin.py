"""The port's semi join against presto_tpu's: `semi_join_mask`'s
three-valued (match, null_flag) pair, the SemiJoinNode's JSON, and its
lowering in a plan.

The same keys, made from a seed with numpy, are staged by both
packages: NULL probe keys, a NULL in the build side (NOT IN
semantics), null_keys_match, an empty build, inactive rows on both
sides, multi-column keys and string keys of two widths. Both masks
must be equal exactly.
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
from presto_tpu.ops import join as RJ
from presto_tpu.plan import nodes as RN

from presto_tpu_torch import block as PB
from presto_tpu_torch import types as PT
from presto_tpu_torch.exec import run_query
from presto_tpu_torch.ops import join as PJ
from presto_tpu_torch.plan import from_json, to_json

WORDS = ["", "a", "ab", "abcdefgh", "abcdefghi", "zz", "BUILDING"]


def _side(rng, n, sigs, null_rate, inactive, widths=None):
    arrays, nulls = [], []
    for sig in sigs:
        if sig.startswith("varchar"):
            a = np.array([WORDS[i] for i in rng.integers(0, len(WORDS), n)],
                         dtype=object)
        else:
            a = rng.integers(-6, 7, n).astype(np.int64)
            a[rng.random(n) < 0.05] = np.iinfo(np.int64).max
            a[rng.random(n) < 0.05] = np.iinfo(np.int64).min
        m = rng.random(n) < null_rate
        if a.dtype == object:
            a[m] = None
        arrays.append(a)
        nulls.append(m)
    cap = n + 8
    rb = RB.batch_from_numpy([RT.parse_type(s) for s in sigs], arrays,
                             nulls=nulls, capacity=cap)
    pb = PB.batch_from_numpy([PT.parse_type(s) for s in sigs], arrays,
                             nulls=nulls, capacity=cap, device="cpu")
    if widths:
        rc, pc = list(rb.columns), list(pb.columns)
        for i, w in widths.items():
            rc[i] = RJ._pad_chars(rc[i], w)
            pc[i] = PB.pad_chars(pc[i], w)
        rb, pb = RB.Batch(tuple(rc), rb.active), PB.Batch(tuple(pc),
                                                          pb.active)
    act = np.asarray(rb.active).copy()
    act[rng.random(cap) < inactive] = False
    return (rb.with_active(jnp.asarray(act)),
            pb.with_active(torch.from_numpy(act)))


CASES = {
    # name: (key sigs, probe null rate, build null rate, build inactive)
    "bigint": (["bigint"], 0.0, 0.0, 0.1),
    "null_probe_keys": (["bigint"], 0.2, 0.0, 0.1),
    "null_in_build": (["bigint"], 0.2, 0.1, 0.1),
    "empty_build": (["bigint"], 0.2, 0.1, 1.0),
    "two_columns": (["bigint", "varchar(9)"], 0.1, 0.05, 0.2),
    "strings": (["varchar(9)"], 0.1, 0.1, 0.2),
}


@pytest.mark.parametrize("null_keys_match", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_semi_join_mask_matches_reference(case, null_keys_match):
    sigs, pnull, bnull, binact = CASES[case]
    rng = np.random.default_rng(len(case))
    rp, pp = _side(rng, 300, sigs, pnull, 0.1)
    rb, pb = _side(rng, 40, sigs, bnull, binact)
    keys = list(range(len(sigs)))
    rm, rn = RJ.semi_join_mask(rp, rb, keys, keys, null_keys_match)
    pm, pn = PJ.semi_join_mask(pp, pb, keys, keys, null_keys_match)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(rm))
    np.testing.assert_array_equal(pn.numpy(), np.asarray(rn))
    if null_keys_match:
        assert not pn.any()
    if case == "null_in_build" and not null_keys_match:
        # a NULL on the build side makes every unmatched live row NULL
        live = pp.active.numpy()
        assert (pn.numpy()[live] == ~pm.numpy()[live]).all()
    if case == "empty_build":
        assert not pm.any()


def test_string_keys_of_two_widths():
    """A varchar(9) probe against a build padded to 24 bytes."""
    rng = np.random.default_rng(5)
    rp, pp = _side(rng, 200, ["varchar(9)"], 0.1, 0.0)
    rb, pb = _side(rng, 30, ["varchar(9)"], 0.0, 0.0, widths={0: 24})
    rm, rn = RJ.semi_join_mask(rp, rb, [0], [0])
    pm, pn = PJ.semi_join_mask(pp, pb, [0], [0])
    np.testing.assert_array_equal(pm.numpy(), np.asarray(rm))
    np.testing.assert_array_equal(pn.numpy(), np.asarray(rn))
    assert pm.any()


def _orders_plan(negate):
    """orders whose orderkey is (NOT) IN the lineitems of quantity < 3,
    counted: the SemiJoinNode, `not` on its column, a filter."""
    def scan(table, cols):
        return RN.TableScanNode("tpch", table, cols,
                                [rtpch.column_type(table, c) for c in cols])
    d2 = RT.decimal(12, 2)
    line = RN.FilterNode(scan("lineitem", ["orderkey", "quantity"]),
                         call("lt", RT.BOOLEAN, input_ref(1, d2),
                              const(300, d2)))
    semi = RN.SemiJoinNode(scan("orders", ["orderkey", "totalprice"]),
                           RN.ProjectNode(line, [input_ref(0, RT.BIGINT)]),
                           0, 0, negate=negate)
    flag = input_ref(2, RT.BOOLEAN)
    pred = call("not", RT.BOOLEAN, flag) if negate else flag
    from presto_tpu.ops.aggregation import AggSpec
    agg = RN.AggregationNode(RN.FilterNode(semi, pred), [],
                             [AggSpec("count_star", None, RT.BIGINT),
                              AggSpec("max", 1, RT.decimal(15, 2))])
    return RN.OutputNode(agg, ["n", "top"])


@pytest.mark.parametrize("negate", [False, True])
def test_semi_join_plan_matches_reference(negate):
    plan = _orders_plan(negate)
    j = RN.to_json(plan)
    port_plan = from_json(j)
    assert to_json(port_plan) == j
    want = ref_run_query(plan, sf=0.01)
    got = run_query(port_plan, sf=0.01, device="cpu")
    assert got.rows() == want.rows()
    assert 0 < got.rows()[0][0] < rtpch.table_row_count("orders", 0.01)
