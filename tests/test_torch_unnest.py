"""The port's ops/unnest.py and UnnestNode against presto_tpu's.

The operator runs over the same seeded arrays and maps in both
packages (tests/_torch_nested_common.py), with and without ordinality,
at an output capacity that fits and at one that overflows; every
output column, the active mask and the overflow flag must be equal.
The reference's own cases (tests/test_arrays_unnest.py's unnest and
plan-node cases, tests/test_map_row.py::test_unnest_map) run on the
port with their expected values. Plans with an UnnestNode, written by
the reference's JSON, return the reference's rows through run_query,
also when the unnest's capacity overflows and the ladder reruns it.
"""

import numpy as np
import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.exec import run_query as ref_run_query
from presto_tpu.exec.runner import prepare_plan
from presto_tpu.ops.aggregation import AggSpec
from presto_tpu.ops.unnest import unnest as ref_unnest
from presto_tpu.plan import nodes as RN
from presto_tpu.sql import plan_sql

from presto_tpu_torch.exec import run_query
from presto_tpu_torch.ops.unnest import unnest
from presto_tpu_torch.plan import UnnestNode, from_json, to_json

from _torch_nested_common import (CH, KS, N, PB, assert_same_block,
                                  batches, ty)

SF = 0.01


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Several test files share the machine's cores under xdist."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _both(channel, capacity, ordinality, k):
    rb, pb = batches(3, k)
    rout, rovf = ref_unnest(rb, channel, capacity, ordinality)
    pout, povf = unnest(pb, channel, capacity, ordinality)
    assert bool(povf) == bool(np.asarray(rovf))
    np.testing.assert_array_equal(pout.active.numpy(),
                                  np.asarray(rout.active))
    assert pout.num_columns == rout.num_columns
    for c in range(pout.num_columns):
        assert_same_block(rout.column(c), pout.column(c))
    return pout, povf


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", ["arr", "darr", "map", "dmap"])
@pytest.mark.parametrize("ordinality", [False, True])
def test_unnest_equals_the_reference(name, ordinality, k):
    _, ovf = _both(CH[name], 4 * (N + 8), ordinality, k)
    assert not bool(ovf)


@pytest.mark.parametrize("name", ["arr", "map"])
def test_unnest_overflow_equals_the_reference(name):
    _, ovf = _both(CH[name], 16, True, 5)
    assert bool(ovf)


def _port_batch(arrays, ty_sig):
    col = PB.from_numpy(ty(ty_sig), np.array(arrays, dtype=object),
                        device="cpu")
    ids = PB.from_numpy(ty("bigint"), np.arange(len(arrays), dtype=np.int64),
                        device="cpu")
    return PB.Batch((ids, col), torch.ones(len(arrays), dtype=torch.bool))


def _live(out, *cols):
    act = out.active.numpy()
    vals = [PB.to_numpy(out.column(c)) for c in cols]
    return sorted(tuple(None if n[i] else int(v[i]) for v, n in vals)
                  for i in np.flatnonzero(act))


def test_reference_unnest_cases_on_the_port():
    """tests/test_arrays_unnest.py's test_unnest_expansion and
    test_unnest_with_ordinality_and_overflow, and
    tests/test_map_row.py::test_unnest_map, on the port."""
    b = _port_batch([[10, 20], [], None, [30, 40, 50]], "array(bigint)")
    out, ovf = unnest(b, 1, out_capacity=8)
    assert not bool(ovf)
    assert _live(out, 0, 1) == [(0, 10), (0, 20), (3, 30), (3, 40), (3, 50)]
    b = _port_batch([[10, 20], [30]], "array(bigint)")
    out, ovf = unnest(b, 1, out_capacity=8, with_ordinality=True)
    assert _live(out, 0, 2) == [(0, 1), (0, 2), (1, 1)]
    assert bool(unnest(b, 1, out_capacity=2)[1])
    b = _port_batch([{10: 100, 20: 200}, {30: None}], "map(bigint,bigint)")
    out, ovf = unnest(b, 1, out_capacity=8, with_ordinality=True)
    assert not bool(ovf)
    assert _live(out, 0, 1, 2, 3) == [(0, 10, 100, 1), (0, 20, 200, 2),
                                      (1, 30, None, 1)]


def test_unnest_node_json():
    """tests/test_arrays_unnest.py::test_unnest_plan_node: the
    reference's JSON of an UnnestNode reads as one, and writes back the
    same JSON."""
    v = RN.ValuesNode([RT.BIGINT], [[1]])
    j = RN.to_json(RN.OutputNode(RN.UnnestNode(v, 0, out_capacity=8), ["e"]))
    node = from_json(j).source
    assert isinstance(node, UnnestNode) and node.array_channel == 0
    assert node.out_capacity == 8 and not node.with_ordinality
    assert to_json(from_json(j)) == j


def _unnest_plan(sql, channel, out_capacity=None, keys=None):
    """The reference's prepared plan of `sql` unnested at `channel`
    WITH ORDINALITY; with `keys`, grouped by those output channels
    with sum of the elements and count(*)."""
    plan = prepare_plan(plan_sql(sql), sf=SF)
    src = plan.source
    width = len(src.output_types())
    node = RN.UnnestNode(src, channel, out_capacity=out_capacity,
                         with_ordinality=True)
    names = [f"c{i}" for i in range(width + 1)]
    if keys is not None:
        node = RN.AggregationNode(node, keys, [
            AggSpec("sum", width - 1, RT.BIGINT),
            AggSpec("count_star", None, RT.BIGINT)], max_groups=64)
        node = RN.SortNode(node, [(i, False, False)
                                  for i in range(len(keys))])
        names = [f"c{i}" for i in range(len(keys) + 2)]
    return RN.OutputNode(node, names)


@pytest.mark.parametrize("hi,out_capacity,reruns", [
    (3, None, 0), (3, 8, 1), (8, None, 1)])
def test_unnest_plan_returns_the_reference_rows(hi, out_capacity, reruns):
    """A string column rides along the expanded rows. With
    out_capacity 8 the unnest overflows (15 rows) and the ladder reruns
    it at 32. With none, region's 8 slots give 32, which 40 elements
    overflow, and the port's ladder reruns it at 4x that default; the
    reference's ladder scales no unset unnest capacity and gives up, so
    its rows come from the plan with out_capacity 64."""
    sql = ("SELECT name, regionkey, transform(sequence(1, "
           f"{hi}), x -> x * regionkey) a FROM region")
    plan = _unnest_plan(sql, 2, out_capacity)
    want = ref_run_query(_unnest_plan(sql, 2, out_capacity or
                                      (64 if reruns else None)),
                         sf=SF, prepared=True)
    got = run_query(from_json(RN.to_json(plan)), sf=SF, device="cpu",
                    prepared=True)
    assert want.row_count == 5 * hi
    assert got.rows() == want.rows()
    assert got.stats["capacity_reruns"] == reruns


def test_unnest_under_an_aggregation_returns_the_reference_rows():
    """The fn_unnest shape at sf 0.01: orders' lines unnested by
    ordinality and aggregated by (ordinality)."""
    plan = _unnest_plan("SELECT custkey, filter(sequence(1, 6), "
                        "x -> x <= orderkey % 7) a FROM orders", 1,
                        keys=[2])
    want = ref_run_query(plan, sf=SF, prepared=True)
    got = run_query(from_json(RN.to_json(plan)), sf=SF, device="cpu",
                    prepared=True)
    assert want.row_count == 6
    assert got.rows() == want.rows()
