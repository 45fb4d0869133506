"""The port's nested and dictionary blocks against presto_tpu's.

Arrays, maps and rows staged by both packages from the same seeded
object arrays (tests/_torch_nested_common.py) hold the same lanes,
fetch to the same lists, dicts and tuples, and gather, concatenate and
null out alike; a DictionaryColumn decodes, gathers its indices, and
reaches the operators that read values (keys of a group-by, a sort
and a join) decoded. The reference's own block cases
(tests/test_arrays_unnest.py::test_array_roundtrip,
tests/test_map_row.py's map, row and gather cases and
tests/test_block.py::test_dictionary_decode) run on the port with their
expected values. Nested results reach the corpus in the exact form of
`presto_tpu_torch.queries.exact_value`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from presto_tpu import block as RB
from presto_tpu.ops import aggregation as RA
from presto_tpu.ops import join as RJ
from presto_tpu.ops import sort as RS

from presto_tpu_torch import block as PB
from presto_tpu_torch import types as PT
from presto_tpu_torch.ops import aggregation as PA
from presto_tpu_torch.ops import join as PJ
from presto_tpu_torch.ops import sort as PS
from presto_tpu_torch.queries import exact_value

from _torch_nested_common import (CH, COLUMNS, KS, N, assert_same_block,
                                  batches, canon, ty)

NESTED = ["arr", "darr", "iarr", "map", "dmap", "row"]
LANES = {"ArrayColumn": ("elements", "elem_nulls", "lengths", "nulls"),
         "MapColumn": ("keys", "values", "value_nulls", "lengths", "nulls")}


def _lanes_equal(r, p):
    """Every lane of a staged block, and its dtype, equal."""
    assert type(p).__name__ == type(r).__name__
    if isinstance(p, PB.RowColumn):
        np.testing.assert_array_equal(p.nulls.numpy(), np.asarray(r.nulls))
        for rf, pf in zip(r.fields, p.fields):
            _lanes_equal(rf, pf)
        return
    names = LANES.get(type(p).__name__)
    if names is None:
        return assert_same_block(r, p)
    for f in names:
        want, got = np.asarray(getattr(r, f)), getattr(p, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", NESTED)
def test_staged_lanes_equal_the_reference(name, k):
    rb, pb = batches(4, k)
    _lanes_equal(rb.column(CH[name]), pb.column(CH[name]))
    assert_same_block(rb.column(CH[name]), pb.column(CH[name]))


@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("name", NESTED)
def test_gather_equals_the_reference(name, valid):
    rb, pb = batches(4, 5)
    idx = np.random.default_rng(7).integers(0, N + 8, 40)
    ok = np.random.default_rng(8).random(40) < 0.7
    r = RB.gather_block(rb.column(CH[name]), jnp.asarray(idx),
                        jnp.asarray(ok) if valid else None)
    p = PB.gather_block(pb.column(CH[name]), torch.from_numpy(idx),
                        torch.from_numpy(ok) if valid else None)
    _lanes_equal(r, p)


def _two_batches(k1, k2):
    """Two batches of every column, the second with other fanouts."""
    (r1, p1), (r2, p2) = batches(4, k1), batches(4, k2)
    return (r1, r2), (p1, p2)


def test_concat_equals_the_reference():
    """Arrays and maps of fanout 2 and 8 pad to 8; rows concatenate
    field by field."""
    (r1, r2), (p1, p2) = _two_batches(2, 8)
    r, p = RB.concat_batches([r1, r2]), PB.concat_batches([p1, p2])
    np.testing.assert_array_equal(p.active.numpy(), np.asarray(r.active))
    for c in range(len(COLUMNS)):
        assert_same_block(r.column(c), p.column(c))
        pc = p.column(c)
        if isinstance(pc, (PB.ArrayColumn, PB.MapColumn)):
            assert pc.max_cardinality == 8


@pytest.mark.parametrize("name", NESTED + ["x"])
def test_null_like_is_all_null_and_empty(name):
    """Every row NULL, and arrays and maps empty: for an array the
    reference's lanes exactly (its null_like has no map or row
    case)."""
    rb, pb = batches(4, 3)
    p = PB.null_like(pb.column(CH[name]))
    assert bool(p.nulls.all()) and type(p) is type(pb.column(CH[name]))
    if hasattr(p, "lengths"):
        assert not bool(p.lengths.any())
    if isinstance(p, PB.RowColumn):
        assert all(bool(f.nulls.all()) for f in p.fields)
    if name in ("arr", "darr", "iarr", "x"):
        _lanes_equal(RB.null_like(rb.column(CH[name])), p)


def test_reference_block_cases_on_the_port():
    """tests/test_arrays_unnest.py::test_array_roundtrip and
    tests/test_map_row.py's test_map_block_roundtrip,
    test_row_block_roundtrip and test_gather_map_and_row, on the
    port."""
    col = PB.from_numpy(ty("array(bigint)"), np.array(
        [[1, 2, 3], [], None, [7, None]], dtype=object), device="cpu")
    v, n = PB.to_numpy(col)
    assert v[0] == [1, 2, 3] and v[1] == [] and v[2] is None
    assert v[3] == [7, None]
    assert list(n) == [False, False, True, False]
    map_t, row_t = ty("map(bigint,bigint)"), ty("row(bigint,varchar(4))")
    m = PB.from_numpy(map_t, np.array([{1: 10, 2: None}, {}, None, {5: 50}],
                                      dtype=object), device="cpu")
    assert isinstance(m, PB.MapColumn)
    v, n = PB.to_numpy(m)
    assert v[0] == {1: 10, 2: None} and v[1] == {} and v[2] is None
    assert v[3] == {5: 50}
    assert list(n) == [False, False, True, False]
    r = PB.from_numpy(row_t, np.array([(1, "a"), None, (3, None)],
                                      dtype=object), device="cpu")
    assert isinstance(r, PB.RowColumn)
    v, _ = PB.to_numpy(r)
    assert v[0] == (1, "a") and v[1] is None and v[2] == (3, None)
    m = PB.from_numpy(map_t, np.array([{1: 10}, {2: 20}, {3: 30}],
                                      dtype=object), device="cpu")
    r = PB.from_numpy(row_t, np.array([(1, "a"), (2, "b"), (3, "c")],
                                      dtype=object), device="cpu")
    idx = torch.tensor([2, 0])
    mv, _ = PB.to_numpy(PB.gather_block(m, idx))
    rv, _ = PB.to_numpy(PB.gather_block(r, idx))
    assert mv[0] == {3: 30} and mv[1] == {1: 10}
    assert rv[0] == (3, "c") and rv[1] == (1, "a")


def _dictionaries(n=64, seed=5):
    """The same dictionary column in both packages: a varchar
    dictionary of 6 words, seeded indices, a tenth of the rows NULL."""
    rng = np.random.default_rng(seed)
    words = np.array(["A", "BB", "", "zz", "héllo", "mid"], dtype=object)
    idx = rng.integers(0, len(words), n).astype(np.int32)
    nulls = rng.random(n) < 0.1
    vty = ty("varchar(8)")
    r = RB.DictionaryColumn(jnp.asarray(idx), RB.from_numpy(vty, words),
                            jnp.asarray(nulls), vty)
    p = PB.DictionaryColumn(torch.from_numpy(idx),
                            PB.from_numpy(PT.parse_type("varchar(8)"), words,
                                          device="cpu"),
                            torch.from_numpy(nulls),
                            PT.parse_type("varchar(8)"))
    return r, p


def test_dictionary_decode():
    """tests/test_block.py::test_dictionary_decode on the port, and a
    seeded dictionary decoded, fetched and gathered as the
    reference's."""
    vty = PT.parse_type("varchar(5)")
    d = PB.from_numpy(vty, np.array(["A", "B", "C"], dtype=object),
                      device="cpu")
    dc = PB.DictionaryColumn(torch.tensor([2, 0, 1, 1]), d,
                             torch.zeros(4, dtype=torch.bool), vty)
    v, _ = PB.to_numpy(dc)
    assert list(v) == ["C", "A", "B", "B"]
    r, p = _dictionaries()
    assert_same_block(r, p)
    assert_same_block(r.decode(), p.decode())
    idx = np.arange(63, -1, -3)
    g = PB.gather_block(p, torch.from_numpy(idx))
    assert isinstance(g, PB.DictionaryColumn)
    assert_same_block(RB.gather_block(r, jnp.asarray(idx)), g)
    ok = idx % 2 == 0
    g = PB.gather_block(p, torch.from_numpy(idx), torch.from_numpy(ok))
    assert isinstance(g, PB.StringColumn)
    assert_same_block(RB.gather_block(r, jnp.asarray(idx), jnp.asarray(ok)),
                      g)


def test_dictionary_reaches_the_operators_decoded():
    """A group-by keyed on the dictionary (count and min of a value),
    a sort by it, and a join on it equal the reference's."""
    r, p = _dictionaries()
    n = len(p)
    vals = np.random.default_rng(6).integers(-50, 50, n)
    rv = RB.from_numpy(ty("bigint"), vals)
    pv = PB.from_numpy(PT.parse_type("bigint"), vals, device="cpu")
    act = np.ones(n, dtype=bool)
    act[-5:] = False
    rb = RB.Batch((r, rv), jnp.asarray(act))
    pb = PB.Batch((p, pv), torch.from_numpy(act))
    aggs_r = [RA.AggSpec("count_star", None, ty("bigint")),
              RA.AggSpec("min", 1, ty("bigint"))]
    aggs_p = [PA.AggSpec("count_star", None, PT.parse_type("bigint")),
              PA.AggSpec("min", 1, PT.parse_type("bigint"))]
    rg = RA.group_by(rb, [0], aggs_r, 16)
    pg = PA.group_by(pb, [0], aggs_p, 16)
    rt, pt = RA.finalize_states(rg.batch, 1, aggs_r), \
        PA.finalize_states(pg.batch, 1, aggs_p)
    want = sorted(_rows(rt, RB), key=repr)
    assert sorted(_rows(pt, PB), key=repr) == want and len(want) == 7
    keys = [(0, False, False), (1, True, False)]
    assert _rows(PS.sort_batch(pb, keys), PB) == \
        _rows(RS.sort_batch(rb, [RS.SortKey(*k) for k in keys]), RB)
    rj = RJ.hash_join(rb, rb, [0], [0], 4096)
    pj = PJ.hash_join(pb, pb, [0], [0], 4096)
    assert sorted(_rows(pj.batch, PB), key=repr) == \
        sorted(_rows(rj.batch, RB), key=repr)


def _rows(batch, mod):
    act = np.asarray(batch.active.cpu() if hasattr(batch.active, "cpu")
                     else batch.active)
    cols = [mod.to_numpy(c) for c in batch.columns]
    return [tuple(None if nl[i] else canon(v[i]) for v, nl in cols)
            for i in np.flatnonzero(act)]


def test_exact_value_of_nested_results():
    """Arrays as lists, maps as [key, value] pairs in entry order,
    rows as lists, each value exact."""
    t = PT.parse_type("map(bigint,array(double))")
    assert exact_value({3: [0.5, None], 1: None}, t) == \
        [[3, [(0.5).hex(), None]], [1, None]]
    t = PT.parse_type("row(bigint,varchar,boolean)")
    assert exact_value((7, "a", True), t) == [7, "a", True]
    assert exact_value(None, PT.parse_type("array(bigint)")) is None
    assert exact_value([], PT.parse_type("array(bigint)")) == []
