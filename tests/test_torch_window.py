"""The port's ops/window.window against presto_tpu's on the same inputs.

Seeded numpy columns are staged by both packages on the CPU: integer
and varchar partition keys (NULLs, a single-row partition, a partition
whose rows are all inactive), bigint and double order keys (ties,
NULLs), and bigint, double, short decimal and decimal(38) inputs with
NULLs, plus inactive and padding rows. Every one of the 16 functions
runs under every frame kind, ascending and descending, nulls first and
last, with and without PARTITION BY. Outputs must be equal: integers,
decimals and ranks exactly, and doubles bit for bit, except the sums
and averages of double inputs (REORDERED), which add in another order
than XLA's cumsum and are held within rel 1e-9.
"""

import numpy as np
import pytest
import torch

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
import jax.numpy as jnp
from presto_tpu import block as RB
from presto_tpu import types as RT
from presto_tpu.ops import window as RW
from presto_tpu.ops.sort import SortKey

from presto_tpu_torch import block as PB
from presto_tpu_torch import types as PT
from presto_tpu_torch.ops import window as PW

SIGS = ["integer", "varchar(9)", "bigint", "bigint", "double",
        "decimal(38, 2)", "decimal(12, 2)", "double"]
PK_INT, PK_STR, OK_INT, V_BIG, V_DBL, V_LONG, V_SHORT, OK_DBL = range(8)
VALUE_TYPES = {V_BIG: "bigint", V_DBL: "double", V_LONG: "decimal(38, 2)",
               V_SHORT: "decimal(12, 2)"}
WORDS = ["", "a", "bb", "abcdefgh", "ZZ"]
# (function, input type) pairs whose double sums add in another order
REORDERED = {("sum", "double"), ("avg", "double")}

PARTITIONS = {"int": [PK_INT], "varchar": [PK_STR],
              "int_varchar": [PK_INT, PK_STR], "none": []}
ORDERS = {"asc": [(OK_INT, False, False)],
          "desc_nulls_last": [(OK_INT, True, True)],
          "two_keys": [(OK_INT, False, True), (V_BIG, True, False)],
          "none": []}
FRAMES = {"range_current": "range_current", "full": "full",
          "rows_around": ("rows", -2, 1), "rows_head": ("rows", None, 0),
          "rows_tail": ("rows", 1, None), "rows_past": ("rows", -3, -1),
          "range_around": ("range", -3, 2), "range_head": ("range", None, 0),
          "range_tail": ("range", 1, None)}


def _inputs(seed, n=90, capacity=104):
    rng = np.random.default_rng(seed)
    pk = rng.integers(0, 5, n).astype(np.int32)
    pk[0] = 99   # a partition of one row
    pk[1:4] = 77  # a partition whose rows are all inactive (below)
    pk_n = rng.random(n) < 0.1
    pk_n[:4] = False
    words = np.array([WORDS[i] for i in rng.integers(0, len(WORDS), n)],
                     dtype=object)
    words[rng.random(n) < 0.1] = None
    ok = rng.integers(0, 8, n).astype(np.int64)
    big = rng.integers(-50, 50, n).astype(np.int64)
    dbl = rng.normal(0.0, 1e3, n)
    long_ = np.array([(1 << 80) * int(v) + int(w) for v, w in
                      zip(rng.integers(-9, 9, n), rng.integers(0, 1 << 60, n))],
                     dtype=object)
    long_[rng.random(n) < 0.15] = None
    short = rng.integers(-10_000, 10_000, n).astype(np.int64)
    okd = np.round(rng.normal(0.0, 3.0, n), 1)
    arrays = [pk, words, ok, big, dbl, long_, short, okd]
    nulls = [pk_n, None, rng.random(n) < 0.1, rng.random(n) < 0.1,
             rng.random(n) < 0.1, None, rng.random(n) < 0.1,
             rng.random(n) < 0.1]
    nm = [m if m is not None else np.array([v is None for v in a])
          for a, m in zip(arrays, nulls)]
    rb = RB.batch_from_numpy([RT.parse_type(s) for s in SIGS], arrays,
                             nulls=nm, capacity=capacity)
    pb = PB.batch_from_numpy([PT.parse_type(s) for s in SIGS], arrays,
                             nulls=nm, capacity=capacity, device="cpu")
    act = np.asarray(rb.active).copy()
    act[1:4] = False
    act[rng.integers(4, n, 8)] = False
    return rb.with_active(jnp.asarray(act)), pb.with_active(
        torch.from_numpy(act))


def _specs(mod, items):
    """WindowSpecs of one package from (name, channel, type, frame,
    ntile buckets, offset) tuples."""
    parse = RT.parse_type if mod is RW else PT.parse_type
    return [mod.WindowSpec(name, ch, parse(ty), frame, ntile_buckets=k,
                           offset=off)
            for name, ch, ty, frame, k, off in items]


def _run(items, partition, order, seed=0):
    rb, pb = _inputs(seed)
    r = RW.window(rb, partition, [SortKey(*k) for k in order],
                  _specs(RW, items))
    p = PW.window(pb, partition, order, _specs(PW, items))
    ncols = rb.num_columns
    assert p.num_columns == r.num_columns == ncols + len(items)
    for j, item in enumerate(items):
        rv, rn = RB.to_numpy(r.column(ncols + j))
        pv, pn = PB.to_numpy(p.column(ncols + j))
        assert p.column(ncols + j).type == PT.parse_type(item[2])
        assert np.array_equal(rn, pn), item
        assert pn[~pb.active.numpy()].all(), item  # padding rows are NULL
        live = ~rn
        if item[2] == "double" and (item[0], VALUE_TYPES.get(item[1])) \
                in REORDERED:
            np.testing.assert_allclose(pv[live].astype(np.float64),
                                       rv[live].astype(np.float64),
                                       rtol=1e-9, atol=0, err_msg=str(item))
        elif rv.dtype == object or pv.dtype == object:
            assert list(pv[live]) == list(rv[live]), item
        else:
            assert np.array_equal(
                pv[live].astype(rv.dtype).view(np.uint8),
                rv[live].view(np.uint8)), item  # bit for bit


@pytest.mark.parametrize("order", sorted(ORDERS))
@pytest.mark.parametrize("partition", sorted(PARTITIONS))
def test_ranking_functions_match_reference(partition, order):
    items = [("row_number", None, "bigint", "range_current", 0, 1),
             ("rank", None, "bigint", "range_current", 0, 1),
             ("dense_rank", None, "bigint", "range_current", 0, 1),
             ("percent_rank", None, "double", "range_current", 0, 1),
             ("cume_dist", None, "double", "range_current", 0, 1),
             ("ntile", None, "bigint", "range_current", 3, 1),
             ("ntile", None, "bigint", "range_current", 7, 1)]
    _run(items, PARTITIONS[partition], ORDERS[order])


def _aggregate_items(frame, channels):
    items = [("count", None, "bigint", frame, 0, 1)]
    for ch in channels:
        ty = VALUE_TYPES[ch]
        avg_ty = "double" if ty in ("double", "bigint") else ty
        items += [("sum", ch, ty, frame, 0, 1),
                  ("count", ch, "bigint", frame, 0, 1),
                  ("avg", ch, avg_ty, frame, 0, 1),
                  ("first_value", ch, ty, frame, 0, 1),
                  ("last_value", ch, ty, frame, 0, 1),
                  ("nth_value", ch, ty, frame, 0, 2),
                  ("nth_value", ch, ty, frame, 0, 5)]
        if not (ch == V_LONG and isinstance(frame, tuple)
                and frame[1] is not None):
            items += [("min", ch, ty, frame, 0, 1),
                      ("max", ch, ty, frame, 0, 1)]
    return items


@pytest.mark.parametrize("frame", sorted(FRAMES))
@pytest.mark.parametrize("partition", ["int", "int_varchar", "none"])
def test_frame_aggregates_match_reference(partition, frame):
    """sum/count/avg/min/max/first_value/last_value/nth_value and
    count(*) over every value type; RANGE value frames take the one
    ascending bigint order key, the others two keys."""
    f = FRAMES[frame]
    order = ORDERS["asc"] if frame.startswith("range") else \
        ORDERS["two_keys"]
    _run(_aggregate_items(f, [V_BIG, V_DBL, V_LONG, V_SHORT]),
         PARTITIONS[partition], order)


@pytest.mark.parametrize("nulls_last", [False, True])
@pytest.mark.parametrize("frame", ["range_around", "range_head",
                                   "range_tail"])
def test_range_frames_over_a_double_order_key(frame, nulls_last):
    _run(_aggregate_items(FRAMES[frame], [V_BIG, V_SHORT]),
         PARTITIONS["int"], [(OK_DBL, False, nulls_last)])


@pytest.mark.parametrize("partition", ["varchar", "none"])
def test_lag_and_lead_match_reference(partition):
    items = []
    for ch in (V_BIG, V_DBL, V_SHORT):
        ty = VALUE_TYPES[ch]
        items += [(name, ch, ty, "range_current", 0, off)
                  for name in ("lag", "lead") for off in (1, 2, 5)]
    _run(items, PARTITIONS[partition], ORDERS["two_keys"])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_mixed_specs_over_other_seeds(seed):
    items = [("rank", None, "bigint", "range_current", 0, 1),
             ("sum", V_LONG, "decimal(38, 2)", "range_current", 0, 1),
             ("avg", V_LONG, "decimal(38, 2)", ("rows", -1, 1), 0, 1),
             ("max", V_LONG, "decimal(38, 2)", "full", 0, 1),
             ("min", V_DBL, "double", ("rows", -4, 0), 0, 1),
             ("lag", V_BIG, "bigint", "range_current", 0, 3)]
    _run(items, PARTITIONS["int_varchar"], ORDERS["desc_nulls_last"],
         seed=seed)


REFUSALS = {
    "sum_varchar": ([("sum", PK_STR, "varchar(9)", "full", 0, 1)],
                    ORDERS["asc"], AssertionError,
                    "window sum over strings is not yet supported"),
    "lag_varchar": ([("lag", PK_STR, "varchar(9)", "range_current", 0, 1)],
                    ORDERS["asc"], AssertionError,
                    "lag/lead over strings is not yet supported"),
    "min_long_bounded_start": (
        [("min", V_LONG, "decimal(38, 2)", ("rows", -1, 1), 0, 1)],
        ORDERS["asc"], NotImplementedError,
        "bounded-start ROWS min/max over long decimals"),
    "range_two_keys": ([("sum", V_BIG, "bigint", ("range", -1, 1), 0, 1)],
                       ORDERS["two_keys"], AssertionError,
                       "RANGE value frames require exactly one ORDER BY key"),
    "range_desc": ([("sum", V_BIG, "bigint", ("range", -1, 1), 0, 1)],
                   ORDERS["desc_nulls_last"], AssertionError,
                   "RANGE value frames over DESC order keys"),
    "range_long_key": ([("sum", V_BIG, "bigint", ("range", -1, 1), 0, 1)],
                       [(V_LONG, False, False)], AssertionError,
                       "RANGE value frame over unsupported order-key column"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_match_reference(case):
    """What the reference refuses, the port refuses, with its message."""
    items, order, exc, msg = REFUSALS[case]
    rb, pb = _inputs(0)
    with pytest.raises(exc, match=msg):
        RW.window(rb, [PK_INT], [SortKey(*k) for k in order],
                  _specs(RW, items))
    with pytest.raises(exc, match=msg):
        PW.window(pb, [PK_INT], order, _specs(PW, items))


def test_spec_assertions():
    for kw, msg in (({"name": "ntile"}, "ntile requires a positive bucket"),
                    ({"name": "nth_value", "offset": 0},
                     "nth_value's n must be at least 1")):
        with pytest.raises(AssertionError, match=msg):
            PW.WindowSpec(**kw)
