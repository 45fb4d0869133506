"""The port's columnar staging and TPC-H generator against presto_tpu's.

Same numpy inputs through presto_tpu.block and presto_tpu_torch.block;
every value, null and dtype must match exactly.
"""

import numpy as np
import pytest

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
from presto_tpu import block as RB
from presto_tpu import types as RT
from presto_tpu.connectors import tpch as rtpch
from presto_tpu.queries.tpch_queries import Q1_COLUMNS, Q6_COLUMNS

from presto_tpu_torch import block as PB
from presto_tpu_torch import types as PT
from presto_tpu_torch.connectors import tpch as ptpch


def _cases():
    big = [(1 << 100) + 7, -(1 << 100) - 3, 0, None, (1 << 63), -(1 << 63) - 1]
    return [
        ("bigint", np.array([1, -(1 << 63), (1 << 63) - 1, 0, 5, 9],
                            np.int64),
         np.array([0, 0, 0, 1, 0, 0], bool), None),
        ("integer", np.array([3, -(1 << 31), (1 << 31) - 1, 0, 1, 2],
                             np.int32), None, None),
        ("date", np.array([10471, 8036, 0, -1, 20000, 1], np.int32),
         None, "int16"),
        ("decimal(12, 2)", np.array([12345, -1, 0, 5000, 100, 999999],
                                    np.int64), None, "int32"),
        ("decimal(38, 2)", np.array(big, dtype=object), None, None),
        ("varchar", np.array(["a", None, "xyz", "", "héllo", "A"],
                             dtype=object), None, None),
        ("char(1)", np.array(["A", "N", "R", "A", "N", "F"], dtype=object),
         None, None),
        ("varchar(8)", np.array(["ab", None, "", "xyz  ", None, "A"],
                                dtype=object), None, None),
        ("boolean", np.array([True, False, True, True, False, False]),
         None, None),
        ("double", np.array([0.5, -1.25, 1e300, -0.0, 3.0, 7.0]), None,
         None),
    ]


def _config2_cases():
    """Config 2's string widths (part.type, customer.mktsegment) and its
    int8/int16 lanes (orders.shippriority, orders.orderdate)."""
    return [
        ("varchar(25)", np.array(["PROMO BRUSHED TIN", None,
                                  "STANDARD POLISHED COPPER", "", "a" * 25,
                                  "ECONOMY ANODIZED STEEL"], dtype=object),
         None, None),
        ("varchar(10)", np.array(["BUILDING", "AUTOMOBILE", None,
                                  "MACHINERY", "", "HOUSEHOLD"],
                                 dtype=object), None, None),
        ("integer", np.array([0, 0, 127, -128, 1, 0], np.int32), None,
         "int8"),
        ("date", np.array([8035, 10440, 9204, 8036, 9404, 9374], np.int32),
         np.array([0, 0, 1, 0, 0, 0], bool), "int16"),
    ]


def _same(ref, port):
    (rv, rn), (pv, pn) = ref, port
    assert rv.dtype == pv.dtype, (rv.dtype, pv.dtype)
    assert np.array_equal(rn, pn)
    assert rv.shape == pv.shape
    assert all(a == b or (a != a and b != b) for a, b in zip(rv, pv))


@pytest.mark.parametrize("case", _cases(), ids=lambda c: c[0])
def test_round_trip_matches_reference(case):
    _round_trip(case)


@pytest.mark.parametrize("case", _config2_cases(),
                         ids=["part.type", "customer.mktsegment",
                              "orders.shippriority", "orders.orderdate"])
def test_config2_columns_round_trip(case):
    _round_trip(case)


def _round_trip(case):
    sig, values, nulls, phys = case
    rty, pty = RT.parse_type(sig), PT.parse_type(sig)
    n = [nulls] if nulls is not None else None
    ref = RB.batch_from_numpy([rty], [values], nulls=n, capacity=8,
                              physical_dtypes=[phys])
    port = PB.batch_from_numpy([pty], [values], nulls=n, capacity=8,
                               physical_dtypes=[phys], device="cpu")
    assert np.array_equal(np.asarray(ref.active), port.active.numpy())
    _same(RB.to_numpy(ref.columns[0]), PB.to_numpy(port.columns[0]))


@pytest.mark.parametrize("phys,edges", [
    ("int16", [(1 << 15) - 1, -(1 << 15), 0, 1]),
    ("int32", [(1 << 31) - 1, -(1 << 31), (1 << 15), -(1 << 15) - 1]),
    ("int8", [127, -128, 0, -1]),
])
def test_narrow_lanes_hold_their_edges(phys, edges):
    vals = np.array(edges, np.int64)
    ref = RB.from_numpy(RT.BIGINT, vals, physical_dtype=phys)
    port = PB.from_numpy(PT.BIGINT, vals, physical_dtype=phys, device="cpu")
    assert str(port.values.dtype) == f"torch.{phys}"
    _same(RB.to_numpy(ref), PB.to_numpy(port))
    assert PB.to_numpy(port)[0].tolist() == edges


def test_int128_lanes_round_trip_through_reference_staging():
    """A long decimal fetched from the reference (Python ints) stages in
    the port with the same hi/lo bits."""
    vals = np.array([(1 << 64) - 1, -(1 << 64), 1, -1, (1 << 126)],
                    dtype=object)
    ref = RB.from_numpy(RT.decimal(38, 0), vals)
    rv, _ = RB.to_numpy(ref)
    port = PB.from_numpy(PT.decimal(38, 0), rv, device="cpu")
    assert np.array_equal(np.asarray(ref.hi), port.hi.numpy())
    assert np.array_equal(np.asarray(ref.lo).view(np.int64),
                          port.lo.numpy())


def test_gather_block_masks_invalid_rows():
    vals = np.array(["ab", "c", "def"], dtype=object)
    col = PB.from_numpy(PT.varchar(), vals, device="cpu")
    import torch
    out = PB.gather_block(col, torch.tensor([2, 0, 1]),
                          torch.tensor([True, False, True]))
    v, n = PB.to_numpy(out)
    assert list(n) == [False, True, False]
    assert list(v) == ["def", "", "c"]


@pytest.mark.parametrize("columns", [Q1_COLUMNS, Q6_COLUMNS,
                                     [c for c, _ in
                                      rtpch.TPCH_SCHEMA["lineitem"]]],
                         ids=["q1", "q6", "all"])
def test_generator_equals_reference(columns):
    ref = rtpch.generate_columns("lineitem", 0.01, columns)
    port = ptpch.generate_columns("lineitem", 0.01, columns)
    for c in columns:
        assert ref[c].dtype == port[c].dtype, c
        assert np.array_equal(ref[c], port[c]), c
        assert str(rtpch.column_type("lineitem", c)) == \
            str(ptpch.column_type("lineitem", c))


@pytest.mark.parametrize("table", ["orders", "customer", "part"])
def test_config2_tables_equal_reference(table):
    """The tables q3 and q14 add: every column equal to the reference's,
    element for element and dtype for dtype, a split included, and the
    value ranges that narrow their lanes."""
    from presto_tpu.connectors.tpch import column_range as rrange
    columns = [c for c, _ in rtpch.TPCH_SCHEMA[table]]
    for start, count in ((0, None), (123, 456)):
        ref = rtpch.generate_columns(table, 0.01, columns, start, count)
        port = ptpch.generate_columns(table, 0.01, columns, start, count)
        for c in columns:
            assert ref[c].dtype == port[c].dtype, c
            assert np.array_equal(ref[c], port[c]), c
    for c in columns:
        assert str(rtpch.column_type(table, c)) == \
            str(ptpch.column_type(table, c))
        for sf in (0.01, 10):
            assert rrange(table, c, sf) == ptpch.column_range(table, c, sf)


@pytest.mark.parametrize("table", ["supplier", "partsupp", "nation",
                                   "region"])
@pytest.mark.parametrize("sf", [0.01, 0.05, 1.0])
def test_other_four_tables_equal_reference(table, sf):
    """supplier, partsupp, nation and region: every column equal to the
    reference's, element for element and dtype for dtype, on a window
    of rows at each sf (partsupp's suppkey spreads over
    table_row_count('supplier', sf), so it differs by sf) and whole at
    sf 0.01; the schema, and the value ranges that narrow their
    lanes."""
    from presto_tpu.connectors.tpch import column_range as rrange
    columns = [c for c, _ in rtpch.TPCH_SCHEMA[table]]
    total = rtpch.table_row_count(table, sf)
    assert ptpch.table_row_count(table, sf) == total
    windows = [(0, None)] if sf == 0.01 else []
    windows.append((total // 3, min(2000, total - total // 3)))
    for start, count in windows:
        ref = rtpch.generate_columns(table, sf, columns, start, count)
        port = ptpch.generate_columns(table, sf, columns, start, count)
        for c in columns:
            assert ref[c].dtype == port[c].dtype, c
            assert np.array_equal(ref[c], port[c]), c
    for c in columns:
        assert str(rtpch.column_type(table, c)) == \
            str(ptpch.column_type(table, c))
        assert rrange(table, c, sf) == ptpch.column_range(table, c, sf)


def test_generator_split_and_stats_match_reference():
    from presto_tpu.connectors.tpch import column_range as rrange
    ref = rtpch.generate_columns("lineitem", 0.01, Q1_COLUMNS, start=1000,
                                 count=777)
    port = ptpch.generate_columns("lineitem", 0.01, Q1_COLUMNS, start=1000,
                                  count=777)
    for c in Q1_COLUMNS:
        assert np.array_equal(ref[c], port[c])
    for c, _ in rtpch.TPCH_SCHEMA["lineitem"]:
        assert rrange("lineitem", c, 0.01) == \
            ptpch.column_range("lineitem", c, 0.01), c
    # every table of the schema generates; a name outside it is refused
    # as the reference refuses it
    with pytest.raises(KeyError):
        rtpch.generate_columns("suppliers", 0.01, ["suppkey"])
    with pytest.raises(KeyError):
        ptpch.generate_columns("suppliers", 0.01, ["suppkey"])


@pytest.mark.parametrize("stage", ["from_numpy", "batch_from_numpy"])
def test_staging_defaults_to_cuda_and_never_falls_back(monkeypatch, stage):
    """With no `device`, staging targets CUDA; without a card it raises
    instead of leaving the columns on the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vals = np.array([1, 2, 3], np.int64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if stage == "from_numpy":
            PB.from_numpy(PT.BIGINT, vals)
        else:
            PB.batch_from_numpy([PT.BIGINT], [vals])
