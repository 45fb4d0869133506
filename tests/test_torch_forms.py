"""The port's special forms (OR, IN, IS_NULL, IF, NULL_IF, COALESCE) and
the scalar functions `not`, `year` and `substr` against presto_tpu's.

The same columns, made from a seed with numpy and holding NULLs in every
position, are staged by both packages; each expression is built once
with the reference's IR, crosses to the port as JSON, and is evaluated
by both on the CPU. NULL masks must be equal, and every value that is
not NULL must be equal exactly.
"""

import numpy as np
import pytest

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
from presto_tpu import block as RB
from presto_tpu import types as RT
from presto_tpu.expr import call, const, input_ref, special
from presto_tpu.expr import compile as RC
from presto_tpu.expr import ir as RIR

from presto_tpu_torch import block as PB
from presto_tpu_torch import types as PT
from presto_tpu_torch.expr import compile as PC
from presto_tpu_torch.expr import ir as PIR

N = 240
I127 = (1 << 127) - 1
WORDS = ["", "a", "ab", "abc", "abcdef", "13-555", "31-100", "PROMO"]

# channel layout of the batch both packages stage
COLUMNS = [
    ("a", "boolean"), ("b", "boolean"), ("c", "boolean"),
    ("x", "bigint"), ("y", "bigint"),
    ("s", "varchar(6)"), ("w", "varchar(12)"),
    ("d2", "decimal(12, 2)"), ("d4", "decimal(15, 4)"),
    ("big", "decimal(38, 2)"), ("big2", "decimal(38, 2)"),
    ("day", "date"), ("ts", "timestamp"),
    ("start", "bigint"), ("len", "bigint"),
]
CH = {name: i for i, (name, _) in enumerate(COLUMNS)}


def _data(seed):
    """One numpy array and one null mask per column; every column has
    NULLs, and the booleans cover all nine (a, b) pairs."""
    rng = np.random.default_rng(seed)
    arrays, nulls = [], []
    for name, sig in COLUMNS:
        if sig == "boolean":
            v = rng.random(N) < 0.5
        elif name in ("x", "y"):
            v = rng.integers(-3, 4, N).astype(np.int64)
        elif sig.startswith("varchar"):
            v = np.array([WORDS[i] for i in rng.integers(0, len(WORDS), N)],
                         dtype=object)
            if name == "w":  # wider than s: the 12-byte values
                v = np.where(rng.random(N) < 0.3, "abcdefghijkl", v)
        elif name == "d2":
            v = rng.integers(-5, 6, N).astype(np.int64) * 100
        elif name == "d4":
            v = rng.integers(-5, 6, N).astype(np.int64) * 10000
        elif name in ("big", "big2"):
            pool = [I127, -I127, I127 - 1, -I127 + 1, 0, 500, -500,
                    1 << 64, -(1 << 64)]
            v = np.array([pool[i] for i in rng.integers(0, len(pool), N)],
                         dtype=object)
        elif name == "day":
            v = rng.integers(-800_000, 800_000, N).astype(np.int32)
            v[:8] = [-1, 0, 1, -719_468, -719_469, 11_016, -25_567, 59]
        elif name == "ts":
            v = rng.integers(-(1 << 52), 1 << 52, N).astype(np.int64)
            v[:4] = [-1, 0, -86_400_000_000, -86_400_000_001]
        elif name == "start":
            v = rng.integers(-9, 10, N).astype(np.int64)
        else:  # len
            v = rng.integers(-2, 9, N).astype(np.int64)
        m = rng.random(N) < 0.15
        m[:9] = False
        if sig == "boolean":
            # rows 0..8: every (a, b) pair of TRUE, FALSE and NULL
            pair = [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2), (2, 0),
                    (2, 1), (2, 2)]
            k = 0 if name == "a" else 1 if name == "b" else None
            if k is not None:
                for i, p in enumerate(pair):
                    v[i] = p[k] == 1
                    m[i] = p[k] == 2
        if v.dtype == object:
            v = v.copy()
            v[m] = None
        arrays.append(v)
        nulls.append(m)
    return arrays, nulls


@pytest.fixture(scope="module")
def staged():
    arrays, nulls = _data(seed=7)
    rt = [RT.parse_type(s) for _, s in COLUMNS]
    pt = [PT.parse_type(s) for _, s in COLUMNS]
    cap = N + 8
    rb = RB.batch_from_numpy(rt, arrays, nulls=nulls, capacity=cap)
    pb = PB.batch_from_numpy(pt, arrays, nulls=nulls, capacity=cap,
                             device="cpu")
    return rb, pb


def _ref(name):
    return input_ref(CH[name], RT.parse_type(dict(COLUMNS)[name]))


def _check(staged, expr):
    rb, pb = staged
    want = RC.evaluate(expr, rb)
    got = PC.evaluate(PIR.from_json(RIR.to_json(expr)), pb)
    rv, rn = RB.to_numpy(want)
    pv, pn = PB.to_numpy(got)
    rn, pn = np.asarray(rn, bool), np.asarray(pn, bool)
    np.testing.assert_array_equal(pn, rn)
    live = ~rn
    assert list(np.asarray(pv, dtype=object)[live]) == \
        list(np.asarray(rv, dtype=object)[live])
    assert str(got.type) == str(want.type)
    return pv, pn


B = RT.BOOLEAN
D2, D4, D38 = RT.decimal(12, 2), RT.decimal(15, 4), RT.decimal(38, 2)

CASES = {
    "or": lambda: special("OR", B, _ref("a"), _ref("b")),
    "or3": lambda: special("OR", B, _ref("a"), _ref("b"), _ref("c")),
    "or_null_const": lambda: special("OR", B, _ref("a"), const(None, B)),
    "and_or": lambda: special("AND", B, special("OR", B, _ref("a"),
                                                 _ref("b")), _ref("c")),
    "in_int": lambda: special("IN", B, _ref("x"), const(1, RT.BIGINT),
                              const(-2, RT.BIGINT)),
    "in_int_null_item": lambda: special("IN", B, _ref("x"),
                                        const(1, RT.BIGINT),
                                        const(None, RT.BIGINT)),
    "in_int_column_items": lambda: special("IN", B, _ref("x"), _ref("y"),
                                           const(0, RT.BIGINT)),
    "in_strings_two_widths": lambda: special(
        "IN", B, _ref("s"), const("ab", RT.varchar(2)),
        const("abcdef", RT.varchar(6)), _ref("w"),
        const("abcdefghijkl", RT.varchar(12))),
    "in_strings_null_item": lambda: special(
        "IN", B, _ref("s"), const("13-555", RT.varchar(6)),
        const(None, RT.varchar(6))),
    "in_decimals_two_scales": lambda: special(
        "IN", B, _ref("d2"), const(30000, D4), _ref("d4"),
        const(-100, D2)),
    "in_long_decimals": lambda: special("IN", B, _ref("big"), _ref("big2"),
                                        const(500, D38)),
    "is_null_int": lambda: special("IS_NULL", B, _ref("x")),
    "is_null_string": lambda: special("IS_NULL", B, _ref("s")),
    "is_null_int128": lambda: special("IS_NULL", B, _ref("big")),
    "if": lambda: special("IF", RT.BIGINT, _ref("a"), _ref("x"),
                          _ref("y")),
    "if_no_else": lambda: special("IF", RT.BIGINT, _ref("a"), _ref("x")),
    "if_strings_two_widths": lambda: special("IF", RT.varchar(12),
                                             _ref("b"), _ref("s"),
                                             _ref("w")),
    "if_int128_and_int64": lambda: special("IF", D38, _ref("c"),
                                           _ref("big"), _ref("d2")),
    "null_if_int": lambda: special("NULL_IF", RT.BIGINT, _ref("x"),
                                   _ref("y")),
    "null_if_string": lambda: special("NULL_IF", RT.varchar(6), _ref("s"),
                                      const("ab", RT.varchar(2))),
    "coalesce_int": lambda: special("COALESCE", RT.BIGINT, _ref("x"),
                                    _ref("y"), const(9, RT.BIGINT)),
    "coalesce_int128_and_int64": lambda: special(
        "COALESCE", D38, _ref("big"), _ref("d2"), _ref("big2")),
    "coalesce_int64_then_int128": lambda: special(
        "COALESCE", D38, _ref("d2"), _ref("big"), const(7, D38)),
    "coalesce_strings": lambda: special("COALESCE", RT.varchar(12),
                                        _ref("s"), _ref("w"),
                                        const("zz", RT.varchar(2))),
    "coalesce_all_null": lambda: special("COALESCE", RT.BIGINT,
                                         const(None, RT.BIGINT), _ref("x")),
    "not": lambda: call("not", B, _ref("a")),
    "not_in": lambda: call("not", B, special("IN", B, _ref("x"),
                                             const(1, RT.BIGINT),
                                             const(None, RT.BIGINT))),
    "year_date": lambda: call("year", RT.BIGINT, _ref("day")),
    "year_timestamp": lambda: call("year", RT.BIGINT, _ref("ts")),
    "substr_start": lambda: call("substr", RT.varchar(6), _ref("s"),
                                 _ref("start")),
    "substr_start_len": lambda: call("substr", RT.varchar(6), _ref("s"),
                                     _ref("start"), _ref("len")),
    "substr_wide": lambda: call("substr", RT.varchar(12), _ref("w"),
                                _ref("start"), const(2, RT.BIGINT)),
    "substr_const_1_2": lambda: call("substr", RT.varchar(6), _ref("s"),
                                     const(1, RT.BIGINT),
                                     const(2, RT.BIGINT)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_form_matches_reference(staged, case):
    _check(staged, CASES[case]())


def test_kleene_or_and_in_truth_tables(staged):
    """The nine (a, b) pairs of rows 0..8 give SQL's OR, and IN is NULL
    exactly when nothing matched and the value or an item is NULL."""
    v, n = _check(staged, CASES["or"]())
    T_, F_, U = True, False, None
    want = [F_, T_, U, T_, T_, T_, U, T_, U]  # a in (F, T, U) x b
    got = [None if n[i] else bool(v[i]) for i in range(9)]
    assert got == want
    rb, pb = staged
    x = PB.to_numpy(pb.column(CH["x"]))
    v, n = _check(staged, CASES["in_int_null_item"]())
    for i in range(N):
        if x[1][i]:
            assert n[i]
        elif x[0][i] == 1:
            assert not n[i] and v[i]
        else:
            assert n[i]


def test_substr_edges():
    """Start 0, negative starts, starts past either end, and explicit
    lengths (negative, zero, past the end) on one string."""
    s = np.array(["abcdef"] * 9 + [""], dtype=object)
    starts = np.array([0, 1, 3, 6, 7, -1, -6, -7, 2, 1], np.int64)
    lens = np.array([2, 0, 10, 1, 1, 3, 2, 1, -1, 1], np.int64)
    rb = RB.batch_from_numpy([RT.varchar(6), RT.BIGINT, RT.BIGINT],
                             [s, starts, lens])
    pb = PB.batch_from_numpy([PT.varchar(6), PT.BIGINT, PT.BIGINT],
                             [s, starts, lens], device="cpu")
    expr = call("substr", RT.varchar(6), input_ref(0, RT.varchar(6)),
                input_ref(1, RT.BIGINT), input_ref(2, RT.BIGINT))
    want = RB.to_numpy(RC.evaluate(expr, rb))[0]
    got = PB.to_numpy(PC.evaluate(PIR.from_json(RIR.to_json(expr)), pb))[0]
    assert list(got) == list(want) == \
        ["", "", "cdef", "f", "", "f", "ab", "", "", ""]


def test_year_on_negative_days_and_timestamps():
    days = np.array([-1, -365, -366, -719_468, -719_469, 0, 10_957],
                    np.int32)
    ts = days.astype(np.int64) * 86_400_000_000 - 1
    rb = RB.batch_from_numpy([RT.DATE, RT.TIMESTAMP], [days, ts])
    pb = PB.batch_from_numpy([PT.DATE, PT.TIMESTAMP], [days, ts],
                             device="cpu")
    years = []
    for ch, ty in ((0, RT.DATE), (1, RT.TIMESTAMP)):
        expr = call("year", RT.BIGINT, input_ref(ch, ty))
        want = RB.to_numpy(RC.evaluate(expr, rb))[0]
        got = PB.to_numpy(PC.evaluate(PIR.from_json(RIR.to_json(expr)),
                                      pb))[0]
        assert got.tolist() == np.asarray(want).tolist()
        years.append(got.tolist())
    # 1969-12-31, 1969-01-01, 1968-12-31, 0000-03-01, 0000-02-29, ...
    assert years[0] == [1969, 1969, 1968, 0, 0, 1970, 2000]
    # a microsecond before each of those midnights
    assert years[1] == [1969, 1968, 1968, 0, 0, 1969, 1999]
