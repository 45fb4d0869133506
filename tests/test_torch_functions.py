"""The port's arithmetic, math, bitwise, comparison and cast functions
against the reference's, expression by expression.

Each case builds the expression with presto_tpu's IR, sends it through
presto_tpu.expr.ir.to_json to the port's from_json, and evaluates both
over one seeded batch (NULLs, zeros, negatives, INT64_MIN/INT64_MAX,
NaN, infinities, -0.0; tests/_torch_functions_common.py). Results are
compared exactly, doubles bit for bit, except the transcendental
functions of TRANSCENDENTAL: XLA's CPU math and torch's may differ in
the last bit, so those hold within 1e-12 * max(1, |want|).
"""

import decimal

import numpy as np
import pytest
import torch

from _torch_functions_common import (I64_MAX, I64_MIN, REL, TRANSCENDENTAL,
                                     batches, call, check, const, port_expr,
                                     ref, ty)

from presto_tpu.expr import compile as RC
from presto_tpu_torch import block as PB
from presto_tpu_torch.expr import compile as PC
from presto_tpu_torch.expr import functions as PF

BIG, DBL, SHORT = ty("bigint"), ty("double"), ty("decimal(12, 2)")


def _tol(name):
    return REL if name in TRANSCENDENTAL else None


ARITH = {
    "add_bigint": call("add", BIG, ref("ext"), ref("div")),
    "subtract_bigint": call("subtract", BIG, ref("ext"), ref("small")),
    "multiply_bigint": call("multiply", BIG, ref("ext"), ref("div")),
    "divide_bigint": call("divide", BIG, ref("ext"), ref("div")),
    "divide_double": call("divide", DBL, ref("dbl"), ref("div")),
    "divide_decimal_double": call("divide", DBL, ref("short"), ref("dbl")),
    "add_double_decimal": call("add", DBL, ref("dbl"), ref("short")),
    "multiply_double_long": call("multiply", DBL, ref("long"), ref("dbl")),
    "modulus_bigint": call("modulus", BIG, ref("ext"), ref("div")),
    "mod_bigint": call("mod", BIG, ref("div"), ref("small")),
    "modulus_decimal": call("modulus", ty("decimal(38, 2)"), ref("short"),
                            ref("div")),
    "modulus_double": call("modulus", DBL, ref("dbl"), ref("pos")),
    "modulus_int32": call("modulus", ty("integer"), ref("int32"),
                          ref("div")),
    "add_real": call("add", ty("real"), ref("pos"), ref("small")),
    "add_interval": call("add", ty("interval day to second"), ref("ds"),
                         ref("ds")),
    "negate_interval": call("negate", ty("interval year to month"),
                            ref("ym")),
    "abs_bigint": call("abs", BIG, ref("ext")),
    "abs_double": call("abs", DBL, ref("dbl")),
    "abs_long": call("abs", ty("decimal(38, 4)"), ref("long")),
    "not": call("not", ty("boolean"), ref("bool")),
}


@pytest.mark.parametrize("name", sorted(ARITH))
def test_arithmetic_matches_reference(name):
    check(ARITH[name])


MATH = {
    "sqrt_double": call("sqrt", DBL, ref("dbl")),
    "sqrt_decimal": call("sqrt", DBL, ref("short")),
    "floor_double": call("floor", DBL, ref("dbl")),
    "floor_decimal": call("floor", SHORT, ref("short")),
    "floor_bigint": call("floor", BIG, ref("small")),
    "ceil_double": call("ceil", DBL, ref("dbl")),
    "ceiling_decimal": call("ceiling", SHORT, ref("short")),
    "round_double": call("round", DBL, ref("dbl")),
    "round_double_digits": call("round", DBL, ref("dbl"),
                                const(1, BIG)),
    "round_double_column_digits": call("round", DBL, ref("dbl"),
                                       ref("div")),
    "round_decimal": call("round", SHORT, ref("short")),
    "round_decimal_digits": call("round", SHORT, ref("short"),
                                 const(1, BIG)),
    "round_decimal_column_digits": call("round", SHORT, ref("short"),
                                        ref("div")),
    "round_bigint": call("round", BIG, ref("small")),
    "truncate_double": call("truncate", DBL, ref("dbl")),
    "truncate_double_digits": call("truncate", DBL, ref("pos"),
                                   const(2, BIG)),
    "truncate_decimal": call("truncate", SHORT, ref("short")),
    "truncate_decimal_digits": call("truncate", SHORT, ref("short"),
                                    ref("div")),
    "sign_bigint": call("sign", BIG, ref("ext")),
    "sign_decimal": call("sign", BIG, ref("short")),
    "sign_double": call("sign", DBL, ref("dbl")),
    "power": call("power", DBL, ref("pos"), ref("small")),
    "pow": call("pow", DBL, ref("dbl"), ref("div")),
    "exp": call("exp", DBL, ref("pos")),
    "ln": call("ln", DBL, ref("dbl")),
    "log10": call("log10", DBL, ref("short")),
    "greatest_bigint": call("greatest", BIG, ref("ext"), ref("small"),
                            ref("div")),
    "least_bigint": call("least", BIG, ref("ext"), ref("div")),
    "greatest_double": call("greatest", DBL, ref("dbl"), ref("pos")),
    "least_decimal": call("least", SHORT, ref("short"), ref("div")),
    "greatest_date": call("greatest", ty("date"), ref("date"),
                          const(10957, ty("date"))),
    "atan2": call("atan2", DBL, ref("dbl"), ref("pos")),
    "log": call("log", DBL, ref("pos"), ref("dbl")),
    "is_nan": call("is_nan", ty("boolean"), ref("dbl")),
    "is_finite": call("is_finite", ty("boolean"), ref("dbl")),
    "is_infinite": call("is_infinite", ty("boolean"), ref("dbl")),
    "is_nan_decimal": call("is_nan", ty("boolean"), ref("short")),
}
for _f in ("sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh",
           "tanh", "cbrt", "log2", "degrees", "radians"):
    MATH[_f] = call(_f, DBL, ref("dbl" if _f not in ("asin", "acos")
                                 else "pos"))
    MATH[_f + "_bigint"] = call(_f, DBL, ref("small"))


@pytest.mark.parametrize("name", sorted(MATH))
def test_math_matches_reference(name):
    check(MATH[name], rel=_tol(MATH[name].name))


BITWISE = {
    "bitwise_and": call("bitwise_and", BIG, ref("ext"), ref("div")),
    "bitwise_or": call("bitwise_or", BIG, ref("ext"), ref("small")),
    "bitwise_xor": call("bitwise_xor", BIG, ref("ext"), ref("ext")),
    "bitwise_not": call("bitwise_not", BIG, ref("ext")),
    "bitwise_left_shift": call("bitwise_left_shift", BIG, ref("ext"),
                               ref("small")),
    "bitwise_right_shift": call("bitwise_right_shift", BIG, ref("ext"),
                                ref("small")),
    "bitwise_right_shift_arithmetic": call(
        "bitwise_right_shift_arithmetic", BIG, ref("ext"), ref("small")),
    "bit_count": call("bit_count", BIG, ref("ext")),
    "bit_count_bits": call("bit_count", BIG, ref("ext"), ref("small")),
    "bitwise_and_int32": call("bitwise_and", BIG, ref("int32"),
                              ref("ext")),
}


@pytest.mark.parametrize("name", sorted(BITWISE))
def test_bitwise_matches_reference(name):
    check(BITWISE[name])


@pytest.mark.parametrize("shift", [0, 1, 62, 63, 64, -1])
def test_logical_right_shift_at_the_edges(shift):
    """Shift 0 keeps the pattern, 63 leaves the sign bit; a shift is
    taken mod 64."""
    expr = call("bitwise_right_shift", BIG, ref("ext"), const(shift, BIG))
    _, port = check(expr)
    v = np.array([I64_MIN, -1, I64_MAX, 1], dtype=np.int64)
    s = shift & 63
    want = (v.view(np.uint64) >> np.uint64(s)).view(np.int64)
    col = PB.from_numpy(BIG, v, device="cpu")
    got = PF.lookup("bitwise_right_shift").fn(
        BIG, col, PB.from_numpy(BIG, np.full(4, shift, np.int64),
                                device="cpu"))
    assert got.values.tolist() == want.tolist()


CMP = {}
for _op in ("eq", "ne", "lt", "le", "gt", "ge"):
    CMP[f"{_op}_bigint_decimal"] = call(_op, ty("boolean"), ref("ext"),
                                        ref("short"))
    CMP[f"{_op}_double_bigint"] = call(_op, ty("boolean"), ref("dbl"),
                                       ref("small"))
    CMP[f"{_op}_string"] = call(_op, ty("boolean"), ref("words"),
                                ref("needle"))
    CMP[f"{_op}_long_short"] = call(_op, ty("boolean"), ref("long"),
                                    ref("short4"))
for _f in ("is_distinct_from", "is_not_distinct_from"):
    CMP[f"{_f}_bigint"] = call(_f, ty("boolean"), ref("small"), ref("div"))
    CMP[f"{_f}_string"] = call(_f, ty("boolean"), ref("words"),
                               ref("needle"))
    CMP[f"{_f}_double"] = call(_f, ty("boolean"), ref("dbl"), ref("dbl"))
    CMP[f"{_f}_null"] = call(_f, ty("boolean"), ref("small"),
                             const(None, ty("unknown")))


@pytest.mark.parametrize("name", sorted(CMP))
def test_comparisons_match_reference(name):
    check(CMP[name])


CASTS = [
    ("bigint", "integer"), ("bigint", "double"), ("bigint", "decimal(12, 2)"),
    ("bigint", "decimal(38, 2)"), ("small", "smallint"),
    ("small", "tinyint"), ("dbl", "bigint"), ("pos", "decimal(12, 4)"),
    ("dbl", "real"), ("short", "double"), ("short", "bigint"),
    ("short", "decimal(12, 0)"), ("short", "decimal(15, 4)"),
    ("short", "decimal(38, 6)"), ("short4", "decimal(12, 2)"),
    ("long", "double"), ("long", "decimal(38, 6)"), ("int32", "bigint"),
    ("int32", "double"), ("bool", "bigint"), ("bool", "double"),
    ("bool", "integer"), ("words", "varchar(3)"), ("hex", "varchar"),
]


@pytest.mark.parametrize("kind,to", CASTS,
                         ids=[f"{k}-{t}" for k, t in CASTS])
@pytest.mark.parametrize("fn", ["cast", "try_cast"])
def test_casts_match_reference(fn, kind, to):
    if kind == "bigint":
        kind = "ext" if to.startswith(("integer", "double")) else "small"
    if fn == "cast" and kind == "dbl" and to == "bigint":
        kind = "pos"  # an out-of-range double has no defined integer
    check(call(fn, ty(to), ref(kind)))


@pytest.mark.parametrize("kind,to", [("ext", "integer"), ("ext", "smallint"),
                                     ("int32", "tinyint"), ("dbl", "integer"),
                                     ("short", "tinyint"),
                                     ("short4", "smallint")])
def test_try_cast_is_null_out_of_range(kind, to):
    r, p = check(call("try_cast", ty(to), ref(kind)))
    assert p.nulls.sum() > r.nulls.shape[0] // 10  # some lanes went NULL


def _decimal_round(v: int, k: int) -> int:
    ctx = decimal.Context(prec=80)
    q = ctx.scaleb(decimal.Decimal(v), -k).quantize(
        decimal.Decimal(1), rounding=decimal.ROUND_HALF_UP, context=ctx)
    return int(q)


@pytest.mark.parametrize("fn", ["cast", "try_cast"])
@pytest.mark.parametrize("kind,to,k", [
    ("long", "decimal(38, 1)", 3), ("long", "decimal(38, 0)", 4),
    ("short4", "decimal(38, 2)", 2), ("short4", "decimal(20, 0)", 4)])
def test_long_decimal_downscale_rounds_half_away_from_zero(fn, kind, to, k):
    """The reference refuses this cast; the port rounds the exact value
    half away from zero, as Presto does, held against Python's
    decimal module."""
    rb, pb = batches()
    expr = call(fn, ty(to), ref(kind))
    with pytest.raises(NotImplementedError, match="downscale"):
        RC.evaluate(expr, rb)
    out = PC.evaluate(port_expr(expr), pb)
    src, src_nulls = PB.to_numpy(pb.column(
        {"long": 4, "short4": 22}[kind]))
    got, nulls = PB.to_numpy(out)
    np.testing.assert_array_equal(nulls, src_nulls)
    for v, g, n in zip(src, got, nulls):
        if not n:
            assert g == _decimal_round(int(v), k)


def test_long_decimal_to_integer_try_cast_checks_the_range():
    """try_cast of a long decimal to an integer type (the reference
    cannot read the long lanes there) is the rounded value, or NULL
    outside the type."""
    _, pb = batches()
    out = PC.evaluate(port_expr(call("try_cast", ty("integer"),
                                     ref("long"))), pb)
    src, src_nulls = PB.to_numpy(pb.column(4))
    got, nulls = PB.to_numpy(out)
    for v, g, n, sn in zip(src, got, nulls, src_nulls):
        want = None if sn else _decimal_round(int(v), 4)
        if want is None or not -2 ** 31 <= want < 2 ** 31:
            assert n
        else:
            assert not n and g == want


@pytest.mark.parametrize("fn", ["cast", "try_cast"])
def test_varchar_to_number_is_refused_like_the_reference(fn):
    expr = call(fn, BIG, ref("words"))
    rb, pb = batches()
    with pytest.raises(NotImplementedError, match="string-parse"):
        RC.evaluate(expr, rb)
    with pytest.raises(NotImplementedError, match="string-parse"):
        PC.evaluate(port_expr(expr), pb)


def test_modulus_truncates_toward_zero():
    """SQL's modulus takes the dividend's sign; torch's `%` floors."""
    a = PB.from_numpy(BIG, np.array([-7, 7, -7, 7, 0], np.int64),
                      device="cpu")
    b = PB.from_numpy(BIG, np.array([3, -3, -3, 3, 5], np.int64),
                      device="cpu")
    out = PF.lookup("modulus").fn(BIG, a, b)
    assert out.values.tolist() == [-1, 1, -1, 1, 0]
    assert (torch.tensor([-7]) % 3).item() == 2


def test_round_of_a_double_is_half_to_even_as_in_the_reference():
    """jnp.round and torch.round both round half to even; Presto rounds
    half away from zero (ROADMAP queue 3)."""
    v = np.array([0.5, 1.5, 2.5, -0.5, -2.5], np.float64)
    col = PB.from_numpy(DBL, v, device="cpu")
    assert PF.lookup("round").fn(DBL, col).values.tolist() == \
        [0.0, 2.0, 2.0, -0.0, -2.0]


def test_division_by_zero_is_null_in_both():
    r, p = check(call("divide", BIG, ref("small"), const(0, BIG)))
    assert bool(p.nulls[:160].all())


def test_powers_of_ten_are_correctly_rounded():
    """round(x, d) and truncate(x, d) scale by 10^d. The port's powers
    are Python's correctly rounded ones; XLA's pow, which the reference
    calls, is one ulp off at 10^23 (and, in some shapes, at 10^-5:
    ROADMAP queue 3), so the two packages may differ in the last bit of
    round(x, d) there."""
    import jax.numpy as jnp
    d = np.arange(-30, 40)
    want = np.array([float(f"1e{k}") for k in d])
    got = PF._pow10(torch.tensor(d)).numpy()
    assert got.tolist() == want.tolist()
    xla = np.asarray(jnp.power(10.0, jnp.asarray(d, dtype=jnp.float64)))
    assert 23 in d[xla != want].tolist()


def test_sqrt_is_correctly_rounded():
    """torch's CPU sqrt of float64 can be one ulp off; the port's is
    IEEE's (numpy's, which the reference's XLA sqrt matches)."""
    x = np.random.default_rng(3).uniform(0.0, 100.0, 20000)
    col = PB.from_numpy(DBL, x, device="cpu")
    got = PF.lookup("sqrt").fn(DBL, col).values.numpy()
    assert got.tolist() == np.sqrt(x).tolist()


@pytest.mark.parametrize("name", ["round", "floor", "ceil", "truncate",
                                  "sign"])
def test_long_decimal_rounding_is_refused_naming_queue_3(name):
    """A long decimal's lanes are a (hi, lo) pair, which the rounding
    family does not read (the reference fails with AttributeError):
    the port refuses naming ROADMAP queue 3's entry."""
    _, pb = batches()
    with pytest.raises(NotImplementedError,
                       match=r"ROADMAP queue 3, long-decimal "
                             r"round/floor/ceil/truncate/sign"):
        PC.evaluate(port_expr(call(name, ty("decimal(38, 0)"), ref("long"))),
                    pb)


def test_round_of_a_long_decimal_sum_is_refused_naming_queue_3():
    """The reference's plan of SELECT round(sum(extendedprice)) FROM
    lineitem (sum of a decimal(12, 2) is decimal(38, 2)) at sf 0.01."""
    from presto_tpu.exec.runner import prepare_plan
    from presto_tpu.plan import nodes as RN
    from presto_tpu.sql import plan_sql
    from presto_tpu_torch.exec import run_query
    from presto_tpu_torch.plan import from_json
    plan = prepare_plan(plan_sql("SELECT round(sum(extendedprice)) "
                                 "FROM lineitem"), sf=0.01)
    with pytest.raises(NotImplementedError, match=r"ROADMAP queue 3\b"):
        run_query(from_json(RN.to_json(plan)), sf=0.01, device="cpu",
                  prepared=True)
