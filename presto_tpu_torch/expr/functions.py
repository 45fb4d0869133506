"""Scalar function registry: the reference's flat function library.

Counterpart of presto_tpu/expr/functions.py: arithmetic (decimal,
integral and floating), comparisons of every flat type, math and
bitwise functions, dates, timestamps and zoned timestamps, intervals,
strings and varbinary, casts and try_cast, the JSON, regex-capture and
digest functions that run per row on the host, and the geo scalars.
and the 14 functions over arrays, maps and rows (cardinality,
element_at, contains, array_position, array_sum, array_max, array_min,
array_sort, array_distinct, slice, map_keys, map_values, row_pack,
row_field). A function is a name plus an implementation
`(ret_type, *blocks) -> Block`; the compiler computes the default null
mask (OR of argument nulls) and a function only overrides it through
`null_fn`, which may return None when the function computed its own
mask.

Decimal rules are Presto's: add/subtract rescale to the result scale,
multiply adds scales, divide rescales the dividend and rounds half away
from zero. Short decimals (precision <= 18) are int64 lanes; long
decimals compute in exact 128-bit (hi, lo) lanes (int128.py).

Strings are byte strings, as in the reference: length, strpos,
reverse, codepoint and the case functions work on UTF-8 bytes, not
code points (ROADMAP queue 3). Every function that builds a string
keeps the chars past each row's length zero, the layout block.py
states, so that string equality and key words can read whole rows.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json as _json
import math
import re as _re
import zlib
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from .. import int128 as I128
from .. import types as T
from .. import tz as TZ
from ..block import (ArrayColumn, Column, Int128Column, MapColumn,
                     RowColumn, StringColumn, gather_block, pad_chars,
                     torch_dtype)
from ..ops import kernels as K

Block = Union[Column, StringColumn, Int128Column]

__all__ = ["ScalarFunction", "REGISTRY", "register", "lookup",
           "rescale_decimal", "contains_pattern", "GOLD", "mix64",
           "hash64_block", "combine_hash", "decimal_to_f64", "date_format_kernel", "date_trunc_kernel", "date_diff_kernel",
           "split_part_kernel", "host_string_kernel", "host_scalar_kernel",
           "last_day_kernel"]

@dataclasses.dataclass
class ScalarFunction:
    name: str
    fn: Callable
    null_fn: Optional[Callable] = None


REGISTRY: Dict[str, ScalarFunction] = {}


def register(name: str, null_fn=None):
    def deco(fn):
        REGISTRY[name] = ScalarFunction(name, fn, null_fn)
        return fn
    return deco


def lookup(name: str) -> ScalarFunction:
    try:
        return REGISTRY[name]
    except KeyError:
        raise NotImplementedError(
            f"scalar function {name!r} is not registered") from None


def _default_nulls(*blocks: Block):
    nulls = None
    for b in blocks:
        nulls = b.nulls if nulls is None else (nulls | b.nulls)
    return nulls


def _col(ret_type: T.Type, values, *args: Block) -> Column:
    return Column(values, _default_nulls(*args), ret_type)


def _own_nulls(ret, *blocks):
    """null_fn of a function that computes its own null mask."""
    return None


def _dt(ty: T.Type) -> torch.dtype:
    return torch_dtype(ty.to_dtype())


def _i64(b: Column) -> torch.Tensor:
    """A column's lanes widened to int64 (narrow staged lanes too)."""
    return b.values.to(torch.int64)


def _fdiv(a, b):
    """int64 floor division (the reference's `//`)."""
    return torch.div(a, b, rounding_mode="floor")


def _fmod(a, b):
    """int64 floor modulo (the reference's `%`)."""
    return torch.remainder(a, b)


def _sign(x: torch.Tensor) -> torch.Tensor:
    """jnp.sign: NaN stays NaN (torch.sign gives 0)."""
    s = torch.sign(x)
    if x.is_floating_point():
        s = torch.where(torch.isnan(x), x, s)
    return s


_POW10 = [10 ** i for i in range(19)]


def rescale_decimal(values, from_scale: int, to_scale: int):
    """Exact int64 rescale, rounding half away from zero on downscale."""
    if to_scale == from_scale:
        return values
    if to_scale > from_scale:
        return values * _POW10[to_scale - from_scale]
    f = _POW10[from_scale - to_scale]
    half = f // 2
    return torch.where(values >= 0, (values + half) // f,
                       -((-values + half) // f))


def _scale_of(ty: T.Type) -> int:
    return ty.scale if ty.is_decimal else 0


def _is_long_decimal(ty: T.Type) -> bool:
    return ty.is_decimal and not ty.is_short_decimal


def _any128(*blocks) -> bool:
    return any(isinstance(b, Int128Column) for b in blocks)


def _needs128(ret: T.Type, *blocks) -> bool:
    """A long-decimal result or any 128-bit argument takes the exact
    128-bit path."""
    return _is_long_decimal(ret) or _any128(*blocks)


def _as128(b) -> tuple:
    """(hi, lo) lanes of a numeric block at its own scale."""
    if isinstance(b, Int128Column):
        return b.hi, b.lo
    return I128.from_int64(b.values)


def _downscale128(hi, lo, k: int):
    """(hi, lo) / 10^k rounded half away from zero, exactly: the
    magnitude is divided by 10^(k-1) truncating (18 digits a step), then
    by 10, and the last dropped digit decides the rounding (the quotient
    rounds up iff twice the remainder reaches 10^k, iff that digit is at
    least 5)."""
    neg = hi < 0
    mh, ml = I128.neg128(hi, lo)
    mh = torch.where(neg, mh, hi)
    ml = torch.where(neg, ml, lo)
    left = k - 1
    while left > 0:
        step = min(left, 18)
        mh, ml, _ = I128.divmod128_by_u64(
            mh, ml, torch.full_like(ml, 10 ** step))
        left -= step
    qh, ql, digit = I128.divmod128_by_u64(mh, ml, torch.full_like(ml, 10))
    qh, ql = I128.add128(qh, ql, torch.zeros_like(qh),
                         (digit >= 5).to(torch.int64))
    nh, nl = I128.neg128(qh, ql)
    return torch.where(neg, nh, qh), torch.where(neg, nl, ql)


def _rescale128(hi, lo, from_scale: int, to_scale: int):
    if to_scale > from_scale:
        return I128.rescale128_up(hi, lo, 10 ** (to_scale - from_scale))
    if to_scale < from_scale:
        return _downscale128(hi, lo, from_scale - to_scale)
    return hi, lo


def _as128_at_scale(b, to_scale: int) -> tuple:
    hi, lo = _as128(b)
    return _rescale128(hi, lo, _scale_of(b.type), to_scale)


def _u64_to_f64(x: torch.Tensor) -> torch.Tensor:
    """float64 of the unsigned 64-bit value whose bits `x` holds,
    rounded once to nearest (as a uint64 -> float64 conversion): both
    32-bit halves convert exactly and the one add rounds."""
    hi = I128._lshr(x, 32).to(torch.float64)
    return hi * float(1 << 32) + (x & 0xFFFFFFFF).to(torch.float64)


def _int128_to_f64(b: Int128Column) -> torch.Tensor:
    """float64 of a long decimal, converted through its MAGNITUDE: for
    negative values the two's-complement lo lane sits near 2^64 where
    float64 granularity is ~2048, so hi*2^64+lo would lose the low
    bits."""
    neg = b.hi < 0
    mh, ml = I128.neg128(b.hi, b.lo)
    mh = torch.where(neg, mh, b.hi)
    ml = torch.where(neg, ml, b.lo)
    f = mh.to(torch.float64) * float(2 ** 64) + _u64_to_f64(ml)
    f = torch.where(neg, -f, f)
    return f / _POW10[_scale_of(b.type)]


def _promote(ret_type: T.Type, *blocks: Column):
    """Bring numeric args to the ret_type's representation, as the
    reference's `_promote`: decimals to the result's scale as int64
    lanes; for a floating result everything to its dtype, decimals
    descaled (long decimals through their magnitude); otherwise
    decimals to scale 0 and everything to the result's dtype."""
    out = []
    rd = _dt(ret_type)
    for b in blocks:
        if isinstance(b, Int128Column):
            if ret_type.is_floating:
                out.append(_int128_to_f64(b).to(rd))
                continue
            raise NotImplementedError(
                f"long-decimal lanes cannot promote to {ret_type}")
        v = b.values
        if ret_type.is_decimal:
            if not (b.type.is_decimal or b.type.is_integral):
                raise NotImplementedError("float->decimal arithmetic")
            v = rescale_decimal(v.to(torch.int64), _scale_of(b.type),
                                ret_type.scale)
        elif ret_type.is_floating:
            v = v.to(rd)
            if b.type.is_decimal:
                v = v / _POW10[b.type.scale]
        else:
            if b.type.is_decimal:
                v = rescale_decimal(v.to(torch.int64), b.type.scale, 0)
            v = v.to(rd)
        out.append(v)
    return out


def _f64(a) -> torch.Tensor:
    """A numeric block as float64 (decimals descaled, integers widened)."""
    (x,) = _promote(T.DOUBLE, a)
    return x


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------

@register("add")
def _add(ret, a, b):
    if ret.is_decimal and _needs128(ret, a, b):
        ah, al = _as128_at_scale(a, ret.scale)
        bh, bl = _as128_at_scale(b, ret.scale)
        hi, lo = I128.add128(ah, al, bh, bl)
        return Int128Column(hi, lo, _default_nulls(a, b), ret)
    x, y = _promote(ret, a, b)
    return _col(ret, x + y, a, b)


@register("subtract")
def _subtract(ret, a, b):
    if ret.is_decimal and _needs128(ret, a, b):
        ah, al = _as128_at_scale(a, ret.scale)
        bh, bl = _as128_at_scale(b, ret.scale)
        hi, lo = I128.add128(ah, al, *I128.neg128(bh, bl))
        return Int128Column(hi, lo, _default_nulls(a, b), ret)
    x, y = _promote(ret, a, b)
    return _col(ret, x - y, a, b)


@register("multiply")
def _multiply(ret, a, b):
    if ret.is_decimal:
        if _scale_of(a.type) + _scale_of(b.type) != ret.scale:
            raise ValueError(f"decimal multiply scales: {a.type} x {b.type}"
                             f" -> {ret}")
        if _needs128(ret, a, b):
            if not _any128(a, b):
                hi, lo = I128.mul_i64_i64_128(a.values, b.values)
            else:
                ah, al = _as128(a)
                bh, bl = _as128(b)
                hi, lo = I128.mul128(ah, al, bh, bl)
            return Int128Column(hi, lo, _default_nulls(a, b), ret)
        return _col(ret, _i64(a) * _i64(b), a, b)
    x, y = _promote(ret, a, b)
    return _col(ret, x * y, a, b)


def _widened(ret: T.Type, a: Column) -> torch.Tensor:
    """A narrow-lane column's values at the result's own dtype."""
    return a.values.to(_dt(ret))


@register("negate")
def _negate(ret, a):
    if isinstance(a, Int128Column):
        hi, lo = I128.neg128(a.hi, a.lo)
        return Int128Column(hi, lo, a.nulls, ret)
    return _col(ret, -_widened(ret, a), a)


@register("abs")
def _abs(ret, a):
    if isinstance(a, Int128Column):
        nh, nl = I128.neg128(a.hi, a.lo)
        neg = a.hi < 0
        return Int128Column(torch.where(neg, nh, a.hi),
                            torch.where(neg, nl, a.lo), a.nulls, ret)
    return _col(ret, torch.abs(_widened(ret, a)), a)


def _zero_lanes(b):
    if isinstance(b, Int128Column):
        return (b.hi == 0) & (b.lo == 0)
    return b.values == 0


def _div_nulls(ret, a, b):
    return _default_nulls(a, b) | (_zero_lanes(b) & ~b.nulls)


@register("divide", null_fn=_div_nulls)
def _divide(ret, a, b):
    """Division by zero yields NULL (the reference raises; a device
    kernel cannot). Integer division truncates toward zero."""
    nulls = _div_nulls(ret, a, b)
    if ret.is_decimal and (_needs128(ret, a, b) or
                           _scale_of(b.type) + ret.scale - _scale_of(a.type)
                           > 18):
        return _divide128(ret, a, b, nulls)
    if ret.is_decimal:
        sa, sb = _scale_of(a.type), _scale_of(b.type)
        num = _i64(a) * _POW10[ret.scale + sb - sa]
        den = torch.where(b.values == 0, 1, _i64(b))
        neg = (num < 0) != (den < 0)
        an, ad = num.abs(), den.abs()
        q = (2 * an + ad) // (2 * ad)
        return Column(torch.where(neg, -q, q), nulls, ret)
    if ret.is_integral:
        x = _i64(a)
        y = torch.where(b.values == 0, 1, _i64(b))
        q = torch.div(x, y, rounding_mode="trunc")
        return Column(q.to(_dt(ret)), nulls, ret)
    x, y = _promote(ret, a, b)
    return Column(x / torch.where(y == 0, 1.0, y), nulls, ret)


def _divide128(ret, a, b, nulls):
    """Exact long-decimal division, rounding half away from zero. The
    divisor must fit 64-bit lanes (|b| < 2^63)."""
    sa, sb = _scale_of(a.type), _scale_of(b.type)
    ah, al = _as128(a)
    factor = 10 ** (ret.scale + sb - sa)
    if factor > 1:
        ah, al = I128.rescale128_up(ah, al, factor)
    if isinstance(b, Int128Column):
        bv = b.lo
        bneg = b.hi < 0
    else:
        bv = _i64(b)
        bneg = bv < 0
    bv = torch.where(bneg, -bv, bv)
    bv = torch.where(bv == 0, 1, bv)
    aneg = ah < 0
    mh, ml = I128.neg128(ah, al)
    mh = torch.where(aneg, mh, ah)
    ml = torch.where(aneg, ml, al)
    qh, ql, rem = I128.divmod128_by_u64(mh, ml, bv)
    half_up = I128._uge(2 * rem, bv).to(torch.int64)
    qh2, ql2 = I128.add128(qh, ql, torch.zeros_like(qh), half_up)
    neg = aneg != bneg
    nh, nl = I128.neg128(qh2, ql2)
    return Int128Column(torch.where(neg, nh, qh2), torch.where(neg, nl, ql2),
                        nulls, ret)


@register("modulus", null_fn=_div_nulls)
def _modulus(ret, a, b):
    """Floor vs truncation: torch's integer `%` floors (its sign is the
    divisor's); SQL's modulus truncates, so the sign is the dividend's:
    sign(x) * (|x| % |y|), as the reference computes it."""
    x, y = _promote(ret, a, b)
    y = torch.where(y == 0, 1, y)
    r = _sign(x) * torch.fmod(x.abs(), y.abs())
    return Column(r.to(_dt(ret)), _div_nulls(ret, a, b), ret)


REGISTRY["mod"] = REGISTRY["modulus"]


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

_DAY_US = 86_400_000_000
_TZ_BASE = "timestamp with time zone"


def _cmp_values(a: Block, b: Block):
    """Comparable lanes of two fixed-width operands, as the reference's
    `_cmp_values`: decimals and integers as int64 at one scale; with a
    floating operand, both as float64 (decimals descaled); a zoned
    timestamp, or a date against a timestamp, as UTC micros."""
    sa, sb = _scale_of(a.type), _scale_of(b.type)
    floating = a.type.is_floating or b.type.is_floating
    if (a.type.is_decimal or b.type.is_decimal) and not floating:
        s = max(sa, sb)
        return (rescale_decimal(_i64(a), sa, s),
                rescale_decimal(_i64(b), sb, s))
    if floating:
        va = a.values.to(torch.float64)
        vb = b.values.to(torch.float64)
        if a.type.is_decimal:
            va = va / _POW10[sa]
        if b.type.is_decimal:
            vb = vb / _POW10[sb]
        return va, vb
    bases = (a.type.base, b.type.base)
    if _TZ_BASE in bases or ("date" in bases and "timestamp" in bases):
        return _instant_micros(a), _instant_micros(b)
    return a.values, b.values


def _str_eq(a: StringColumn, b: StringColumn):
    w = max(a.max_len, b.max_len)
    ca, cb = pad_chars(a, w).chars, pad_chars(b, w).chars
    return (ca == cb).all(dim=1) & (a.lengths == b.lengths)


def _str_cmp(a: StringColumn, b: StringColumn):
    """Lexicographic compare: -1, 0 or 1 per row. Zero padding makes a
    shorter string compare smaller."""
    w = max(a.max_len, b.max_len)
    ca = pad_chars(a, w).chars.to(torch.int32)
    cb = pad_chars(b, w).chars.to(torch.int32)
    diff = torch.sign(ca - cb)
    first = torch.argmax(diff.abs(), dim=1, keepdim=True)
    return torch.gather(diff, 1, first)[:, 0]


def _binary_cmp(op):
    def fn(ret, a, b):
        if isinstance(a, StringColumn) and isinstance(b, StringColumn):
            if op in ("eq", "ne"):
                eq = _str_eq(a, b)
                v = eq if op == "eq" else ~eq
            else:
                d = _str_cmp(a, b)
                v = {"lt": d < 0, "le": d <= 0, "gt": d > 0,
                     "ge": d >= 0}[op]
            return _col(ret, v, a, b)
        if isinstance(a, StringColumn) or isinstance(b, StringColumn):
            raise NotImplementedError(
                f"comparing {a.type} with {b.type}: the reference has no "
                "such comparison")
        if _any128(a, b):
            s = max(_scale_of(a.type), _scale_of(b.type))
            ah, al = _as128_at_scale(a, s)
            bh, bl = _as128_at_scale(b, s)
            lt, eq = I128.cmp128(ah, al, bh, bl)
            v = {"eq": eq, "ne": ~eq, "lt": lt, "le": lt | eq,
                 "gt": ~(lt | eq), "ge": ~lt}[op]
            return _col(ret, v, a, b)
        x, y = _cmp_values(a, b)
        v = {"eq": x == y, "ne": x != y, "lt": x < y,
             "le": x <= y, "gt": x > y, "ge": x >= y}[op]
        return _col(ret, v, a, b)
    return fn


for _opname, _presto in [("eq", "$operator$equal"),
                         ("ne", "$operator$not_equal"),
                         ("lt", "$operator$less_than"),
                         ("le", "$operator$less_than_or_equal"),
                         ("gt", "$operator$greater_than"),
                         ("ge", "$operator$greater_than_or_equal")]:
    _f = _binary_cmp(_opname)
    REGISTRY[_opname] = ScalarFunction(_opname, _f)
    REGISTRY[_presto] = ScalarFunction(_presto, _f)


@register("not")
def _not(ret, a):
    return _col(ret, ~a.values, a)


def _never_null(ret, a, b):
    return torch.zeros_like(a.nulls)  # IS [NOT] DISTINCT FROM is never NULL


@register("is_distinct_from", null_fn=_never_null)
def _is_distinct_from(ret, a, b):
    eq = _binary_cmp("eq")(T.BOOLEAN, a, b)
    same = (a.nulls & b.nulls) | (~a.nulls & ~b.nulls & eq.values)
    return Column(~same, torch.zeros_like(a.nulls), ret)


@register("is_not_distinct_from", null_fn=_never_null)
def _is_not_distinct_from(ret, a, b):
    d = _is_distinct_from(T.BOOLEAN, a, b)
    return Column(~d.values, torch.zeros_like(a.nulls), ret)


# ---------------------------------------------------------------------------
# math
# ---------------------------------------------------------------------------

def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """IEEE square root, correctly rounded. torch's CPU sqrt of float64
    (its AVX-512 path) can be one ulp off; CUDA's is correctly rounded.
    The root s is moved to a neighbour whose square is nearer to x: the
    squares' residuals x - s*s are exact enough through Dekker's
    product (a Veltkamp split, no fused multiply-add), since two
    neighbours' residuals differ by about 2 s ulp(s)."""
    s = torch.sqrt(x)
    if s.dtype != torch.float64:
        return s
    ok = torch.isfinite(x) & (x > 1e-290)

    def residual(r):
        c = 134217729.0 * r  # 2^27 + 1
        hi = c - (c - r)
        lo = r - hi
        p = r * r
        err = ((hi * hi - p) + 2.0 * hi * lo) + lo * lo
        return (x - p) - err

    best, best_res = s, residual(s).abs()
    for nb in (torch.nextafter(s, torch.full_like(s, float("inf"))),
               torch.nextafter(s, torch.zeros_like(s))):
        res = residual(nb).abs()
        better = ok & (res < best_res)
        best = torch.where(better, nb, best)
        best_res = torch.where(better, res, best_res)
    return best


@register("sqrt")
def _sqrt(ret, a):
    (x,) = _promote(ret, a)
    return _col(ret, _sqrt_rn(torch.clamp(x, min=0.0)), a)


def _refuse_long_decimal(name: str, a) -> None:
    """The rounding family reads int64 lanes; a long decimal's are a
    (hi, lo) pair, which the reference cannot read either."""
    if isinstance(a, Int128Column):
        raise NotImplementedError(
            f"{name} of a long decimal ({a.type}) is not ported: ROADMAP "
            "queue 3, long-decimal round/floor/ceil/truncate/sign")


@register("floor")
def _floor(ret, a):
    _refuse_long_decimal("floor", a)
    if a.type.is_decimal:
        f = _POW10[a.type.scale]
        v = _i64(a)
        v = torch.where(v >= 0, v // f, -((-v + f - 1) // f))
        return _col(ret, rescale_decimal(v, 0, _scale_of(ret)), a)
    return _col(ret, torch.floor(a.values.to(torch.float64)).to(_dt(ret)), a)


@register("ceil")
@register("ceiling")
def _ceil(ret, a):
    _refuse_long_decimal("ceil", a)
    if a.type.is_decimal:
        f = _POW10[a.type.scale]
        v = _i64(a)
        v = torch.where(v >= 0, (v + f - 1) // f, -((-v) // f))
        return _col(ret, rescale_decimal(v, 0, _scale_of(ret)), a)
    return _col(ret, torch.ceil(a.values.to(torch.float64)).to(_dt(ret)), a)


@register("round")
def _round(ret, a, *rest):
    """Decimals round half away from zero (Presto's rule). Doubles round
    as the reference's `jnp.round` does: half to EVEN, where Presto
    rounds half away from zero (ROADMAP queue 3); torch.round is half
    to even too."""
    _refuse_long_decimal("round", a)
    if a.type.is_decimal:
        s = a.type.scale
        v = _i64(a)
        if not rest:
            return _col(ret, rescale_decimal(rescale_decimal(v, s, 0), 0,
                                             _scale_of(ret)), a)
        # round(decimal, d): zero the digits below 10^-d and keep the
        # scale; each candidate scale k in 0..s, chosen per row
        d = rest[0].values.to(torch.int32)
        cands = [rescale_decimal(rescale_decimal(v, s, k), k, _scale_of(ret))
                 for k in range(s + 1)]
        out = cands[-1]
        for k in range(s - 1, -1, -1):
            out = torch.where(d <= k, cands[k], out)
        return _col(ret, out, a, rest[0])
    x = a.values.to(torch.float64)
    if rest:
        p = _pow10(rest[0].values)
        return _col(ret, torch.round(x * p) / p, a, rest[0])
    return _col(ret, torch.round(x).to(_dt(ret)), a)


_POW10_LO, _POW10_HI = -330, 330


def _pow10(d: torch.Tensor) -> torch.Tensor:
    """10.0 ** d, correctly rounded for integer d (a table of Python's
    correctly rounded powers; beyond it the values are 0 or inf). XLA's
    pow, which the reference calls, is not always correctly rounded
    (10^23: ROADMAP queue 3), nor is torch's (10^45)."""
    if d.is_floating_point():
        return torch.pow(10.0, d.to(torch.float64))
    table = torch.tensor([float(f"1e{k}") for k in
                          range(_POW10_LO, _POW10_HI + 1)],
                         dtype=torch.float64, device=d.device)
    k = d.to(torch.int64).clamp(_POW10_LO, _POW10_HI) - _POW10_LO
    return table[k]


@register("truncate")
def _truncate(ret, a, *rest):
    _refuse_long_decimal("truncate", a)
    if a.type.is_decimal:
        s = a.type.scale
        v = _i64(a)
        if not rest:
            f = _POW10[s]
            t = torch.where(v >= 0, v // f, -((-v) // f))
            return _col(ret, rescale_decimal(t, 0, _scale_of(ret)), a)
        # truncate(decimal, d): zero the digits below 10^-d, keeping the
        # scale; a negative d zeroes digits left of the point, and d at
        # or below -(18 - s) truncates everything to 0 (TruncateN)
        d = rest[0].values.to(torch.int32)

        def trunc_to(k):
            f = _POW10[s - k]
            return torch.where(v >= 0, v // f, -((-v) // f)) * f
        k_min = -(18 - s)
        ks = list(range(k_min, s + 1))
        cands = {k: rescale_decimal(trunc_to(k), s, _scale_of(ret))
                 for k in ks}
        out = cands[ks[-1]]
        for k in reversed(ks[:-1]):
            out = torch.where(d <= k, cands[k], out)
        out = torch.where(d <= k_min, 0, out)
        return _col(ret, out, a, rest[0])
    x = a.values.to(torch.float64)
    if rest:
        p = _pow10(rest[0].values)
        return _col(ret, (torch.trunc(x * p) / p).to(_dt(ret)), a, rest[0])
    return _col(ret, torch.trunc(x).to(_dt(ret)), a)


@register("sign")
def _sign_fn(ret, a):
    _refuse_long_decimal("sign", a)
    return _col(ret, _sign(a.values).to(_dt(ret)), a)


@register("power")
@register("pow")
def _power(ret, a, b):
    x, y = _promote(ret, a, b)
    return _col(ret, torch.pow(x, y), a, b)


@register("exp")
def _exp(ret, a):
    (x,) = _promote(ret, a)
    return _col(ret, torch.exp(x), a)


@register("ln")
def _ln(ret, a):
    (x,) = _promote(ret, a)
    return _col(ret, torch.log(torch.clamp(x, min=1e-300)), a)


@register("log10")
def _log10(ret, a):
    (x,) = _promote(ret, a)
    return _col(ret, torch.log10(torch.clamp(x, min=1e-300)), a)


@register("greatest")
def _greatest(ret, *args):
    xs = _promote(ret, *args)
    v = xs[0]
    for x in xs[1:]:
        v = torch.maximum(v, x)
    return _col(ret, v, *args)


@register("least")
def _least(ret, *args):
    xs = _promote(ret, *args)
    v = xs[0]
    for x in xs[1:]:
        v = torch.minimum(v, x)
    return _col(ret, v, *args)


def _register_float1(name, fn):
    @register(name)
    def _impl(ret, a, _fn=fn):
        return _col(ret, _fn(_f64(a)), a)
    return _impl


for _name, _fn in [
        ("sin", torch.sin), ("cos", torch.cos), ("tan", torch.tan),
        ("asin", torch.asin), ("acos", torch.acos), ("atan", torch.atan),
        ("sinh", torch.sinh), ("cosh", torch.cosh), ("tanh", torch.tanh),
        ("cbrt", lambda x: torch.sign(x) * torch.pow(x.abs(), 1.0 / 3.0)),
        ("log2", torch.log2), ("degrees", torch.rad2deg),
        ("radians", torch.deg2rad)]:
    _register_float1(_name, _fn)


@register("atan2")
def _atan2(ret, y, x):
    return _col(ret, torch.atan2(_f64(y), _f64(x)), y, x)


@register("log")
def _log(ret, base, x):
    return _col(ret, torch.log(_f64(x)) / torch.log(_f64(base)), base, x)


@register("is_nan")
def _is_nan(ret, a):
    return _col(ret, torch.isnan(_f64(a)), a)


@register("is_finite")
def _is_finite(ret, a):
    return _col(ret, torch.isfinite(_f64(a)), a)


@register("is_infinite")
def _is_infinite(ret, a):
    return _col(ret, torch.isinf(_f64(a)), a)


def _bitwise(name, op):
    @register(name)
    def _impl(ret, a, b, _op=op):
        return _col(ret, _op(_i64(a), _i64(b)), a, b)
    return _impl


_bitwise("bitwise_and", torch.bitwise_and)
_bitwise("bitwise_or", torch.bitwise_or)
_bitwise("bitwise_xor", torch.bitwise_xor)


@register("bitwise_not")
def _bitwise_not(ret, a):
    return _col(ret, ~_i64(a), a)


@register("bitwise_left_shift")
def _shl(ret, a, b):
    s = _i64(b) & 63  # Java/Presto shift mod 64
    return _col(ret, _i64(a) << s, a, b)


@register("bitwise_right_shift")
def _shr(ret, a, b):
    """Logical right shift of the 64-bit pattern. torch has no uint64
    shift, so the arithmetic shift of the int64 lanes is masked to its
    low 64 - s bits; a shift of 0 keeps the value (the mask would need
    a shift by 64), and 63 leaves the sign bit alone."""
    s = _i64(b) & 63
    v = _i64(a)
    nz = torch.where(s == 0, 1, s)
    shifted = (v >> nz) & ((torch.ones_like(nz) << (64 - nz)) - 1)
    return _col(ret, torch.where(s == 0, v, shifted), a, b)


@register("bitwise_right_shift_arithmetic")
def _sar(ret, a, b):
    s = _i64(b) & 63
    return _col(ret, _i64(a) >> s, a, b)


def _popcount64(u: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 pattern (SWAR; logical shifts)."""
    lshr = I128._lshr
    u = u - (lshr(u, 1) & 0x5555555555555555)
    u = (u & 0x3333333333333333) + (lshr(u, 2) & 0x3333333333333333)
    u = (u + lshr(u, 4)) & 0x0F0F0F0F0F0F0F0F
    return lshr(u * 0x0101010101010101, 56)


@register("bit_count")
def _bit_count(ret, a, bits=None):
    u = _i64(a)
    if bits is not None:
        # the reference reads the width as uint64: a negative width is
        # beyond 64 and keeps every bit
        width = _i64(bits)
        full = (width >= 64) | (width < 0)
        sh = torch.where(full, 0, width)
        u = u & torch.where(full, -1, (torch.ones_like(sh) << sh) - 1)
    cnt = _popcount64(u)
    return _col(ret, cnt, a) if bits is None else _col(ret, cnt, a, bits)


# ---------------------------------------------------------------------------
# dates (DATE = days since epoch, TIMESTAMP = micros since epoch; civil
# dates by Howard Hinnant's algorithms, vectorized)
# ---------------------------------------------------------------------------

def _civil(days):
    """(year, month, day) of days since epoch."""
    z = days.to(torch.int64) + 719468
    era = _fdiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    return torch.where(m <= 2, y + 1, y), m, d


def _days_from_civil(y, m, d):
    y = y - (m <= 2).to(torch.int64)
    era = _fdiv(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def last_day_kernel(y, m):
    """Day of month of the last day of civil (y, m)."""
    ny = torch.where(m == 12, y + 1, y)
    nm = torch.where(m == 12, 1, m + 1)
    return _civil(_days_from_civil(ny, nm, torch.ones_like(y)) - 1)[2]


def _as_days(a: Column):
    if a.type.base == "timestamp":
        return _fdiv(_i64(a), _DAY_US)
    if a.type.base != "date":
        raise NotImplementedError(
            f"date fields of {a.type}: the reference reads its lanes as "
            "days (ROADMAP queue 3)")
    return _i64(a)


def _date_field(name, fn):
    @register(name)
    def _impl(ret, a, _fn=fn):
        return _col(ret, _fn(_as_days(a)).to(_dt(ret)), a)
    return _impl


_date_field("year", lambda days: _civil(days)[0])
_date_field("month", lambda days: _civil(days)[1])
_date_field("day", lambda days: _civil(days)[2])
_date_field("day_of_month", lambda days: _civil(days)[2])
_date_field("quarter", lambda days: _fdiv(_civil(days)[1] - 1, 3) + 1)
# 1970-01-01 was a Thursday; ISO day of week Monday = 1 .. Sunday = 7
_date_field("day_of_week", lambda days: _fmod(days + 3, 7) + 1)
_date_field("dow", lambda days: _fmod(days + 3, 7) + 1)


def _doy(days):
    y = _civil(days)[0]
    one = torch.ones_like(y)
    return days - _days_from_civil(y, one, one) + 1


_date_field("day_of_year", _doy)
_date_field("doy", _doy)


@register("last_day_of_month")
def _last_day_of_month(ret, a):
    y, m, _ = _civil(_as_days(a))
    v = _days_from_civil(y, m, last_day_kernel(y, m))
    return _col(ret, v.to(_dt(ret)), a)


_DATE_FMT_WIDTHS = {"Y": 4, "y": 2, "m": 2, "d": 2, "H": 2, "i": 2,
                    "s": 2, "j": 3, "%": 1}


def date_format_width(fmt: str) -> int:
    """Output width of a date_format pattern; raises NotImplementedError
    on a specifier `date_format_kernel` does not write (the planner
    sizes the result with it, and the validator refuses such a format
    at plan time). %e (the unpadded day) is one of them: its width
    varies mid-string, which a fixed-width char matrix cannot hold."""
    width = 0
    i = 0
    while i < len(fmt):
        if fmt[i] == "%" and i + 1 < len(fmt):
            sp = fmt[i + 1]
            if sp not in _DATE_FMT_WIDTHS:
                raise NotImplementedError(f"date_format %{sp}")
            width += _DATE_FMT_WIDTHS[sp]
            i += 2
        else:
            width += 1
            i += 1
    return max(width, 1)


def date_format_kernel(values: torch.Tensor, ty: T.Type, fmt: str):
    """date_format(x, 'mysql-format') -> (chars, lengths) with the
    specifiers %Y %y %m %d %H %i %s %j %%, built as fixed-width digit
    columns (every row has the same width)."""
    v = values.to(torch.int64)
    if ty.base == "timestamp":
        days = _fdiv(v, _DAY_US)
        secs = _fmod(_fdiv(v, 1_000_000), 86_400)
    elif ty.base == "date":
        days = v
        secs = torch.zeros_like(v)
    else:
        raise NotImplementedError(f"date_format of {ty}")
    y, m, d = _civil(days)
    fields = {"Y": (y, 4), "y": (_fmod(y, 100), 2), "m": (m, 2),
              "d": (d, 2), "H": (_fdiv(secs, 3600), 2),
              "i": (_fmod(_fdiv(secs, 60), 60), 2), "s": (_fmod(secs, 60), 2),
              "j": (_doy(days), 3)}

    def const(ch):
        return torch.full_like(v, ord(ch))

    cols = []
    i = 0
    while i < len(fmt):
        c = fmt[i]
        if c == "%" and i + 1 < len(fmt):
            sp = fmt[i + 1]
            i += 2
            if sp == "%":
                cols.append(const("%"))
            elif sp in fields:
                f, k = fields[sp]
                cols += [_fmod(_fdiv(f, 10 ** (k - 1 - j)), 10) + 48
                         for j in range(k)]
            else:
                raise NotImplementedError(f"date_format %{sp}")
        else:
            cols.append(const(c))
            i += 1
    chars = torch.stack(cols, dim=1).to(torch.uint8)
    return chars, torch.full((v.shape[0],), chars.shape[1],
                             dtype=torch.int32, device=v.device)


def date_trunc_kernel(unit: str, days: torch.Tensor) -> torch.Tensor:
    days = days.to(torch.int64)
    y, m, _ = _civil(days)
    one = torch.ones_like(y)
    if unit == "day":
        return days
    if unit == "week":  # ISO Monday
        return days - _fmod(days + 3, 7)
    if unit == "month":
        return _days_from_civil(y, m, one)
    if unit == "quarter":
        return _days_from_civil(y, _fdiv(m - 1, 3) * 3 + 1, one)
    if unit == "year":
        return _days_from_civil(y, one, one)
    raise NotImplementedError(f"date_trunc unit {unit!r}")


def _trunc_units(delta: torch.Tensor, step: int) -> torch.Tensor:
    """Whole `step`s in delta, truncated toward zero."""
    return torch.sign(delta) * (delta.abs() // step)


def date_diff_kernel(unit: str, d1, d2) -> torch.Tensor:
    """date_diff(unit, start, end): end - start in whole units, truncated
    toward zero; month units clamp at the end of a month (Jan 31 to Feb
    29 is a whole month)."""
    d1, d2 = d1.to(torch.int64), d2.to(torch.int64)
    if unit == "day":
        return d2 - d1
    if unit == "week":
        return _trunc_units(d2 - d1, 7)
    y1, m1, dd1 = _civil(d1)
    y2, m2, dd2 = _civil(d2)
    months = (y2 * 12 + m2) - (y1 * 12 + m1)
    eom2 = dd2 == last_day_kernel(y2, m2)
    eom1 = dd1 == last_day_kernel(y1, m1)
    partial_fwd = (dd2 < dd1) & ~eom2
    partial_bwd = (dd2 > dd1) & ~eom1
    adj = torch.where((months > 0) & partial_fwd, 1,
                      torch.where((months < 0) & partial_bwd, -1, 0))
    months = months - adj
    if unit == "month":
        return months
    if unit == "quarter":
        return _trunc_units(months, 3)
    if unit == "year":
        return _trunc_units(months, 12)
    raise NotImplementedError(f"date_diff unit {unit!r}")


@register("from_unixtime")
def _from_unixtime(ret, a):
    # seconds (possibly fractional) -> TIMESTAMP micros
    return _col(ret, torch.round(_f64(a) * 1e6).to(torch.int64), a)


@register("to_unixtime")
def _to_unixtime(ret, a):
    """The lanes over 1e6, as the reference computes it: for a zoned
    timestamp that is the packed lane (ROADMAP queue 3)."""
    return _col(ret, a.values.to(torch.float64) / 1e6, a)


# zoned timestamps, TIME and intervals: fields and calendar arithmetic
# work on the value's own wall clock, comparisons on the instant

def _as_local_micros(a: Column) -> torch.Tensor:
    """Wall-clock micros of a date/time/timestamp/zoned timestamp."""
    base = a.type.base
    if base == _TZ_BASE:
        return TZ.local_micros(a.values)
    if base == "date":
        return _i64(a) * _DAY_US
    return _i64(a)


def _instant_micros(a: Column) -> torch.Tensor:
    base = a.type.base
    if base == _TZ_BASE:
        return TZ.unpack_micros(a.values)
    if base == "date":
        return _i64(a) * _DAY_US
    return _i64(a)


def _register_tod_field(name, divisor, modulus):
    @register(name)
    def _field(ret, a, _d=divisor, _m=modulus):
        us = _fmod(_as_local_micros(a), _DAY_US)
        return _col(ret, _fmod(_fdiv(us, _d), _m).to(_dt(ret)), a)
    return _field


_register_tod_field("hour", 3_600_000_000, 24)
_register_tod_field("minute", 60_000_000, 60)
_register_tod_field("second", 1_000_000, 60)
_register_tod_field("millisecond", 1_000, 1000)


def _zone_minutes(a: Column, name: str) -> torch.Tensor:
    if a.type.base != _TZ_BASE:
        raise NotImplementedError(
            f"{name} needs timestamp with time zone, got {a.type}")
    return (_i64(a) & TZ.KEY_MASK) - TZ.UTC_KEY


@register("timezone_hour")
def _timezone_hour(ret, a):
    return _col(ret, _trunc_units(_zone_minutes(a, "timezone_hour"), 60)
                .to(_dt(ret)), a)


@register("timezone_minute")
def _timezone_minute(ret, a):
    minutes = _zone_minutes(a, "timezone_minute")
    return _col(ret, (torch.sign(minutes) * (minutes.abs() % 60))
                .to(_dt(ret)), a)


def _month_add(days, months):
    """Calendar month arithmetic, clamped at the end of the month."""
    y, m, d = _civil(days)
    tot = (y * 12 + (m - 1)) + months
    ny, nm = _fdiv(tot, 12), _fmod(tot, 12) + 1
    return _days_from_civil(ny, nm, torch.minimum(d, last_day_kernel(ny, nm)))


@register("datetime_interval_add")
def _datetime_interval_add(ret, a, b):
    """datetime a + interval b (the planner negates b to subtract).
    Day-to-second intervals shift the instant (a zoned value keeps its
    key); year-to-month intervals do calendar month arithmetic on the
    value's wall clock."""
    base = a.type.base
    av, bv = _i64(a), _i64(b)
    if b.type.base == "interval day to second":
        if base == _TZ_BASE:
            v = (((av >> 12) + bv) << 12) | (av & TZ.KEY_MASK)
        elif base == "date":
            v = av * _DAY_US + bv
            if ret.base == "date":
                v = _fdiv(v, _DAY_US)
        elif base == "time":
            v = _fmod(av + bv, _DAY_US)
        else:
            v = av + bv
        return _col(ret, v.to(_dt(ret)), a, b)
    if base == "date":
        v = _month_add(av, bv)
    elif base == "timestamp":
        days, tod = _fdiv(av, _DAY_US), _fmod(av, _DAY_US)
        v = _month_add(days, bv) * _DAY_US + tod
    elif base == _TZ_BASE:
        key = av & TZ.KEY_MASK
        off = (key - TZ.UTC_KEY) * TZ.MICROS_PER_MINUTE
        local = (av >> 12) + off
        days, tod = _fdiv(local, _DAY_US), _fmod(local, _DAY_US)
        nlocal = _month_add(days, bv) * _DAY_US + tod
        v = ((nlocal - off) << 12) | key
    else:
        raise NotImplementedError(f"{base} + year-month interval")
    return _col(ret, v.to(_dt(ret)), a, b)


@register("datetime_diff_micros")
def _datetime_diff_micros(ret, a, b):
    """a - b as INTERVAL DAY TO SECOND (micros), instants compared."""
    return _col(ret, _instant_micros(a) - _instant_micros(b), a, b)


# ---------------------------------------------------------------------------
# strings (byte strings; see the module docstring)
# ---------------------------------------------------------------------------

def _positions(a: StringColumn) -> torch.Tensor:
    return torch.arange(a.chars.shape[1], dtype=torch.int64,
                        device=a.chars.device)[None, :]


def _slice_rows(a: StringColumn, start: torch.Tensor, length: torch.Tensor,
                nulls, ret) -> StringColumn:
    """Row i's bytes [start_i, start_i + length_i) of `a`, zero padded."""
    w = a.chars.shape[1]
    pos = _positions(a)
    idx = (start.to(torch.int64)[:, None] + pos).clamp(0, w - 1)
    g = torch.gather(a.chars, 1, idx.expand(a.chars.shape[0], w))
    out = torch.where(pos < length.to(torch.int64)[:, None], g, 0)
    return StringColumn(out.to(torch.uint8), length.to(torch.int32), nulls,
                        ret)


@register("length")
def _length(ret, a: StringColumn):
    return _col(ret, a.lengths.to(_dt(ret)), a)


@register("upper")
def _upper(ret, a: StringColumn):
    """ASCII upper case over the padded bytes; lengths are unchanged."""
    c = a.chars
    return StringColumn(torch.where((c >= 97) & (c <= 122), c - 32, c),
                        a.lengths, a.nulls, ret)


@register("lower")
def _lower(ret, a: StringColumn):
    c = a.chars
    return StringColumn(torch.where((c >= 65) & (c <= 90), c + 32, c),
                        a.lengths, a.nulls, ret)


@register("substr")
def _substr(ret, a: StringColumn, start: Column, *rest):
    """substr(s, start[, length]): 1-based start, a negative start
    counts from the end; start 0, or a start beyond the length either
    way, gives ''."""
    w = a.chars.shape[1]
    lengths = a.lengths
    st0 = start.values.to(torch.int32)
    valid = (st0 != 0) & (st0.abs() <= lengths)
    st = torch.where(st0 < 0, lengths + st0, st0 - 1)  # 0-based
    st = torch.minimum(st.clamp(min=0), lengths)
    if rest:
        ln = rest[0].values.to(torch.int32).clamp(0, w)
    else:
        ln = lengths - st
    ln = torch.minimum(ln, lengths - st).clamp(0, w)
    ln = torch.where(valid, ln, 0)
    return _slice_rows(a, st, ln, _default_nulls(a, start, *rest[:1]), ret)


@register("concat")
def _concat(ret, *args: StringColumn):
    """The arguments' bytes end to end: the output is as wide as the
    widths together, the lengths add, and a NULL argument makes the row
    NULL. A constant argument is a broadcast one-row view
    (expr/compile.py), which the gathers read as it is."""
    out = args[0]
    for b in args[1:]:
        n, w = out.chars.shape[0], out.max_len + b.max_len
        pos = torch.arange(w, dtype=torch.int64,
                           device=out.chars.device)[None, :]
        l1 = out.lengths.to(torch.int64)[:, None]
        lens = out.lengths + b.lengths
        ca = torch.gather(out.chars, 1,
                          pos.clamp(max=out.max_len - 1).expand(n, w))
        cb = torch.gather(b.chars, 1, (pos - l1).clamp(0, b.max_len - 1))
        chars = torch.where(pos < l1, ca,
                            torch.where(pos < lens[:, None], cb, 0))
        out = StringColumn(chars.to(torch.uint8), lens,
                           _default_nulls(out, b), ret)
    return out


def _space_bounds(a: StringColumn):
    """(first non-space, last non-space, all spaces) per row; bytes past
    the length count as spaces."""
    w = a.chars.shape[1]
    is_sp = (a.chars == 32) | (_positions(a) >= a.lengths.to(
        torch.int64)[:, None])
    keep = (~is_sp).to(torch.uint8)
    first = torch.argmax(keep, dim=1)
    last = w - 1 - torch.argmax(keep.flip(1), dim=1)
    return first, last, is_sp.all(dim=1)


@register("trim")
def _trim(ret, a: StringColumn):
    first, last, blank = _space_bounds(a)
    st = torch.where(blank, 0, first)
    ln = torch.where(blank, 0, last - first + 1)
    return _slice_rows(a, st, ln, a.nulls, ret)


@register("ltrim")
def _ltrim(ret, a: StringColumn):
    first, _, blank = _space_bounds(a)
    st = torch.where(blank, 0, first)
    ln = torch.where(blank, 0, a.lengths.to(torch.int64) - st)
    return _slice_rows(a, st, ln, a.nulls, ret)


@register("rtrim")
def _rtrim(ret, a: StringColumn):
    _, last, blank = _space_bounds(a)
    ln = torch.where(blank, 0, last + 1)
    return _slice_rows(a, torch.zeros_like(ln), ln, a.nulls, ret)


@register("reverse")
def _reverse(ret, a: StringColumn):
    w = a.chars.shape[1]
    pos = _positions(a)
    idx = (a.lengths.to(torch.int64)[:, None] - 1 - pos).clamp(0, w - 1)
    out = torch.gather(a.chars, 1, idx)
    out = torch.where(pos < a.lengths.to(torch.int64)[:, None], out, 0)
    return StringColumn(out.to(torch.uint8), a.lengths, a.nulls, ret)


@register("chr")
def _chr(ret, a: Column):
    """One byte: the code point clamped to 0..255, as the reference."""
    v = _i64(a).clamp(0, 255).to(torch.uint8)[:, None]
    return StringColumn(v, torch.ones_like(v[:, 0], dtype=torch.int32),
                        a.nulls, ret)


@register("codepoint")
def _codepoint(ret, a: StringColumn):
    """The first byte, as the reference."""
    return _col(ret, a.chars[:, 0].to(_dt(ret)), a)


@register("starts_with")
def _starts_with(ret, a: StringColumn, b: StringColumn):
    L = b.max_len
    wa = pad_chars(a, L).chars if L > a.max_len else a.chars[:, :L]
    pos = torch.arange(L, dtype=torch.int64, device=a.chars.device)[None, :]
    cmp = (wa == b.chars) | (pos >= b.lengths.to(torch.int64)[:, None])
    v = cmp.all(dim=1) & (b.lengths <= a.lengths)
    return _col(ret, v, a, b)


@register("ends_with")
def _ends_with(ret, a: StringColumn, b: StringColumn):
    """The needle against each row's suffix window of b.max_len bytes
    (the haystack padded when the needles are wider)."""
    L = b.max_len
    chars = pad_chars(a, L).chars if L > a.max_len else a.chars
    w = chars.shape[1]
    starts = (a.lengths - b.lengths).to(torch.int64).clamp(0, w - 1)
    pos = torch.arange(L, dtype=torch.int64, device=chars.device)[None, :]
    window = torch.gather(chars, 1, (starts[:, None] + pos).clamp(0, w - 1))
    cmp = (window == b.chars[:, :L]) | (pos >= b.lengths.to(
        torch.int64)[:, None])
    v = cmp.all(dim=1) & (b.lengths <= a.lengths)
    return _col(ret, v, a, b)


@register("strpos")
def _strpos(ret, a: StringColumn, b: StringColumn):
    """1-based byte position of the first occurrence of b in a, 0 if
    absent. Memory: the (N, windows, L) window gather, as the reference
    builds it (about N x W x L bytes, and as many bools)."""
    n, w = a.chars.shape
    L = b.max_len
    if L > w:
        return _col(ret, torch.zeros(n, dtype=_dt(ret),
                                     device=a.chars.device), a, b)
    windows = w - L + 1
    dev = a.chars.device
    start = torch.arange(windows, dtype=torch.int64, device=dev)
    lane = torch.arange(L, dtype=torch.int64, device=dev)
    g = a.chars[:, start[:, None] + lane[None, :]]  # (N, windows, L)
    blen = b.lengths.to(torch.int64)
    match = ((g == b.chars[:, None, :]) |
             (lane[None, None, :] >= blen[:, None, None])).all(dim=2)
    ok = (start[None, :] + blen[:, None]) <= a.lengths.to(torch.int64)[:, None]
    m = match & ok
    first = torch.argmax(m.to(torch.uint8), dim=1)
    return _col(ret, torch.where(m.any(dim=1), first + 1, 0).to(_dt(ret)),
                a, b)


REGISTRY["position"] = REGISTRY["strpos"]


def split_part_kernel(a: StringColumn, delim: bytes, index: int,
                      ret: T.Type) -> StringColumn:
    """split_part(s, delim, n): the n-th (1-based) field, NULL past the
    last field. The delimiter is one constant byte and n a constant of
    at least 1, as the reference requires."""
    if len(delim) != 1:
        raise NotImplementedError("split_part delimiter must be 1 byte")
    if index < 1:
        raise ValueError("split_part index must be greater than zero")
    lens = a.lengths.to(torch.int64)
    in_str = _positions(a) < lens[:, None]
    is_d = (a.chars == delim[0]) & in_str
    field = torch.cumsum(is_d.to(torch.int64), dim=1) - is_d.to(torch.int64)
    sel = (field == index - 1) & ~is_d & in_str
    ln = sel.sum(dim=1)
    st = torch.argmax(sel.to(torch.uint8), dim=1)
    nfields = is_d.sum(dim=1) + 1
    return _slice_rows(a, st, ln, a.nulls | (index > nfields), ret)


# ---------------------------------------------------------------------------
# varbinary (bytes in the string layout)
# ---------------------------------------------------------------------------

def _hex_digit(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d < 10, d + ord("0"), d - 10 + ord("A"))


@register("to_hex")
def _to_hex(ret, a: StringColumn):
    n, w = a.chars.shape
    c = a.chars.to(torch.int64)
    chars = torch.stack([_hex_digit(c >> 4), _hex_digit(c & 0xF)],
                        dim=2).reshape(n, 2 * w)
    lens = a.lengths * 2
    pos = torch.arange(2 * w, dtype=torch.int64, device=c.device)[None, :]
    chars = torch.where(pos < lens.to(torch.int64)[:, None], chars, 0)
    return StringColumn(chars.to(torch.uint8), lens, a.nulls, ret)


@register("from_hex", null_fn=_own_nulls)
def _from_hex(ret, a: StringColumn):
    """Invalid hex (an odd length, a byte that is no hex digit) is NULL,
    as in the reference (Presto raises)."""
    n, w = a.chars.shape
    c = torch.nn.functional.pad(a.chars, (0, w % 2)).to(torch.int64)
    digit = torch.where(c >= ord("a"), c - ord("a") + 10,
                        torch.where(c >= ord("A"), c - ord("A") + 10,
                                    c - ord("0")))
    lanes = torch.arange(c.shape[1], dtype=torch.int64,
                         device=c.device)[None, :]
    lens = a.lengths.to(torch.int64)
    in_len = lanes < lens[:, None]
    ok = ((digit >= 0) & (digit <= 15)) | ~in_len
    invalid = (lens % 2 != 0) | ~ok.all(dim=1)
    pairs = digit.reshape(n, -1, 2)
    out_len = torch.where(invalid, 0, lens // 2)
    vals = (pairs[:, :, 0] * 16 + pairs[:, :, 1]) & 0xFF
    half = torch.arange(vals.shape[1], dtype=torch.int64,
                        device=c.device)[None, :]
    vals = torch.where(half < out_len[:, None], vals, 0)
    return StringColumn(vals.to(torch.uint8), out_len.to(torch.int32),
                        a.nulls | invalid, ret)


@register("to_utf8")
def _to_utf8(ret, a: StringColumn):
    return StringColumn(a.chars, a.lengths, a.nulls, ret)


@register("from_utf8")
def _from_utf8(ret, a: StringColumn):
    return StringColumn(a.chars, a.lengths, a.nulls, ret)


# ---------------------------------------------------------------------------
# casts
# ---------------------------------------------------------------------------

def _null_string(n: int, device, ret: T.Type) -> StringColumn:
    return StringColumn(torch.zeros((n, 1), dtype=torch.uint8, device=device),
                        torch.zeros(n, dtype=torch.int32, device=device),
                        torch.ones(n, dtype=torch.bool, device=device), ret)


def _cast_from128(ret, a: Int128Column):
    ft = a.type
    if ret.is_floating:
        f = a.hi.to(torch.float64) * float(2 ** 64) + _u64_to_f64(a.lo)
        return _col(ret, (f / _POW10[ft.scale]).to(_dt(ret)), a)
    if _is_long_decimal(ret):
        hi, lo = _rescale128(a.hi, a.lo, ft.scale, ret.scale)
        return Int128Column(hi, lo, a.nulls, ret)
    if ret.is_decimal or ret.is_integral:
        # narrow through the low lane: the values must fit, as in the
        # reference
        v = rescale_decimal(a.lo, ft.scale, _scale_of(ret))
        return _col(ret, v.to(_dt(ret)), a)
    raise NotImplementedError(f"cast long decimal -> {ret}")


@register("cast")
def _cast(ret, a):
    """The reference's casts: numeric pairs (long decimals exactly, now
    with the downscale the reference refuses: half away from zero),
    booleans onto numbers, date <-> timestamp <-> timestamp with time
    zone <-> time, varchar to varchar, typed NULLs; any other pair of
    fixed-width types reinterprets the lanes at the target's dtype, as
    the reference does. Varchar to anything else is refused, as in the
    reference."""
    ft = a.type
    if isinstance(a, Int128Column):
        return _cast_from128(ret, a)
    if isinstance(a, StringColumn) and not ret.is_string:
        raise NotImplementedError(
            "CAST(varchar AS numeric) needs the string-parse kernels, which "
            "the reference does not have either")
    if isinstance(a, StringColumn):
        return StringColumn(a.chars, a.lengths, a.nulls, ret)
    if ft == T.UNKNOWN and ret.is_string:
        return _null_string(len(a), a.nulls.device, ret)
    if ret.is_string:
        raise NotImplementedError(f"cast {ft} -> {ret}: the reference has "
                                  "no such cast")
    v = a.values
    dt = _dt(ret)
    if ft.is_decimal and ret.is_floating:
        return _col(ret, v.to(dt) / _POW10[ft.scale], a)
    if (ft.is_decimal or ft.is_integral) and _is_long_decimal(ret):
        hi, lo = I128.from_int64(v)
        hi, lo = _rescale128(hi, lo, _scale_of(ft), ret.scale)
        return Int128Column(hi, lo, a.nulls, ret)
    if ft.is_decimal and ret.is_decimal:
        return _col(ret, rescale_decimal(_i64(a), ft.scale, ret.scale), a)
    if ft.is_decimal and ret.is_integral:
        return _col(ret, rescale_decimal(_i64(a), ft.scale, 0).to(dt), a)
    if ft.is_integral and ret.is_decimal:
        return _col(ret, _i64(a) * _POW10[ret.scale], a)
    if ft.is_floating and ret.is_decimal:
        return _col(ret, torch.round(v * _POW10[ret.scale]).to(torch.int64),
                    a)
    if ft.is_floating and ret.is_integral:
        return _col(ret, torch.round(v).to(dt), a)
    if ft.base == "date" and ret.base == "timestamp":
        return _col(ret, _i64(a) * _DAY_US, a)
    if ft.base == _TZ_BASE and ret.base == "timestamp":
        return _col(ret, _as_local_micros(a), a)  # the local datetime
    if ft.base == _TZ_BASE and ret.base == "date":
        return _col(ret, _fdiv(_as_local_micros(a), _DAY_US).to(dt), a)
    if ft.base == _TZ_BASE and ret.base == "time":
        return _col(ret, _fmod(_as_local_micros(a), _DAY_US), a)
    if ft.base in ("timestamp", "date") and ret.base == _TZ_BASE:
        # a naive timestamp is a UTC instant (session zone UTC)
        return _col(ret, TZ.pack(_instant_micros(a), TZ.UTC_KEY), a)
    if ft.base == "timestamp" and ret.base == "time":
        return _col(ret, _fmod(_i64(a), _DAY_US), a)
    if ft.base == "timestamp" and ret.base == "date":
        return _col(ret, _fdiv(_i64(a), _DAY_US).to(dt), a)
    # plain widening/narrowing (booleans and typed NULLs among them)
    return _col(ret, v.to(dt), a)


@register("try_cast")
def _try_cast(ret, a):
    """CAST with an out-of-range integer result NULL instead of wrapped.
    Varchar to a number is refused, as in the reference."""
    if isinstance(a, StringColumn) and not ret.is_string:
        raise NotImplementedError(
            "TRY_CAST(varchar AS numeric) needs the string-parse kernels, "
            "which the reference does not have either")
    out = _cast(ret, a)
    ft = a.type
    if ret.is_integral and isinstance(a, Int128Column):
        lo_, hi_ = _int_range(ret)
        h, l = _rescale128(a.hi, a.lo, ft.scale, 0)
        fits64 = h == (l >> 63)
        oob = ~fits64 | (l < lo_) | (l > hi_)
        return Column(out.values, out.nulls | oob, ret)
    if ret.is_integral and (ft.is_integral or ft.is_decimal):
        lo_, hi_ = _int_range(ret)
        src = _i64(a)
        if ft.is_decimal:
            src = rescale_decimal(src, ft.scale, 0)
        return Column(out.values, out.nulls | (src < lo_) | (src > hi_), ret)
    if ret.is_integral and ft.is_floating:
        lo_, hi_ = _int_range(ret)
        v = a.values
        oob = (v < float(lo_)) | (v > float(hi_)) | torch.isnan(v)
        return Column(out.values, out.nulls | oob, ret)
    return out


def _int_range(ty: T.Type):
    info = np.iinfo(ty.to_dtype())
    return int(info.min), int(info.max)


# ---------------------------------------------------------------------------
# host-row kernels: JSON, regex capture and digests run per row on the
# host, as the reference runs them through jax.pure_callback. Each call
# copies its argument columns to the host (one sync) and moves the
# result back to their device.
# ---------------------------------------------------------------------------

def _host_values(block) -> list:
    """A block's rows as Python values on the host (strings as bytes),
    None for NULL."""
    nulls = block.nulls.cpu().numpy().tolist()
    if isinstance(block, StringColumn):
        chars = np.ascontiguousarray(block.chars.cpu().numpy())
        w = chars.shape[1]
        buf = chars.tobytes()
        vals = [buf[i * w:i * w + ln] for i, ln in
                enumerate(block.lengths.cpu().numpy().tolist())]
    else:
        vals = block.values.cpu().numpy().tolist()
    return [None if null else v for v, null in zip(vals, nulls)]


def _host_rows(py_fn, blocks):
    """py_fn over each row whose arguments are all non-NULL: yields (row,
    result). A row whose function raises is SQL NULL, as in the
    reference (the reference runs the same Python per row)."""
    for i, vals in enumerate(zip(*[_host_values(b) for b in blocks])):
        if None in vals:
            continue
        try:
            r = py_fn(*vals)
        except Exception:  # noqa: BLE001 - a row error is SQL NULL
            continue
        if r is not None:
            yield i, r


def host_string_kernel(py_fn, ret: T.Type, out_width: int,
                       *blocks) -> StringColumn:
    """py_fn(*row values) -> bytes | str | None per row, as a string
    column `out_width` bytes wide (a longer result raises, as in the
    reference)."""
    n = len(blocks[0])
    out_width = max(int(out_width), 1)
    out = [b""] * n
    nulls = np.ones(n, dtype=bool)
    for i, r in _host_rows(py_fn, blocks):
        if isinstance(r, str):
            r = r.encode("utf-8")
        if len(r) > out_width:
            raise ValueError(
                f"host kernel result exceeds static width {out_width}")
        out[i] = r
        nulls[i] = False
    lengths = np.fromiter(map(len, out), dtype=np.int32, count=n)
    chars = np.frombuffer(bytearray(b"".join(
        r.ljust(out_width, b"\0") for r in out)), dtype=np.uint8)
    dev = blocks[0].nulls.device
    return StringColumn(torch.from_numpy(chars.reshape(n, out_width)).to(dev),
                        torch.from_numpy(lengths).to(dev),
                        torch.from_numpy(nulls).to(dev), ret)


def host_scalar_kernel(py_fn, ret: T.Type, *blocks) -> Column:
    """py_fn(*row values) -> int | float | bool | None per row, as a
    fixed-width column."""
    n = len(blocks[0])
    values = np.zeros(n, dtype=ret.to_dtype())
    nulls = np.ones(n, dtype=bool)
    for i, r in _host_rows(py_fn, blocks):
        values[i] = r
        nulls[i] = False
    dev = blocks[0].nulls.device
    return Column(torch.from_numpy(values).to(dev),
                  torch.from_numpy(nulls).to(dev), ret)


# -- JSON ------------------------------------------------------------------

def _json_loads(doc: bytes):
    return _json.loads(doc.decode("utf-8"))


def _json_dumps(v) -> str:
    return _json.dumps(v, separators=(",", ":"), ensure_ascii=False)


_JSON_PATH_STEP = _re.compile(
    r"\.(\*|[A-Za-z_][A-Za-z_0-9]*)|\[\s*(\d+)\s*\]|\[\s*\"([^\"]*)\"\s*\]")


@functools.lru_cache(maxsize=64)
def _json_path_steps(path: bytes) -> tuple:
    """The reference's JsonPath subset: $, $.key, $["key"], $[idx],
    chained, as (kind, key or index) steps (parsed once per path)."""
    p = path.decode("utf-8").strip()
    if not p.startswith("$"):
        raise ValueError(f"bad json path {p!r}")
    pos = 1
    steps = []
    while pos < len(p):
        m = _JSON_PATH_STEP.match(p, pos)
        if m is None:
            raise ValueError(f"bad json path {p!r}")
        if m.group(1) is not None:
            steps.append(("key", m.group(1)))
        elif m.group(2) is not None:
            steps.append(("idx", int(m.group(2))))
        else:
            steps.append(("key", m.group(3)))
        pos = m.end()
    return tuple(steps)


def _json_path_get(v, path: bytes):
    """The value at `path` in the parsed document: (value, found)."""
    for kind, s in _json_path_steps(path):
        if kind == "key":
            if not isinstance(v, dict) or s not in v:
                return None, False
        elif not isinstance(v, list) or s >= len(v):
            return None, False
        v = v[s]
    return v, True


def _json_out_width(a: StringColumn) -> int:
    """Canonical JSON can be longer than its input ('1e2' -> '100.0',
    escapes): the reference's budget of 6x the input plus 16."""
    return 6 * a.max_len + 16


@register("json_parse", null_fn=_own_nulls)
def _json_parse(ret, a: StringColumn):
    return host_string_kernel(lambda d: _json_dumps(_json_loads(d)), ret,
                              _json_out_width(a), a)


@register("json_format", null_fn=_own_nulls)
def _json_format(ret, a: StringColumn):
    return host_string_kernel(lambda d: d, ret, a.max_len, a)


@register("json_extract", null_fn=_own_nulls)
def _json_extract(ret, a: StringColumn, p: StringColumn):
    def fn(doc, path):
        v, ok = _json_path_get(_json_loads(doc), path)
        return _json_dumps(v) if ok else None
    return host_string_kernel(fn, ret, _json_out_width(a), a, p)


@register("json_extract_scalar", null_fn=_own_nulls)
def _json_extract_scalar(ret, a: StringColumn, p: StringColumn):
    def fn(doc, path):
        v, ok = _json_path_get(_json_loads(doc), path)
        if not ok or isinstance(v, (dict, list)) or v is None:
            return None
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, float) and v == int(v):
            return _json_dumps(v)
        return str(v)
    return host_string_kernel(fn, ret, _json_out_width(a), a, p)


@register("json_array_length", null_fn=_own_nulls)
def _json_array_length(ret, a: StringColumn):
    def fn(doc):
        v = _json_loads(doc)
        return len(v) if isinstance(v, list) else None
    return host_scalar_kernel(fn, ret, a)


@register("json_size", null_fn=_own_nulls)
def _json_size(ret, a: StringColumn, p: StringColumn):
    def fn(doc, path):
        v, ok = _json_path_get(_json_loads(doc), path)
        if not ok:
            return None
        return len(v) if isinstance(v, (dict, list)) else 0
    return host_scalar_kernel(fn, ret, a, p)


@register("json_array_contains", null_fn=_own_nulls)
def _json_array_contains(ret, a: StringColumn, x):
    def fn(doc, needle):
        v = _json_loads(doc)
        if not isinstance(v, list):
            return None
        if isinstance(needle, bytes):
            return needle.decode("utf-8") in [e for e in v
                                              if isinstance(e, str)]
        if isinstance(needle, bool):
            return any(e is needle for e in v)
        # a numeric needle matches JSON numbers only (never booleans)
        return any(e == needle for e in v
                   if isinstance(e, (int, float)) and not isinstance(e, bool))
    return host_scalar_kernel(fn, ret, a, x)


@register("is_json_scalar", null_fn=_own_nulls)
def _is_json_scalar(ret, a: StringColumn):
    return host_scalar_kernel(
        lambda doc: not isinstance(_json_loads(doc), (dict, list)), ret, a)


# -- regex capture and replace (regexp_like has the device DFA) ----------

def _search(pat: bytes, s: bytes):
    return _re.search(pat.decode("utf-8"), s.decode("utf-8"))


@register("regexp_extract", null_fn=_own_nulls)
def _regexp_extract(ret, a: StringColumn, p: StringColumn, *group):
    """The first match (or its group), NULL without one."""
    def fn(s, pat, g=0):
        m = _search(pat, s)
        return None if m is None else m.group(int(g))
    return host_string_kernel(fn, ret, a.max_len, a, p, *group)


@register("regexp_position", null_fn=_own_nulls)
def _regexp_position(ret, a: StringColumn, p: StringColumn):
    def fn(s, pat):
        m = _search(pat, s)
        return -1 if m is None else m.start() + 1
    return host_scalar_kernel(fn, ret, a, p)


@register("regexp_count", null_fn=_own_nulls)
def _regexp_count(ret, a: StringColumn, p: StringColumn):
    def fn(s, pat):
        return sum(1 for _ in _re.finditer(pat.decode("utf-8"),
                                           s.decode("utf-8")))
    return host_scalar_kernel(fn, ret, a, p)


def regexp_replace(a: StringColumn, pattern: str, replacement: str,
                   ret: T.Type) -> StringColumn:
    """regexp_replace with a constant pattern and replacement (Presto's
    $g group references), the output at most len + 1 insertions of the
    replacement wide."""
    w = a.max_len
    width = max(w + (w + 1) * len(replacement.encode("utf-8")), 1)
    py_rep = _re.sub(r"\$(\d+)", r"\\\1", replacement)
    return host_string_kernel(
        lambda s: _re.sub(pattern, py_rep, s.decode("utf-8")), ret, width, a)


# -- digests -----------------------------------------------------------------

def _register_digest(name, width):
    @register(name, null_fn=_own_nulls)
    def _digest(ret, a: StringColumn, _n=name):
        return host_string_kernel(
            lambda data: getattr(hashlib, _n)(data).digest(), ret, width, a)
    return _digest


_register_digest("md5", 16)
_register_digest("sha1", 20)
_register_digest("sha256", 32)
_register_digest("sha512", 64)


@register("crc32", null_fn=_own_nulls)
def _crc32(ret, a: StringColumn):
    return host_scalar_kernel(zlib.crc32, ret, a)


# ---------------------------------------------------------------------------
# geospatial scalars over plain doubles
# ---------------------------------------------------------------------------

_EARTH_RADIUS_KM = 6371.01


@register("great_circle_distance")
def _great_circle_distance(ret, lat1, lon1, lat2, lon2):
    """Haversine distance in kilometres between two (lat, lon) points in
    degrees."""
    to_rad = math.pi / 180.0
    p1 = decimal_to_f64(lat1) * to_rad
    p2 = decimal_to_f64(lat2) * to_rad
    dphi = p2 - p1
    dlam = (decimal_to_f64(lon2) - decimal_to_f64(lon1)) * to_rad
    h = torch.sin(dphi / 2.0) ** 2 + \
        torch.cos(p1) * torch.cos(p2) * torch.sin(dlam / 2.0) ** 2
    d = 2.0 * _EARTH_RADIUS_KM * torch.asin(torch.sqrt(h.clamp(0.0, 1.0)))
    return _col(ret, d, lat1, lon1, lat2, lon2)


def _bing_xy(lat, lon, zoom):
    """(lat, lon, zoom) -> integer tile (x, y) lanes (the Bing tile
    system's Mercator mapping)."""
    lat = lat.clamp(-85.05112878, 85.05112878)
    lon = lon.clamp(-180.0, 180.0)
    sin_lat = torch.sin(lat * math.pi / 180.0)
    x_frac = (lon + 180.0) / 360.0
    y_frac = 0.5 - torch.log((1.0 + sin_lat) / (1.0 - sin_lat)) \
        / (4.0 * math.pi)
    size = (torch.ones_like(zoom) << zoom).to(torch.float64)
    tx = torch.minimum(torch.floor(x_frac * size).clamp(min=0), size - 1)
    ty = torch.minimum(torch.floor(y_frac * size).clamp(min=0), size - 1)
    return tx.to(torch.int64), ty.to(torch.int64)


def _bing_args(lat, lon, zoom):
    """Tile lanes, the zoom clamped to the system's 0..23, and the null
    mask: a zoom outside 0..23 is NULL (Presto raises)."""
    z = _i64(zoom)
    tx, ty = _bing_xy(decimal_to_f64(lat), decimal_to_f64(lon),
                      z.clamp(0, 23))
    return tx, ty, z.clamp(0, 23), \
        _default_nulls(lat, lon, zoom) | (z < 0) | (z > 23)


@register("bing_tile_x", null_fn=_own_nulls)
def _bing_tile_x(ret, lat, lon, zoom):
    tx, _, _, nulls = _bing_args(lat, lon, zoom)
    return Column(tx, nulls, ret)


@register("bing_tile_y", null_fn=_own_nulls)
def _bing_tile_y(ret, lat, lon, zoom):
    _, ty, _, nulls = _bing_args(lat, lon, zoom)
    return Column(ty, nulls, ret)


@register("bing_tile_quadkey_at", null_fn=_own_nulls)
def _bing_tile_quadkey_at(ret, lat, lon, zoom):
    """The quadkey of the tile holding (lat, lon) at `zoom`: digit i
    reads bit z-1-i of x and y."""
    tx, ty, z, nulls = _bing_args(lat, lon, zoom)
    digits = []
    for i in range(23):
        bit = z - 1 - i
        b = bit.clamp(0, 62)
        d = ((tx >> b) & 1) | (((ty >> b) & 1) << 1)
        digits.append(torch.where(bit >= 0, d + ord("0"), 0))
    return StringColumn(torch.stack(digits, dim=1).to(torch.uint8),
                        z.to(torch.int32), nulls, ret)


# ---------------------------------------------------------------------------
# substring search
# ---------------------------------------------------------------------------

def contains_pattern(a: StringColumn, needle: bytes) -> torch.Tensor:
    """(N,) bool: `needle` occurs in the row (LIKE '%needle%'), through
    the contains_bytes kernel (ops/kernels.py) for CUDA tensors. Nulls
    are not looked at. An empty needle matches every row, as the kernel
    of the reference does; the reference's XLA form answers False for an
    empty row there."""
    return K.contains_bytes(a.chars, a.lengths, needle)


# ---------------------------------------------------------------------------
# hashing: splitmix64 over int64 bit patterns
# ---------------------------------------------------------------------------

def _u64_const(u: int) -> int:
    """The int64 bit pattern of an unsigned 64-bit constant."""
    return u - (1 << 64) if u >= 1 << 63 else u


# the reference's uint64 constants; add and multiply wrap the same way
# in int64, and a right shift is logical only through int128._lshr
GOLD = _u64_const(0x9E3779B97F4A7C15)
_H1 = _u64_const(0xBF58476D1CE4E5B9)
_H2 = _u64_const(0x94D049BB133111EB)


def mix64(z: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer of z + GOLD, bit for bit the reference's
    uint64 `_mix64`."""
    z = z + GOLD
    z = (z ^ I128._lshr(z, 30)) * _H1
    z = (z ^ I128._lshr(z, 27)) * _H2
    return z ^ I128._lshr(z, 31)


def hash64_block(b: Block) -> torch.Tensor:
    """Per-row 64-bit hash of a block as int64 bit patterns, NULL rows
    GOLD: long decimals mix hi then lo; strings mix their little-endian
    8-byte words up to their length, then the length (so the hash does
    not depend on the column's width); fixed-width lanes mix the value
    (a double's bits, -0.0 as 0.0)."""
    if isinstance(b, Int128Column):
        h = mix64(mix64(b.hi) ^ b.lo)
    elif isinstance(b, StringColumn):
        n, w = b.chars.shape
        padded = torch.nn.functional.pad(b.chars, (0, (-w) % 8))
        chunks = padded.reshape(n, -1, 8).to(torch.int64)
        shifts = 8 * torch.arange(8, dtype=torch.int64, device=chunks.device)
        # the shifted bytes occupy disjoint bits: the sum is their or
        packed = (chunks << shifts).sum(dim=2)
        h = torch.zeros(n, dtype=torch.int64, device=chunks.device)
        lengths = b.lengths.to(torch.int64)
        for i in range(packed.shape[1]):
            h = torch.where(i * 8 < lengths, mix64(h ^ packed[:, i]), h)
        h = mix64(h ^ lengths)
    else:
        v = b.values
        if v.is_floating_point():
            f = v.to(torch.float64)
            f = torch.where(f == 0.0, 0.0, f)
            f = torch.where(torch.isnan(f), float("nan"), f)
            v = f.view(torch.int64)
        h = mix64(v.to(torch.int64))
    return torch.where(b.nulls, GOLD, h)


def combine_hash(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """The reference's combine of two row hashes, bit for bit: mix64 of
    h1 ^ (h2 + GOLD + (h1 << 6) + (h1 >>> 2)), wrapping as uint64 does."""
    return mix64(h1 ^ (h2 + GOLD + (h1 << 6) + I128._lshr(h1, 2)))


def decimal_to_f64(b: Column) -> torch.Tensor:
    """A numeric column's lanes as float64, decimals unscaled."""
    f = b.values.to(torch.float64)
    if b.type.is_decimal:
        f = f / _POW10[b.type.scale]
    return f


# ---------------------------------------------------------------------------
# arrays, maps and rows (fixed-fanout (N, K) layouts, block.py)
# ---------------------------------------------------------------------------

def _arr_in_range(a) -> torch.Tensor:
    """(N, K): lane j lies inside row i's array or map."""
    lanes = torch.arange(a.max_cardinality, dtype=torch.int32,
                         device=a.lengths.device)
    return lanes[None, :] < a.lengths[:, None]


def _first(hit: torch.Tensor) -> torch.Tensor:
    """The first True lane of each row (0 where there is none)."""
    return torch.argmax(hit.to(torch.uint8), dim=1)


@register("cardinality")
def _cardinality(ret, a):
    return Column(a.lengths.to(_dt(ret)), a.nulls, ret)


@register("element_at")
def _element_at(ret, a, idx: Column):
    """element_at(array, i): 1-based, a negative i counts from the end,
    out of range is NULL; the index is read as int32, as the reference
    does. element_at(map, key): the value at the key, else NULL."""
    rows = torch.arange(len(a), device=a.nulls.device)
    if isinstance(a, MapColumn):
        hit = _arr_in_range(a) & (a.keys == idx.values[:, None])
        j = _first(hit)
        return Column(a.values[rows, j],
                      a.nulls | idx.nulls | ~hit.any(dim=1)
                      | a.value_nulls[rows, j], ret)
    i0 = idx.values.to(torch.int32)
    pos = torch.where(i0 < 0, a.lengths + i0, i0 - 1)
    oob = (pos < 0) | (pos >= a.lengths) | (i0 == 0)
    pc = pos.clamp(0, a.max_cardinality - 1).to(torch.int64)
    return Column(a.elements[rows, pc],
                  a.nulls | idx.nulls | oob | a.elem_nulls[rows, pc], ret)


@register("row_pack")
def _row_pack(ret, *fields):
    """Columns packed into one ROW column."""
    return RowColumn(tuple(fields), torch.zeros_like(fields[0].nulls), ret)


@register("row_field")
def _row_field(ret, r, idx: Column):
    """0-based field access; a NULL row nulls the field. `evaluate`
    takes the index from the plan; here it is the column's first lane."""
    return gather_block(r.field(int(idx.values[0])),
                        torch.arange(len(r), device=r.nulls.device), ~r.nulls)


@register("map_keys")
def _map_keys(ret, m):
    return ArrayColumn(m.keys, torch.zeros_like(m.value_nulls), m.lengths,
                       m.nulls, ret)


@register("map_values")
def _map_values(ret, m):
    return ArrayColumn(m.values, m.value_nulls, m.lengths, m.nulls, ret)


@register("contains")
def _contains(ret, a, x: Column):
    """TRUE on a match; else NULL if the array holds a NULL."""
    in_len = _arr_in_range(a)
    found = ((a.elements == x.values[:, None]) & ~a.elem_nulls
             & in_len).any(dim=1)
    saw_null = (a.elem_nulls & in_len).any(dim=1)
    nulls = a.nulls | x.nulls | (~found & saw_null)
    return Column(found & ~nulls, nulls, ret)


def _array_extreme(ret, a, largest: bool):
    """array_max/array_min over the non-NULL elements; NULL for a NULL,
    empty or all-NULL array. Integer lanes widen to int64 first, so
    the identity (the int64 extreme) fits."""
    live = _arr_in_range(a) & ~a.elem_nulls
    v = a.elements
    if v.is_floating_point():
        ident = -math.inf if largest else math.inf
    else:
        v = v.to(torch.int64)
        info = torch.iinfo(torch.int64)
        ident = info.min if largest else info.max
    v = torch.where(live, v, ident)
    m = v.amax(dim=1) if largest else v.amin(dim=1)
    if v.is_floating_point():
        # XLA orders -0.0 below 0.0; torch keeps the first of the two
        signed = live & (v == 0) & (torch.signbit(v) != largest)
        m = torch.where((m == 0) & signed.any(dim=1),
                        0.0 if largest else -0.0, m)
    return Column(m.to(_dt(ret)), a.nulls | ~live.any(dim=1), ret)


@register("array_max")
def _array_max(ret, a):
    return _array_extreme(ret, a, True)


@register("array_min")
def _array_min(ret, a):
    return _array_extreme(ret, a, False)


@register("array_position")
def _array_position(ret, a, x: Column):
    """1-based index of the first element equal to x; 0 if absent."""
    hit = _arr_in_range(a) & ~a.elem_nulls & (a.elements == x.values[:, None])
    return _col(ret, torch.where(hit.any(dim=1), _first(hit) + 1, 0), a, x)


@register("array_sum")
def _array_sum(ret, a):
    """The sum of the non-NULL elements: 0 plus each lane in order, the
    order of the reference's XLA reduction, which with one lane drops
    the 0 (so a lone -0.0 stays -0.0)."""
    live = _arr_in_range(a) & ~a.elem_nulls
    dt = torch.float64 if ret.is_floating else torch.int64
    v = torch.where(live, a.elements.to(dt), 0)
    if v.shape[1] == 1:
        return _col(ret, v[:, 0], a)
    s = torch.zeros(len(a), dtype=dt, device=v.device)
    for j in range(v.shape[1]):
        s = s + v[:, j]
    return _col(ret, s, a)


def _take(t: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    return torch.gather(t, 1, order)


@register("array_sort")
def _array_sort(ret, a):
    """Ascending per row, NULL elements after the values and the lanes
    past the length last: two stable sorts, by value then by that
    class."""
    in_range = _arr_in_range(a)
    dead = ~in_range | a.elem_nulls
    v = a.elements
    top = math.inf if v.is_floating_point() else torch.iinfo(v.dtype).max
    cls = torch.where(in_range & ~a.elem_nulls, 0,
                      torch.where(in_range, 1, 2))
    o1 = torch.argsort(torch.where(dead, top, v), dim=1, stable=True)
    o2 = torch.argsort(_take(cls, o1), dim=1, stable=True)
    order = _take(o1, o2)
    return ArrayColumn(_take(v, order), _take(a.elem_nulls, order),
                       a.lengths, a.nulls, ret)


@register("array_distinct")
def _array_distinct(ret, a):
    """The first occurrence of each element (NULL counts once; NaN
    equals nothing, so each NaN stays)."""
    in_range = _arr_in_range(a)
    v, en = a.elements, a.elem_nulls
    eq = (v[:, :, None] == v[:, None, :]) & ~en[:, :, None] & ~en[:, None, :]
    same = (eq | (en[:, :, None] & en[:, None, :])) \
        & in_range[:, :, None] & in_range[:, None, :]
    k = a.max_cardinality
    earlier = torch.tril(torch.ones((k, k), dtype=torch.bool,
                                    device=v.device), diagonal=-1)
    keep = in_range & ~(same & earlier[None]).any(dim=2)
    order = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)
    return ArrayColumn(_take(v, order), _take(en, order),
                       keep.sum(dim=1).to(a.lengths.dtype), a.nulls, ret)


@register("slice")
def _array_slice(ret, a, start: Column, length: Column):
    """slice(arr, start, length): 1-based start, a negative start counts
    from the end. Start 0 gives NULL, as in the reference (Presto
    raises)."""
    k = a.max_cardinality
    lens = a.lengths.to(torch.int64)
    s = start.values.to(torch.int64)
    s0 = torch.where(s > 0, s - 1, lens + s)  # 0-based start
    cnt = length.values.to(torch.int64).clamp(min=0)
    s0c = s0.clamp(0, k)
    new_len = torch.where(s0 < 0, 0,
                          torch.minimum(cnt, lens - s0c).clamp(min=0))
    lanes = torch.arange(k, dtype=torch.int64, device=s.device)
    idx = (s0c[:, None] + lanes[None, :]).clamp(0, k - 1)
    nulls = _default_nulls(a, start, length) | (s == 0)
    return ArrayColumn(_take(a.elements, idx), _take(a.elem_nulls, idx),
                       new_len.to(a.lengths.dtype), nulls, ret)
