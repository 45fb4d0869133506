"""Scalar function registry: the functions the ported TPC-H queries
reach.

Counterpart of presto_tpu/expr/functions.py, trimmed to comparisons of
integers, dates, decimals and strings, decimal add/subtract/multiply/
divide (and divide to double), `negate` and `abs`, the casts onto
decimals, `not`, `year`, `substr`, `upper`, `concat`, and the
substring search `contains_pattern`. A function is a name plus an
implementation `(ret_type, *blocks) -> Block`; the compiler computes the
default null mask (OR of argument nulls) and a function only overrides
it through `null_fn`.

Decimal rules are Presto's: add/subtract rescale to the result scale,
multiply adds scales, divide rescales the dividend and rounds half away
from zero. Short decimals (precision <= 18) are int64 lanes; long
decimals compute in exact 128-bit (hi, lo) lanes (int128.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Union

import torch

from .. import int128 as I128
from .. import types as T
from ..block import (Column, Int128Column, StringColumn, pad_chars,
                     torch_dtype)
from ..ops import kernels as K

Block = Union[Column, StringColumn, Int128Column]

__all__ = ["ScalarFunction", "REGISTRY", "register", "lookup",
           "rescale_decimal", "contains_pattern", "GOLD", "mix64",
           "hash64_block", "decimal_to_f64"]


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
            f"scalar function {name!r} is not ported yet (ROADMAP queue 1 "
            "item 10: breadth)") from None


def _default_nulls(*blocks: Block):
    nulls = None
    for b in blocks:
        nulls = b.nulls if nulls is None else (nulls | b.nulls)
    return nulls


def _col(ret_type: T.Type, values, *args: Block) -> Column:
    return Column(values, _default_nulls(*args), ret_type)


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


def _any128(*blocks) -> bool:
    return any(isinstance(b, Int128Column) for b in blocks)


def _needs128(ret: T.Type, *blocks) -> bool:
    """A long-decimal result or any 128-bit argument takes the exact
    128-bit path."""
    return (ret.is_decimal and not ret.is_short_decimal) or _any128(*blocks)


def _as128(b) -> tuple:
    """(hi, lo) lanes of a numeric block at its own scale."""
    if isinstance(b, Int128Column):
        return b.hi, b.lo
    return I128.from_int64(b.values)


def _as128_at_scale(b, to_scale: int) -> tuple:
    s = _scale_of(b.type)
    hi, lo = _as128(b)
    if to_scale > s:
        hi, lo = I128.rescale128_up(hi, lo, 10 ** (to_scale - s))
    elif to_scale < s:
        raise NotImplementedError("long-decimal downscale (ROADMAP queue 1 "
                                  "item 10: breadth)")
    return hi, lo


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
    """Bring numeric args to the ret_type's representation: decimals to
    the result's scale as int64 lanes, or everything to float64 for a
    floating result."""
    out = []
    for b in blocks:
        if ret_type.is_floating:
            if ret_type != T.DOUBLE:
                raise NotImplementedError(
                    f"{ret_type} arithmetic is not ported yet (ROADMAP "
                    "queue 1 item 10: breadth)")
            if isinstance(b, Int128Column):
                out.append(_int128_to_f64(b))
            elif b.type.is_decimal:
                out.append(b.values.to(torch.float64) / _POW10[b.type.scale])
            else:
                out.append(b.values.to(torch.float64))
            continue
        if isinstance(b, Int128Column):
            raise NotImplementedError(
                f"long-decimal lanes cannot promote to {ret_type} (ROADMAP "
                "queue 1 item 10: breadth)")
        if b.type.is_floating:
            raise NotImplementedError(
                f"floating-point arithmetic ({b.type} -> {ret_type}) is not "
                "ported yet (ROADMAP queue 1 item 10: breadth)")
        v = b.values.to(torch.int64)
        if ret_type.is_decimal:
            v = rescale_decimal(v, _scale_of(b.type), ret_type.scale)
        elif b.type.is_decimal:
            v = rescale_decimal(v, b.type.scale, 0)
        out.append(v)
    return out


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
        return _col(ret, a.values.to(torch.int64) * b.values.to(torch.int64),
                    a, b)
    x, y = _promote(ret, a, b)
    return _col(ret, x * y, a, b)


def _widened(ret: T.Type, a: Column) -> torch.Tensor:
    """A narrow-lane column's values at the result's own dtype."""
    return a.values.to(torch_dtype(ret.to_dtype()))


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
    kernel cannot)."""
    nulls = _div_nulls(ret, a, b)
    if ret.is_decimal and (_needs128(ret, a, b) or
                           _scale_of(b.type) + ret.scale - _scale_of(a.type)
                           > 18):
        return _divide128(ret, a, b, nulls)
    if ret.is_floating:
        x, y = _promote(ret, a, b)
        return Column(x / torch.where(y == 0, 1.0, y), nulls, ret)
    if not ret.is_decimal:
        raise NotImplementedError(
            f"{ret} division is not ported yet (ROADMAP queue 1 item 10: "
            "breadth)")
    sa, sb = _scale_of(a.type), _scale_of(b.type)
    num = a.values.to(torch.int64) * _POW10[ret.scale + sb - sa]
    den = torch.where(b.values == 0, 1, b.values.to(torch.int64))
    neg = (num < 0) != (den < 0)
    an, ad = num.abs(), den.abs()
    q = (2 * an + ad) // (2 * ad)
    return Column(torch.where(neg, -q, q), nulls, ret)


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
        bv = b.values.to(torch.int64)
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


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def _cmp_values(a: Block, b: Block):
    """Comparable lanes of two fixed-width operands: fixed-point ones as
    int64 at one scale; with a floating operand, both as float64
    (decimals unscaled)."""
    if any(x.type.base in ("timestamp", "timestamp with time zone")
           for x in (a, b)):
        raise NotImplementedError(
            f"comparing {a.type} with {b.type} is not ported yet (ROADMAP "
            "queue 1 item 10: breadth)")
    sa, sb = _scale_of(a.type), _scale_of(b.type)
    if a.type.is_floating or b.type.is_floating:
        va = a.values.to(torch.float64)
        vb = b.values.to(torch.float64)
        if a.type.is_decimal:
            va = va / _POW10[sa]
        if b.type.is_decimal:
            vb = vb / _POW10[sb]
        return va, vb
    s = max(sa, sb)
    return (rescale_decimal(a.values.to(torch.int64), sa, s),
            rescale_decimal(b.values.to(torch.int64), sb, s))


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
                f"comparing {a.type} with {b.type} is not ported yet "
                "(ROADMAP queue 1 item 10: breadth)")
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


# ---------------------------------------------------------------------------
# dates (DATE = days since epoch, TIMESTAMP = micros since epoch)
# ---------------------------------------------------------------------------

def _fdiv(a, b):
    """int64 floor division (a negative day number rounds down)."""
    return torch.div(a, b, rounding_mode="floor")


def _civil(days):
    """(year, month, day) of days since epoch: Howard Hinnant's
    civil_from_days, vectorized."""
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


def _as_days(a: Column):
    if a.type.base == "timestamp":
        return _fdiv(a.values.to(torch.int64), 86_400_000_000)
    if a.type.base != "date":
        raise NotImplementedError(
            f"date parts of {a.type} are not ported yet (ROADMAP queue 1 "
            "item 10: breadth)")
    return a.values


@register("year")
def _year(ret, a):
    y, _, _ = _civil(_as_days(a))
    return _col(ret, y.to(torch_dtype(ret.to_dtype())), a)


# ---------------------------------------------------------------------------
# strings
# ---------------------------------------------------------------------------

@register("substr")
def _substr(ret, a: StringColumn, start: Column, *rest):
    """substr(s, start[, length]): 1-based start, a negative start
    counts from the end; start 0, or a start beyond the length either
    way, gives ''."""
    n, w = a.chars.shape
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
    pos = torch.arange(w, dtype=torch.int32, device=a.chars.device)[None, :]
    idx = (st[:, None] + pos).clamp(0, w - 1).to(torch.int64)
    gathered = torch.gather(a.chars, 1, idx)
    out = torch.where(pos < ln[:, None], gathered, 0).to(torch.uint8)
    return StringColumn(out, ln, _default_nulls(a, start, *rest[:1]), ret)


@register("upper")
def _upper(ret, a: StringColumn):
    """ASCII upper case over the padded bytes; lengths are unchanged."""
    c = a.chars
    return StringColumn(torch.where((c >= 97) & (c <= 122), c - 32, c),
                        a.lengths, a.nulls, ret)


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


# ---------------------------------------------------------------------------
# casts
# ---------------------------------------------------------------------------

@register("cast")
def _cast(ret, a):
    """The reference's numeric casts: long decimals to double (hi * 2^64
    + lo, as the reference converts), to long decimals (upscale) and to
    short decimals or integers (through the low lane); decimals and
    integers onto each other, decimals to double, doubles rounded onto
    decimals and integers, booleans and NULL literals onto numbers;
    varchar to varchar. Date and time casts are not ported."""
    ft = a.type
    if isinstance(a, Int128Column):
        if ret.is_floating:
            f = a.hi.to(torch.float64) * float(2 ** 64) + _u64_to_f64(a.lo)
            return _col(ret, f / _POW10[ft.scale], a)
        if ret.is_decimal and not ret.is_short_decimal:
            if ret.scale < ft.scale:
                raise NotImplementedError("long-decimal downscale cast "
                                          "(ROADMAP queue 1 item 10: "
                                          "breadth)")
            hi, lo = I128.rescale128_up(a.hi, a.lo,
                                        10 ** (ret.scale - ft.scale))
            return Int128Column(hi, lo, a.nulls, ret)
        if ret.is_decimal or ret.is_integral:
            v = rescale_decimal(a.lo, ft.scale, _scale_of(ret))
            return _col(ret, v.to(torch_dtype(ret.to_dtype())), a)
        raise NotImplementedError(f"cast {ft} -> {ret} is not ported yet "
                                  "(ROADMAP queue 1 item 10: breadth)")
    if isinstance(a, StringColumn) and ret.is_string:
        return StringColumn(a.chars, a.lengths, a.nulls, ret)
    if ft == T.UNKNOWN and ret.is_string:
        # a typed NULL literal: a string column of NULLs
        n = len(a)
        return StringColumn(
            torch.zeros((n, 1), dtype=torch.uint8, device=a.nulls.device),
            torch.zeros(n, dtype=torch.int32, device=a.nulls.device),
            torch.ones_like(a.nulls), ret)
    if isinstance(a, StringColumn) or not ret.is_numeric or not (
            ft.is_numeric or ft.base in ("boolean", "unknown")):
        raise NotImplementedError(
            f"cast {ft} -> {ret} is not ported yet (ROADMAP queue 1 item "
            "10: breadth)")
    dt = torch_dtype(ret.to_dtype())
    v = a.values
    if ft.is_decimal and ret.is_floating:
        return _col(ret, v.to(dt) / _POW10[ft.scale], a)
    if (ft.is_decimal or ft.is_integral) and ret.is_decimal and \
            not ret.is_short_decimal:
        # widen onto int128 lanes, then rescale exactly
        src_scale = _scale_of(ft)
        hi, lo = I128.from_int64(v)
        if ret.scale > src_scale:
            hi, lo = I128.rescale128_up(hi, lo, 10 ** (ret.scale - src_scale))
        elif ret.scale < src_scale:
            raise NotImplementedError("long-decimal downscale cast (ROADMAP "
                                      "queue 1 item 10: breadth)")
        return Int128Column(hi, lo, a.nulls, ret)
    if ft.is_decimal and ret.is_decimal:
        return _col(ret, rescale_decimal(v.to(torch.int64), ft.scale,
                                         ret.scale), a)
    if ft.is_decimal and ret.is_integral:
        return _col(ret, rescale_decimal(v.to(torch.int64), ft.scale,
                                         0).to(dt), a)
    if ft.is_integral and ret.is_decimal:
        return _col(ret, v.to(torch.int64) * _POW10[ret.scale], a)
    if ft.is_floating and ret.is_decimal:
        return _col(ret, torch.round(v * _POW10[ret.scale]).to(torch.int64),
                    a)
    if ft.is_floating and ret.is_integral:
        return _col(ret, torch.round(v).to(dt), a)
    # plain numeric widening/narrowing (booleans to numbers among them)
    return _col(ret, v.to(dt), a)


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

def _i64(u: int) -> int:
    """The int64 bit pattern of an unsigned 64-bit constant."""
    return u - (1 << 64) if u >= 1 << 63 else u


# the reference's uint64 constants; add and multiply wrap the same way
# in int64, and a right shift is logical only through int128._lshr
GOLD = _i64(0x9E3779B97F4A7C15)
_H1 = _i64(0xBF58476D1CE4E5B9)
_H2 = _i64(0x94D049BB133111EB)


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


def decimal_to_f64(b: Column) -> torch.Tensor:
    """A numeric column's lanes as float64, decimals unscaled."""
    f = b.values.to(torch.float64)
    if b.type.is_decimal:
        f = f / _POW10[b.type.scale]
    return f
