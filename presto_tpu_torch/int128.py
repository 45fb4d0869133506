"""128-bit integer lanes for long decimals, on int64 tensors.

Counterpart of presto_tpu/int128.py. A value is (hi, lo) = hi * 2^64 +
lo in two's complement. The reference keeps `lo` as uint64; torch has
no unsigned 64-bit shifts, compares or adds, so here `lo` (and every
other "unsigned" word) is the int64 tensor with the same bits:

* wrapping add, subtract, multiply, xor, and, or and left shift give
  the same bits signed or unsigned;
* a logical right shift is an arithmetic shift plus a mask (`_lshr`);
* an unsigned compare is a signed compare after flipping the sign bit
  (`_ult`, `_uge`).

SUM never adds 128-bit values row by row: values split into 13-bit
limbs whose exact int64 totals recombine once per group
(combine_limb_totals_128; ops/aggregation.py).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["add128", "shl128_const", "from_int64", "neg128",
           "combine_limb_totals_128", "limbs_of_i64", "limbs13_of_i64",
           "limbs13_of_128", "div128_by_count", "mulu64_wide",
           "mul_i64_i64_128", "mul128_by_u64", "mul128", "divmod128_by_u64",
           "rescale128_up", "cmp128", "int128_to_python",
           "python_to_int128", "INT64_MIN", "INT64_MAX"]

INT64_MIN = -(1 << 63)
INT64_MAX = (1 << 63) - 1
_M32 = 0xFFFFFFFF


def _lshr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of an int64 bit pattern by 0 <= k < 64."""
    if k == 0:
        return x
    return (x >> k) & ((1 << (64 - k)) - 1)


def _ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a < b on int64 bit patterns."""
    return (a ^ INT64_MIN) < (b ^ INT64_MIN)


def _uge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a ^ INT64_MIN) >= (b ^ INT64_MIN)


def from_int64(v: torch.Tensor):
    """Sign-extend int64 lanes to (hi, lo)."""
    v = v.to(torch.int64)
    return v >> 63, v


def add128(ah, al, bh, bl):
    """(ah, al) + (bh, bl) with carry; wraps at 2^128."""
    lo = al + bl
    carry = _ult(lo, al).to(torch.int64)
    return ah + bh + carry, lo


def neg128(h, l):
    """Two's-complement negate."""
    nl = (~l) + 1
    borrow = (nl == 0).to(torch.int64)
    return (~h) + borrow, nl


def shl128_const(v, s: int):
    """(hi, lo) of int64 lanes `v` shifted left by the static amount s
    (0 <= s < 128), sign-extended first."""
    if s == 0:
        return from_int64(v)
    if s < 64:
        return v >> (64 - s), v << s
    return v << (s - 64), torch.zeros_like(v)


def combine_limb_totals_128(totals: torch.Tensor, limb_bits: int = 13):
    """(..., L) exact per-limb int64 totals -> (hi, lo) of
    sum_l totals[..., l] * 2^(limb_bits * l)."""
    hi = torch.zeros(totals.shape[:-1], dtype=torch.int64,
                     device=totals.device)
    lo = torch.zeros_like(hi)
    for l in range(totals.shape[-1]):
        th, tl = shl128_const(totals[..., l], limb_bits * l)
        hi, lo = add128(hi, lo, th, tl)
    return hi, lo


def limbs_of_i64(v: torch.Tensor, limb_bits: int, nlimbs: int):
    """Split int64 values into `nlimbs` limbs of `limb_bits` bits, low
    first; low limbs unsigned, the last one the signed remainder."""
    mask = (1 << limb_bits) - 1
    out = []
    rem = v.to(torch.int64)
    for _ in range(nlimbs - 1):
        out.append(rem & mask)
        rem = rem >> limb_bits
    out.append(rem)
    return out


def limbs13_of_i64(v: torch.Tensor, nlimbs: int = 5):
    return limbs_of_i64(v, 13, nlimbs)


def limbs13_of_128(hi, lo, nlimbs: int = 10):
    """Split (hi, lo) into `nlimbs` 13-bit limbs, low first, the last
    the signed remainder. 10 limbs cover decimal(38)."""
    out = []
    chi, clo = hi, lo
    for _ in range(nlimbs - 1):
        out.append(clo & 0x1FFF)
        clo = _lshr(clo, 13) | (chi << 51)
        chi = chi >> 13
    out.append(clo | (chi << 51))
    return out


def div128_by_count(hi, lo, count, round_half_up: bool = True):
    """(hi, lo) / count -> int64, rounding half away from zero. `count`
    is a positive int64 < 2^47; quotients beyond int64 saturate."""
    neg = hi < 0
    mh, ml = neg128(hi, lo)
    mh = torch.where(neg, mh, hi)
    ml = torch.where(neg, ml, lo)
    d = torch.clamp(count.to(torch.int64), min=1)
    limbs = [(mh >> (16 * k)) & 0xFFFF for k in range(3, -1, -1)]
    limbs += [(ml >> (16 * k)) & 0xFFFF for k in range(3, -1, -1)]
    q = torch.zeros_like(d)
    rem = torch.zeros_like(d)
    overflow = torch.zeros(d.shape, dtype=torch.bool, device=d.device)
    for limb in limbs:
        cur = (rem << 16) | limb
        ql = torch.div(cur, d, rounding_mode="trunc")  # cur >= 0
        rem = cur - ql * d
        overflow = overflow | (q > (INT64_MAX >> 16))
        q = (q << 16) | ql
    if round_half_up:
        q = q + (2 * rem >= d).to(torch.int64)
    q = torch.where(overflow, INT64_MAX, q)
    return torch.where(neg, -q, q)


def mulu64_wide(a, b):
    """Unsigned 64x64 -> 128 multiply (bit patterns) via 32-bit halves."""
    a0, a1 = a & _M32, _lshr(a, 32)
    b0, b1 = b & _M32, _lshr(b, 32)
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = _lshr(p00, 32) + (p01 & _M32) + (p10 & _M32)
    hi = p11 + _lshr(p01, 32) + _lshr(p10, 32) + _lshr(mid, 32)
    lo = (mid << 32) | (p00 & _M32)
    return hi, lo


def mul_i64_i64_128(a, b):
    """Signed 64x64 -> exact signed 128 product (hi, lo)."""
    a = a.to(torch.int64)
    b = b.to(torch.int64)
    hi_u, lo = mulu64_wide(a, b)
    corr = torch.where(a < 0, b, 0) + torch.where(b < 0, a, 0)
    return hi_u - corr, lo


def mul128_by_u64(hi, lo, m):
    """(hi, lo) * m for a non-negative multiplier m < 2^63; wraps beyond
    127 bits like the rest of the lane math."""
    mt = torch.full_like(lo, m) if isinstance(m, int) else m.to(torch.int64)
    ph, pl = mulu64_wide(lo, mt)
    return hi * mt + ph, pl


def mul128(ah, al, bh, bl):
    """Full 128x128 product modulo 2^128."""
    wh, wl = mulu64_wide(al, bl)
    return wh + ah * bl + al * bh, wl


def divmod128_by_u64(hi, lo, d):
    """Binary long division of the non-negative (hi, lo) by the divisor
    lanes d (1 <= d < 2^63): 128 shift-subtract steps. Returns
    (qhi, qlo, rem)."""
    du = d.to(torch.int64)
    qhi = torch.zeros_like(lo)
    qlo = torch.zeros_like(lo)
    rem = torch.zeros_like(lo)
    for i in range(127, -1, -1):
        bit = ((hi >> (i - 64)) if i >= 64 else (lo >> i)) & 1
        rem = (rem << 1) | bit
        ge = _uge(rem, du)
        rem = torch.where(ge, rem - du, rem)
        if i >= 64:
            qhi = qhi | (ge.to(torch.int64) << (i - 64))
        else:
            qlo = qlo | (ge.to(torch.int64) << i)
    return qhi, qlo, rem


def rescale128_up(hi, lo, factor: int):
    """Multiply by the integer factor 10^k (upscale only: exact)."""
    h, l = hi, lo
    while factor > (1 << 62):
        h, l = mul128_by_u64(h, l, 10 ** 18)
        factor //= 10 ** 18
    return mul128_by_u64(h, l, factor)


def cmp128(ah, al, bh, bl):
    """Signed comparison: returns (lt, eq) bool lanes."""
    lt = (ah < bh) | ((ah == bh) & _ult(al, bl))
    eq = (ah == bh) & (al == bl)
    return lt, eq


def int128_to_python(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Host: (hi, lo) int64 numpy arrays -> object array of Python ints."""
    lo_u = np.asarray(lo).view(np.uint64)
    out = np.empty(hi.shape[0], dtype=object)
    for i in range(hi.shape[0]):
        out[i] = int(hi[i]) * (1 << 64) + int(lo_u[i])
    return out


def python_to_int128(values) -> tuple:
    """Host: iterable of Python ints (None -> 0) -> (hi, lo) int64 arrays
    (`lo` as the bit pattern of the unsigned low word)."""
    n = len(values)
    hi = np.zeros(n, dtype=np.int64)
    lo = np.zeros(n, dtype=np.uint64)
    for i, v in enumerate(values):
        if v is None:
            continue
        v = int(v)
        lo[i] = np.uint64(v & ((1 << 64) - 1))
        hi[i] = np.int64(v >> 64)
    return hi, lo.view(np.int64)
