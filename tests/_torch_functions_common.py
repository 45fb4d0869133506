"""Shared inputs and comparisons of the tests/test_torch_functions*.py
files: one seeded batch staged by both packages, an expression built
with the reference's IR and read by the port through its JSON, and the
two results compared exactly or within a stated tolerance."""

import functools

import numpy as np

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
from presto_tpu import block as RB
from presto_tpu import types as RT
from presto_tpu.expr import call, const, input_ref  # noqa: F401
from presto_tpu.expr import compile as RC
from presto_tpu.expr import ir as RIR

from presto_tpu_torch import block as PB
from presto_tpu_torch import types as PT
from presto_tpu_torch.expr import compile as PC
from presto_tpu_torch.expr import ir as PIR

N = 160
# held within 1e-12 * max(1, |want|): XLA's CPU math, torch's CPU math
# and CUDA's libdevice may differ in the last bit; everything else is
# held exactly
TRANSCENDENTAL = ("exp", "ln", "log2", "log10", "log", "power", "pow",
                  "cbrt", "sin", "cos", "tan", "asin", "acos", "atan",
                  "sinh", "cosh", "tanh", "atan2", "great_circle_distance",
                  "bing_tile_x", "bing_tile_y", "bing_tile_quadkey_at")
REL = 1e-12
I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1
DAY_US = 86_400_000_000
WORDS = ["", "a", "Hello World", "  padded  ", "   ", "MiXeD cAsE 9",
         "abcdefghijkl", "the quick-brown", "x-y-z", "a,b,,c", "héllo",
         "ends with ly", "the", "tab\tsep", "0123456789"]
HEXES = ["", "4142", "abcdef", "ABC", "zz", "0", "00ff", "DeadBeef",
         "123g", "7f80"]
DOCS = ['{"a": {"b": [1, 42, 7]}, "s": "x"}', "[1, 2, 3]", "[]", "42",
        '"str"', "true", "null", "{nope", '{"a": 1.5e2, "b": [true]}',
        '[1, "2", 3.0, false]', '{"k": {"k": {"k": "deep"}}}', ""]
ZONES = [2048, 2048 + 330, 2048 - 480, 2048 - 300, 2048 + 60, 2048 + 345]
DAYS = [0, -1, 1, 59, 60, 365, 10957, 11016, 11017, 18321, -719162,
        2932896, 30, 31, -365, 19723, 10956, 11322, 46]

# channel -> (signature, maker(rng) -> values); NULLs are drawn apart
COLUMNS = [
    ("bigint", "ext"), ("bigint", "small"), ("double", "dbl"),
    ("decimal(12, 2)", "short"), ("decimal(38, 4)", "long"),
    ("varchar(16)", "words"), ("date", "date"), ("timestamp", "ts"),
    ("timestamp with time zone", "tz"), ("integer", "int32"),
    ("boolean", "bool"), ("varchar(8)", "hex"), ("double", "pos"),
    ("interval day to second", "ds"), ("interval year to month", "ym"),
    ("varchar(48)", "docs"), ("time", "time"), ("bigint", "div"),
    ("double", "lat"), ("double", "lon"), ("bigint", "zoom"),
    ("varchar(4)", "needle"), ("decimal(12, 4)", "short4"),
]
SIGS = [c[0] for c in COLUMNS]
CH = {c[1]: i for i, c in enumerate(COLUMNS)}


def _values(rng, kind):
    n = N
    if kind == "ext":
        v = rng.integers(-10 ** 6, 10 ** 6, n).astype(np.int64)
        v[:8] = [0, -1, 1, I64_MIN, I64_MAX, I64_MIN + 1, -7, 7]
        v[8:16] = rng.integers(I64_MIN, I64_MAX, 8, dtype=np.int64)
        return v
    if kind == "small":
        v = rng.integers(-3, 70, n).astype(np.int64)
        v[:6] = [0, 1, 63, 64, -1, 2]
        return v
    if kind == "div":
        return rng.choice(np.array([-7, -3, -2, 0, 1, 2, 3, 5, 7, 10, 1000],
                                   np.int64), n)
    if kind == "dbl":
        v = rng.normal(0.0, 40.0, n)
        v[:12] = [0.0, -0.0, 0.5, -0.5, 1.5, 2.5, -2.5, np.nan, np.inf,
                  -np.inf, 1e300, -1e-300]
        v[12:20] = np.round(v[12:20])
        return v
    if kind == "pos":
        v = rng.uniform(0.01, 0.99, n)
        v[:4] = [0.5, 0.25, 1e-9, 0.75]
        return v
    if kind == "short":
        v = rng.integers(-10 ** 6, 10 ** 6, n).astype(np.int64)
        v[:8] = [0, 5, -5, 15, -15, 149, -150, 99999999]
        return v
    if kind == "short4":
        v = rng.integers(-10 ** 9, 10 ** 9, n).astype(np.int64)
        v[:6] = [0, 5000, -5000, 15, -15, 49999]
        return v
    if kind == "long":
        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = int(rng.integers(-10 ** 9, 10 ** 9)) * \
                int(rng.integers(1, 10 ** 9)) * (10 ** int(rng.integers(0, 12)))
        out[:6] = [0, 5, -5, 12345, -12355, 10 ** 37 + 5]
        return out
    if kind in ("words", "hex", "docs", "needle"):
        pool = {"words": WORDS, "hex": HEXES, "docs": DOCS,
                "needle": ["", "e", "the", "ly", "-", " ", "zz", "abcd"]}[kind]
        return np.array([pool[i] for i in rng.integers(0, len(pool), n)],
                        dtype=object)
    if kind == "date":
        v = rng.integers(-100_000, 100_000, n).astype(np.int32)
        v[:len(DAYS)] = DAYS
        return v
    if kind == "ts":
        v = rng.integers(-2 * 10 ** 15, 2 * 10 ** 15, n).astype(np.int64)
        v[:len(DAYS)] = np.array(DAYS, np.int64) * DAY_US + \
            rng.integers(0, DAY_US, len(DAYS))
        v[:3] = [0, -1, DAY_US - 1]
        return v
    if kind == "tz":
        us = rng.integers(-10 ** 15, 10 ** 15, n).astype(np.int64)
        us[:3] = [0, -1, -DAY_US]
        keys = rng.choice(np.array(ZONES, np.int64), n)
        return (us << 12) | keys
    if kind == "int32":
        v = rng.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32)
        v[:3] = [0, -2 ** 31, 2 ** 31 - 1]
        return v
    if kind == "bool":
        return rng.random(n) < 0.5
    if kind == "ds":
        return rng.integers(-400 * DAY_US, 400 * DAY_US, n).astype(np.int64)
    if kind == "ym":
        return rng.integers(-40, 40, n).astype(np.int64)
    if kind == "time":
        return rng.integers(0, DAY_US, n).astype(np.int64)
    if kind == "lat":
        v = rng.uniform(-89.0, 89.0, n)
        v[:2] = [0.0, 85.2]
        return v
    if kind == "lon":
        v = rng.uniform(-180.0, 180.0, n)
        v[:2] = [0.0, 180.0]
        return v
    if kind == "zoom":
        v = rng.integers(0, 24, n).astype(np.int64)
        v[:3] = [-1, 24, 0]
        return v
    raise KeyError(kind)


@functools.lru_cache(maxsize=2)
def batches(seed=0):
    """(reference batch, port batch) of the same seeded columns, with
    about a tenth of each NULL and 8 slots of padding."""
    rng = np.random.default_rng(seed)
    arrays, nulls = [], []
    for _sig, kind in COLUMNS:
        arrays.append(_values(rng, kind))
        nulls.append(rng.random(N) < 0.1)
    cap = N + 8
    rb = RB.batch_from_numpy([RT.parse_type(s) for s in SIGS], arrays,
                             nulls=nulls, capacity=cap)
    pb = PB.batch_from_numpy([PT.parse_type(s) for s in SIGS], arrays,
                             nulls=nulls, capacity=cap, device="cpu")
    return rb, pb


def ref(kind):
    """The reference's input reference to a column by its kind."""
    return input_ref(CH[kind], RT.parse_type(SIGS[CH[kind]]))


def ty(sig):
    return RT.parse_type(sig)


def port_expr(expr):
    """The port's reading of a reference expression, through its JSON."""
    return PIR.from_json(RIR.to_json(expr))


def evaluate_both(expr, batch_pair):
    rb, pb = batch_pair
    return RC.evaluate(expr, rb), PC.evaluate(port_expr(expr), pb)


def assert_same(ref_block, port_block, rel=None):
    """NULLs equal, and every live value equal: bit for bit (doubles
    too, NaN as NaN), or within rel * max(1, |want|) when `rel` is
    given. A string result must also keep zeros past each length."""
    rv, rn = RB.to_numpy(ref_block)
    pv, pn = PB.to_numpy(port_block)
    rn, pn = np.asarray(rn), np.asarray(pn)
    np.testing.assert_array_equal(pn, rn)
    live = ~rn
    if isinstance(port_block, PB.StringColumn):
        chars = port_block.chars.numpy()
        lengths = port_block.lengths.numpy()
        pos = np.arange(chars.shape[1])[None, :]
        assert not chars[pos >= lengths[:, None]].any(), \
            "chars past the length are not zero"
    want = np.asarray(rv)[live]
    got = np.asarray(pv)[live]
    if rv.dtype == object or rv.dtype.kind in "biu":
        assert got.tolist() == want.tolist()
        return
    want = want.astype(np.float64)
    got = got.astype(np.float64)
    if rel is None:
        same = (got == want) | (np.isnan(got) & np.isnan(want))
        bad = np.flatnonzero(~same)
        assert not bad.size, (got[bad[:5]], want[bad[:5]])
        # -0.0 and 0.0 are told apart (a NaN's sign carries nothing)
        num = ~np.isnan(want)
        np.testing.assert_array_equal(np.signbit(got[num]),
                                      np.signbit(want[num]))
        return
    both_nan = np.isnan(got) & np.isnan(want)
    same_inf = np.isinf(want) & (got == want)
    tol = rel * np.maximum(1.0, np.abs(want))
    with np.errstate(invalid="ignore"):
        close = both_nan | same_inf | (np.abs(got - want) <= tol)
    bad = np.flatnonzero(~close)
    assert not bad.size, (got[bad[:5]], want[bad[:5]])


def check(expr, rel=None, seed=0):
    r, p = evaluate_both(expr, batches(seed))
    assert_same(r, p, rel)
    return r, p
