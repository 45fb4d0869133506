"""Shared inputs and comparisons of the tests of the nested half of the
port (tests/test_torch_nested_*.py, test_torch_lambdas.py,
test_torch_unnest.py): one seeded batch of arrays, maps, rows and
scalar columns staged by both packages at a given fanout K, and a
comparison of two results, nested values included, that is exact:
doubles are compared by their bits (float.hex), NaN as NaN."""

import functools

import numpy as np

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
from presto_tpu import block as RB
from presto_tpu import types as RT
from presto_tpu.expr import call, const, input_ref, special  # noqa: F401
from presto_tpu.expr import compile as RC
from presto_tpu.expr import ir as RIR

from presto_tpu_torch import block as PB
from presto_tpu_torch import types as PT
from presto_tpu_torch.expr import compile as PC
from presto_tpu_torch.expr import ir as PIR

N = 48
KS = (1, 2, 3, 5, 8)
SPECIAL = [0.0, -0.0, float("nan"), float("inf"), -float("inf"), 1.5, -2.5]

# name -> (signature, physical dtype or None)
COLUMNS = [
    ("arr", "array(bigint)", None),
    ("darr", "array(double)", None),
    ("iarr", "array(integer)", None),
    ("map", "map(bigint,bigint)", None),
    ("dmap", "map(bigint,double)", None),
    ("row", "row(bigint,varchar(4))", None),
    ("idx", "bigint", None),
    ("x", "bigint", None),
    ("dx", "double", None),
    ("narrow", "integer", "int8"),
    ("wide", "bigint", "int16"),
    ("len", "bigint", None),
]
SIGS = [c[1] for c in COLUMNS]
CH = {c[0]: i for i, c in enumerate(COLUMNS)}


def _maybe_none(rng, v, share):
    return None if rng.random() < share else v


def _arrays(rng, k, make):
    out = np.empty(N, dtype=object)
    for i in range(N):
        if rng.random() < 0.1:
            out[i] = None
            continue
        n = int(rng.integers(0, k + 1))
        out[i] = [_maybe_none(rng, make(), 0.15) for _ in range(n)]
    out[0] = None
    out[1] = []
    out[2] = [None] * k
    return out


def _maps(rng, k, make):
    out = np.empty(N, dtype=object)
    for i in range(N):
        if rng.random() < 0.1:
            out[i] = None
            continue
        n = int(rng.integers(0, k + 1))
        keys = rng.choice(np.arange(-4, 10), n, replace=False)
        out[i] = {int(kk): _maybe_none(rng, make(), 0.15) for kk in keys}
    out[0] = None
    out[1] = {}
    return out


def _values(rng, name, k):
    if name == "arr":
        return _arrays(rng, k, lambda: int(rng.integers(-5, 6)))
    if name == "darr":
        return _arrays(rng, k, lambda: SPECIAL[rng.integers(0, 7)]
                       if rng.random() < 0.4 else float(rng.integers(-4, 5)))
    if name == "iarr":
        pool = [0, 1, -1, 2 ** 31 - 1, -2 ** 31, 7, -7]
        return _arrays(rng, k, lambda: pool[rng.integers(0, len(pool))])
    if name == "map":
        return _maps(rng, k, lambda: int(rng.integers(-100, 100)))
    if name == "dmap":
        return _maps(rng, k, lambda: SPECIAL[rng.integers(0, 7)])
    if name == "row":
        out = np.empty(N, dtype=object)
        for i in range(N):
            out[i] = None if rng.random() < 0.15 else (
                _maybe_none(rng, int(rng.integers(-50, 50)), 0.2),
                _maybe_none(rng, ["", "ab", "xyz", "abcd"][
                    rng.integers(0, 4)], 0.2))
        return out
    if name == "idx":
        v = rng.integers(-10, 11, N).astype(np.int64)
        v[:6] = [0, 1, -1, (1 << 32) + 1, -(1 << 32) + 2, k]
        return v
    if name in ("x", "len"):
        return rng.integers(-5, 6, N).astype(np.int64)
    if name == "dx":
        return np.array([SPECIAL[i] for i in rng.integers(0, 7, N)])
    if name == "narrow":
        return rng.integers(-3, 9, N).astype(np.int32)
    if name == "wide":
        return rng.integers(-300, 300, N).astype(np.int64)
    raise KeyError(name)


@functools.lru_cache(maxsize=8)
def batches(seed=0, k=4):
    """(reference batch, port batch) of the same seeded columns with
    arrays and maps of up to `k` entries, a tenth of the scalars NULL,
    and 8 slots of padding."""
    rng = np.random.default_rng(seed * 100 + k)
    arrays, nulls = [], []
    for name, sig, _ in COLUMNS:
        v = _values(rng, name, k)
        arrays.append(v)
        nulls.append(np.array([x is None for x in v]) if v.dtype == object
                     else rng.random(N) < 0.1)
    phys = [c[2] for c in COLUMNS]
    cap = N + 8
    rb = RB.batch_from_numpy([RT.parse_type(s) for s in SIGS], arrays,
                             nulls=nulls, capacity=cap,
                             physical_dtypes=phys)
    pb = PB.batch_from_numpy([PT.parse_type(s) for s in SIGS], arrays,
                             nulls=nulls, capacity=cap,
                             physical_dtypes=phys, device="cpu")
    return rb, pb


def ref(name):
    """The reference's input reference to a column by its name."""
    return input_ref(CH[name], RT.parse_type(SIGS[CH[name]]))


def ty(sig):
    return RT.parse_type(sig)


def port_expr(expr):
    """The port's reading of a reference expression, through its JSON."""
    return PIR.from_json(RIR.to_json(expr))


def canon(v):
    """A fetched value in a comparable form: doubles as float.hex, maps
    as their [key, value] entries in order, tuples as lists."""
    if v is None:
        return None
    if isinstance(v, (float, np.floating)):
        return float(v).hex()
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, dict):
        return [[canon(a), canon(b)] for a, b in v.items()]
    if isinstance(v, (list, tuple)):
        return [canon(x) for x in v]
    return v


def assert_same_block(ref_block, port_block):
    """NULLs equal, and every non-NULL value equal exactly (nested
    values entry by entry, doubles bit for bit)."""
    rv, rn = RB.to_numpy(ref_block)
    pv, pn = PB.to_numpy(port_block)
    rn, pn = np.asarray(rn), np.asarray(pn)
    np.testing.assert_array_equal(pn, rn)
    live = np.flatnonzero(~rn)
    want = [canon(rv[i]) for i in live]
    got = [canon(pv[i]) for i in live]
    assert got == want


def check(expr, seed=0, k=4):
    """Evaluate the reference expression in both packages over the
    seeded batch and hold the results equal."""
    rb, pb = batches(seed, k)
    r = RC.evaluate(expr, rb)
    p = PC.evaluate(port_expr(expr), pb)
    assert_same_block(r, p)
    return r, p
