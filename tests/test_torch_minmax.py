"""The port's min/max aggregates against presto_tpu's, in both group-by
modes: the small-table path (max_groups <= 64) and the sorted
large-table path.

The same columns, made from a seed with numpy, are staged by both
packages: an int lane narrowed to int16, a short decimal, long decimals
near +-2^127 (Int128 lanes), a date, a double and a varchar. One group
key has only NULL values, some rows are inactive, and the keys hold a
NULL. Group tables must be equal exactly, NULL for a group with no
live input.
"""

import numpy as np
import pytest
import torch

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
import jax.numpy as jnp
from presto_tpu import block as RB
from presto_tpu import types as RT
from presto_tpu.ops import aggregation as RA

from presto_tpu_torch import block as PB
from presto_tpu_torch import types as PT
from presto_tpu_torch.ops import aggregation as PA

N = 600
I127 = (1 << 127) - 1
SIGS = ["bigint", "integer", "decimal(12, 2)", "decimal(38, 2)", "date",
        "double", "varchar(10)"]
PHYS = [None, "int16", None, None, None, None, None]
WORDS = ["", "a", "ab", "abcdefghij", "abcdefghi", "zz", "BUILDING",
         "héllo"]


def _stage(seed, groups):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, groups, N).astype(np.int64)
    key_nulls = rng.random(N) < 0.03
    ints = rng.integers(-30000, 30000, N).astype(np.int32)
    dec = rng.integers(-10 ** 9, 10 ** 9, N).astype(np.int64)
    pool = [I127, -I127, I127 - 1, -I127 + 1, (1 << 64) - 1, -(1 << 64),
            0, -1, 1 << 63, -(1 << 63) - 1]
    big = np.array([pool[i] for i in rng.integers(0, len(pool), N)],
                   dtype=object)
    days = rng.integers(-20000, 20000, N).astype(np.int32)
    dbl = rng.normal(0, 1e6, N)
    s = np.array([WORDS[i] for i in rng.integers(0, len(WORDS), N)],
                 dtype=object)
    arrays = [key, ints, dec, big, days, dbl, s]
    nulls = [key_nulls] + [rng.random(N) < 0.2 for _ in arrays[1:]]
    all_null = key == 3  # group 3: every value NULL
    for m in nulls[1:]:
        m[all_null] = True
    for a, m in zip(arrays, nulls):
        if a.dtype == object:
            a[m] = None
    cap = N + 8
    rb = RB.batch_from_numpy([RT.parse_type(t) for t in SIGS], arrays,
                             nulls=nulls, capacity=cap,
                             physical_dtypes=PHYS)
    pb = PB.batch_from_numpy([PT.parse_type(t) for t in SIGS], arrays,
                             nulls=nulls, capacity=cap,
                             physical_dtypes=PHYS, device="cpu")
    act = np.asarray(rb.active).copy()
    act[rng.integers(0, N, 40)] = False
    return (rb.with_active(jnp.asarray(act)),
            pb.with_active(torch.from_numpy(act)))


def _specs(Spec, T):
    out = []
    for ch, sig in enumerate(SIGS[1:], start=1):
        ty = T.parse_type(sig)
        out += [Spec("min", ch, ty), Spec("max", ch, ty)]
    return out + [Spec("count", 1, T.BIGINT)]


def _rows(batch, to_numpy, active):
    act = np.asarray(active)
    cols = []
    for c in batch.columns:
        v, m = to_numpy(c)
        cols.append([None if bool(mm) else (vv.item() if isinstance(
            vv, np.generic) else vv) for vv, mm in zip(v[act], m[act])])
    return list(zip(*cols))


def _group_by(rb, pb, keys, max_groups):
    raggs, paggs = _specs(RA.AggSpec, RT), _specs(PA.AggSpec, PT)
    r = RA.group_by(rb, keys, raggs, max_groups)
    p = PA.group_by(pb, keys, paggs, max_groups)
    assert int(r.num_groups) == int(p.num_groups)
    assert bool(r.overflow) == bool(p.overflow) is False
    rf = RA.finalize_states(r.batch, len(keys), raggs)
    pf = PA.finalize_states(p.batch, len(keys), paggs)
    return (_rows(rf, RB.to_numpy, rf.active),
            _rows(pf, PB.to_numpy, pf.active.numpy()))


def _sort_key(row):
    return tuple((v is None, str(v)) for v in row)


@pytest.mark.parametrize("seed", [0, 1])
def test_small_table_min_max_matches_reference(seed, monkeypatch):
    """max_groups 16: the same groups in the same first-occurrence
    order."""
    monkeypatch.setenv("PRESTO_TPU_SMALLG", "einsum")
    rb, pb = _stage(seed, groups=8)
    want, got = _group_by(rb, pb, [0], 16)
    assert got == want
    g3 = [r for r in got if r[0] == 3]
    assert g3 and all(v is None for v in g3[0][1:-1]) and g3[0][-1] == 0
    # the extremes of the long decimals reach +-(2^127 - 1)
    assert {max(r[6] for r in got if r[6] is not None),
            min(r[5] for r in got if r[5] is not None)} == {I127, -I127}


@pytest.mark.parametrize("seed", [0, 1])
def test_sorted_min_max_matches_reference(seed):
    """max_groups 256 over ~200 keys: the port's sorted path against
    the reference (whose long-decimal and varchar extremes take its
    hash path), the same groups as a set."""
    rb, pb = _stage(seed, groups=200)
    want, got = _group_by(rb, pb, [0], 256)
    assert len(got) > 100
    assert sorted(got, key=_sort_key) == sorted(want, key=_sort_key)


def test_sorted_min_max_reruns_on_overflow():
    """Too small a table flags overflow in both packages."""
    rb, pb = _stage(2, groups=200)
    spec_r = [RA.AggSpec("max", 3, RT.decimal(38, 2))]
    spec_p = [PA.AggSpec("max", 3, PT.decimal(38, 2))]
    r = RA.group_by(rb, [0], spec_r, 128)
    p = PA.group_by(pb, [0], spec_p, 128)
    assert bool(r.overflow) and bool(p.overflow)
    assert int(r.num_groups) == int(p.num_groups) > 128


@pytest.mark.parametrize("live", ["some", "none"])
def test_global_min_max_matches_reference(live):
    """Keyless: one group, NULL over zero live rows."""
    rb, pb = _stage(3, groups=8)
    if live == "none":
        rb = rb.with_active(jnp.zeros_like(rb.active))
        pb = pb.with_active(torch.zeros_like(pb.active))
    want, got = _group_by(rb, pb, [], 1 << 16)
    assert got == want and len(got) == 1
    if live == "none":
        assert got[0][:-1] == (None,) * (len(got[0]) - 1)
