"""The port's LEFT, RIGHT and FULL hash_join against presto_tpu's.

The same numpy inputs, made from a seed, are staged by presto_tpu.block
and presto_tpu_torch.block (on the CPU) and joined by both packages'
hash_join. Rows must be equal exactly, as multisets (the reference's
build sort does not fix the order of equal keys), and so must the row
count and the overflow flag.
"""

import numpy as np
import pytest
import torch

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
import jax.numpy as jnp
from presto_tpu import block as RB
from presto_tpu import types as RT
from presto_tpu.ops import join as RJ

from presto_tpu_torch import block as PB
from presto_tpu_torch import types as PT
from presto_tpu_torch.ops import join as PJ

OUTER = ["left", "right", "full"]
WORDS = ["", "a", "abcdefgh", "abcdefghi", "zz", "BUILDING", "BUILDINGS",
         "héllo"]
I64_MAX, I64_MIN = (1 << 63) - 1, -(1 << 63)


def _strings(rng, n, null_rate=0.15):
    s = np.array([WORDS[i] for i in rng.integers(0, len(WORDS), n)],
                 dtype=object)
    s[rng.random(n) < null_rate] = None
    return s


def _stage(sigs, arrays, nulls, capacity, inactive=()):
    """One side staged by both packages; `inactive` rows switched off."""
    nm = [m if m is not None else (np.array([v is None for v in a])
                                   if a.dtype == object else None)
          for a, m in zip(arrays, nulls)]
    rb = RB.batch_from_numpy([RT.parse_type(s) for s in sigs], arrays,
                             nulls=nm, capacity=capacity)
    pb = PB.batch_from_numpy([PT.parse_type(s) for s in sigs], arrays,
                             nulls=nm, capacity=capacity, device="cpu")
    act = np.asarray(rb.active).copy()
    act[list(inactive)] = False
    return rb.with_active(jnp.asarray(act)), pb.with_active(
        torch.from_numpy(act))


def _side(rng, kind, n, lo, hi, live=None, inactive_share=0.1,
          extremes=False):
    """Key columns of `kind`, then a decimal(38, 2) and a varchar
    payload; `live` rows (n by default) of an n + 8 capacity."""
    live = n if live is None else live
    if kind == "bigint":
        k = rng.integers(lo, hi, live).astype(np.int64)
        if extremes:
            k[rng.integers(0, live, max(live // 5, 1))] = I64_MAX
            k[rng.integers(0, live, max(live // 7, 1))] = I64_MIN
        keys, sigs = [k], ["bigint"]
        nulls = [rng.random(live) < 0.1]
    elif kind == "varchar":
        keys, sigs, nulls = [_strings(rng, live)], ["varchar(12)"], [None]
    else:  # an integer and a varchar
        keys = [rng.integers(lo % 4, 4, live).astype(np.int64),
                _strings(rng, live)]
        sigs, nulls = ["bigint", "varchar(12)"], [None, None]
    big = np.array([(1 << 90) + i if i % 9 else None for i in range(live)],
                   dtype=object)
    inactive = rng.integers(0, max(live, 1),
                            int(live * inactive_share)) if live else ()
    staged = _stage(sigs + ["decimal(38, 2)", "varchar(12)"],
                    keys + [big, _strings(rng, live)],
                    nulls + [None, None], n + 8, inactive)
    return staged, list(range(len(keys)))


def _rows(batch, to_numpy):
    act = batch.active.numpy() if isinstance(batch.active, torch.Tensor) \
        else np.asarray(batch.active)
    cols = [to_numpy(c) for c in batch.columns]
    return sorted((tuple(None if m[i] else
                         (v[i].item() if isinstance(v[i], np.generic)
                          else v[i]) for v, m in cols)
                   for i in np.flatnonzero(act)),
                  key=lambda r: tuple((x is None, str(type(x)),
                                       x if x is not None else 0)
                                      for x in r))


def _check(probe, build, pk, bk, join_type, capacity):
    (rp, pp), (rb, pb) = probe, build
    outs = [len(pb.columns) - 2, len(pb.columns) - 1]
    r = RJ.hash_join(rp, rb, pk, bk, capacity, join_type, outs)
    p = PJ.hash_join(pp, pb, pk, bk, capacity, join_type, outs)
    assert int(p.num_rows) == int(r.num_rows)
    assert bool(p.overflow) == bool(r.overflow)
    got, want = _rows(p.batch, PB.to_numpy), _rows(r.batch, RB.to_numpy)
    assert got == want
    return int(p.num_rows), bool(p.overflow), got


@pytest.mark.parametrize("join_type", OUTER)
@pytest.mark.parametrize("kind", ["bigint", "varchar", "int_and_varchar"])
def test_outer_join_matches_reference(kind, join_type):
    """Duplicate keys on both sides, NULL keys on each side, inactive
    rows, unmatched rows on both sides; one-word keys, multi-word
    string keys and a two-column key."""
    rng = np.random.default_rng(17)
    probe, pk = _side(rng, kind, 200, 0, 40)
    build, bk = _side(rng, kind, 90, 25, 70)
    n, overflow, rows = _check(probe, build, pk, bk, join_type, 4096)
    assert not overflow and n > 0
    # some output rows carry NULL on the outer side's far columns
    assert any(r[-1] is None and r[-2] is None for r in rows)


@pytest.mark.parametrize("join_type", OUTER)
@pytest.mark.parametrize("case", ["empty_build", "inactive_build",
                                  "inactive_probe"])
def test_outer_join_with_an_empty_side(case, join_type):
    rng = np.random.default_rng(5)
    probe, pk = _side(rng, "bigint", 60, 0, 20,
                      inactive_share=1.0 if case == "inactive_probe" else 0)
    build, bk = _side(rng, "bigint", 30, 0, 20,
                      live=0 if case == "empty_build" else None,
                      inactive_share=1.0 if case == "inactive_build" else 0)
    if case == "inactive_probe" or case == "inactive_build":
        # every row switched off, whatever the random picks left on
        side = probe if case == "inactive_probe" else build
        off = np.zeros(side[1].capacity, dtype=bool)
        side = (side[0].with_active(jnp.asarray(off)),
                side[1].with_active(torch.from_numpy(off)))
        probe, build = (side, build) if case == "inactive_probe" \
            else (probe, side)
    _check(probe, build, pk, bk, join_type, 256)


@pytest.mark.parametrize("join_type", ["inner"] + OUTER)
def test_outer_join_on_int64_extremes(join_type):
    """INT64_MAX is the sort sentinel of unusable rows in both probes
    (forward and reverse): a key equal to it must match only a real
    key, never a NULL or inactive row."""
    rng = np.random.default_rng(23)
    probe, pk = _side(rng, "bigint", 120, -3, 3, extremes=True)
    build, bk = _side(rng, "bigint", 50, -2, 5, extremes=True)
    n, _, rows = _check(probe, build, pk, bk, join_type, 8192)
    assert n > 0


@pytest.mark.parametrize("join_type", OUTER)
def test_outer_join_flags_overflow(join_type):
    rng = np.random.default_rng(3)
    probe, pk = _side(rng, "bigint", 200, 0, 30)
    build, bk = _side(rng, "bigint", 90, 10, 50)
    n, overflow, _ = _check(probe, build, pk, bk, join_type, 64)
    assert overflow and n > 64
