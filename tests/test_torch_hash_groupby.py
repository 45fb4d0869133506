"""The port's hash-slot group-by, its hashes and the whole aggregate
library of presto_tpu/ops/aggregation.py::_AGGS against presto_tpu, on
the same numpy inputs staged by both packages on the CPU.

* `mix64`, `_hash_words` and `hash64_block` equal the reference's
  uint64 hashes bit for bit (int64 extremes, doubles with -0.0 and NaN,
  strings, long decimals, NULLs);
* `_group_ids_hash` gives the reference's ids, perm_first, num_groups
  and overflow: colliding keys, a full table, an exhausted probe
  budget;
* every aggregate on the small-table, sorted, hash-slot and keyless
  paths gives the reference's state table and finalized values:
  exactly, doubles within rel 1e-9 (float sums add in another order;
  a moment that cancels to about zero, as a one-row group's variance,
  is held within 1e-9 of its column's largest magnitude instead);
* HLL registers and estimates, masks, two count(DISTINCT) columns
  (merge_partials: tests/test_torch_merge_partials.py).
"""

import math

import numpy as np
import pytest
import torch

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
import jax.numpy as jnp
from presto_tpu import block as RB
from presto_tpu import types as RT
from presto_tpu.expr import functions as RF
from presto_tpu.ops import aggregation as RA
from presto_tpu.ops import keys as RK

from presto_tpu_torch import block as PB
from presto_tpu_torch import types as PT
from presto_tpu_torch.expr import functions as PF
from presto_tpu_torch.ops import aggregation as PA
from presto_tpu_torch.ops import keys as PK

WORDS = ["", "a", "abcdefgh", "abcdefghi", "zz", "BUILDINGS", "héllo"]
# values, then the mask (boolean), then the group keys
SIGS = ["bigint", "double", "decimal(12, 2)", "decimal(38, 2)",
        "varchar(12)", "boolean", "integer", "bigint", "double"]
BIG, DBL, DEC, LONG, STR, BOOL, KEY8, KEY120, POS = range(9)
REL = 1e-9  # the reference's tolerance for reordered float sums


def _inputs(seed, n=400, inactive_share=0.1):
    """bigint, double, short and long decimal, varchar and boolean
    columns with NULLs, a key of 8 groups, a key of about 120, and a
    positive double; staged by both packages, some rows inactive."""
    rng = np.random.default_rng(seed)
    dbl = np.round(rng.normal(0, 100, n), 3)
    dbl[::37] = -0.0
    long_ = np.array([(1 << 80) * int(v) + 7 for v in
                      rng.integers(-9, 9, n)], dtype=object)
    long_[rng.random(n) < 0.1] = None
    strs = np.array([WORDS[i] for i in rng.integers(0, len(WORDS), n)],
                    dtype=object)
    strs[rng.random(n) < 0.1] = None
    arrays = [rng.integers(-50, 50, n).astype(np.int64), dbl,
              rng.integers(-2000, 2000, n).astype(np.int64), long_, strs,
              rng.random(n) < 0.6, rng.integers(0, 8, n).astype(np.int32),
              rng.integers(0, 120, n).astype(np.int64),
              rng.uniform(0.5, 100.0, n)]
    nulls = [rng.random(n) < 0.1, rng.random(n) < 0.1,
             rng.random(n) < 0.1, None, None, rng.random(n) < 0.1,
             None, None, None]
    nm = [m if m is not None else np.array([v is None for v in a])
          for a, m in zip(arrays, nulls)]
    cap = n + 8
    rb = RB.batch_from_numpy([RT.parse_type(s) for s in SIGS], arrays,
                             nulls=nm, capacity=cap)
    pb = PB.batch_from_numpy([PT.parse_type(s) for s in SIGS], arrays,
                             nulls=nm, capacity=cap, device="cpu")
    act = np.asarray(rb.active).copy()
    act[rng.integers(0, n, int(n * inactive_share))] = False
    return rb.with_active(jnp.asarray(act)), pb.with_active(
        torch.from_numpy(act))


def _specs(A, T, case):
    """The aggregates of one case, in either package's AggSpec."""
    B, D = T.BIGINT, T.DOUBLE
    d2, l2 = T.decimal(12, 2), T.decimal(38, 2)
    return {
        "sum_count": [A("sum", BIG, B), A("sum", DBL, D), A("sum", DEC, l2),
                      A("sum", LONG, l2), A("count", DBL, B),
                      A("count", STR, B), A("count_star", None, B)],
        "min_max": [A("min", BIG, B), A("max", DBL, D), A("min", DEC, d2),
                    A("max", BIG, B)],
        "min_max_wide": [A("min", STR, T.varchar(12)), A("max", STR,
                                                         T.varchar(12)),
                         A("min", LONG, l2), A("max", LONG, l2)],
        "avg": [A("avg", DEC, d2), A("avg", LONG, l2)],
        "variance": [A("var_samp", DBL, D), A("var_pop", DEC, D),
                     A("stddev_samp", BIG, D), A("stddev_pop", DBL, D),
                     A("stddev", DEC, D), A("variance", BIG, D)],
        "bool": [A("bool_and", BOOL, T.BOOLEAN),
                 A("bool_or", BOOL, T.BOOLEAN), A("every", BOOL, T.BOOLEAN)],
        "min_by": [A("min_by", BIG, B, second_channel=DEC, second_type=d2),
                   A("max_by", BIG, B, second_channel=DBL, second_type=D),
                   A("min_by", DBL, D, second_channel=BIG, second_type=B),
                   A("max_by", DEC, d2, second_channel=KEY8,
                     second_type=T.INTEGER)],
        "count_distinct": [A("count_distinct", STR, B), A("count", STR, B)],
        "approx_distinct": [A("approx_distinct", BIG, B),
                            A("approx_distinct", STR, B),
                            A("approx_distinct", LONG, B),
                            A("approx_distinct", DBL, B)],
        "arbitrary": [A("arbitrary", BIG, B), A("any_value", DBL, D)],
        "percentile": [A("approx_percentile", BIG, B, parameter=0.5)],
        "percentile_double": [A("approx_percentile", DBL, D,
                                parameter=0.9)],
        "pair_moments": [A("corr", DBL, D, second_channel=BIG),
                         A("covar_samp", DEC, D, second_channel=DBL),
                         A("covar_pop", BIG, D, second_channel=DEC),
                         A("regr_slope", DBL, D, second_channel=DEC),
                         A("regr_intercept", DEC, D, second_channel=DBL)],
        "geometric_mean": [A("geometric_mean", POS, D),
                           A("geometric_mean", DEC, D)],
        "checksum": [A("checksum", BIG, B), A("checksum", STR, B),
                     A("checksum", LONG, B), A("checksum", DBL, B)],
    }[case]


CASES = ["sum_count", "min_max", "min_max_wide", "avg", "variance", "bool",
         "min_by", "count_distinct", "approx_distinct", "arbitrary",
         "percentile", "percentile_double", "pair_moments",
         "geometric_mean", "checksum"]
# the covered names: every aggregate of the reference's library
assert {s.name for c in CASES for s in _specs(RA.AggSpec, RT, c)} == \
    set(RA._AGGS)

# path -> (keys, max_groups, whether a checksum is added to leave the
# sorted path); a case the sorted path cannot take goes to the hash path
# there, as in the reference
PATHS = {"small": ([KEY8], 16, False), "sorted": ([KEY120], 128, False),
         "hash": ([KEY120], 128, True), "keyless": ([], 1, False),
         "hash_two_keys": ([STR, KEY8], 256, True)}


def _value(v):
    if isinstance(v, np.generic):
        return v.item()
    return v


def _cols(batch, to_numpy):
    """Each column's active rows as values (None for NULL)."""
    act = np.asarray(batch.active)
    out = []
    for c in batch.columns:
        v, m = to_numpy(c)
        out.append([None if m[i] else _value(v[i])
                    for i in range(len(m)) if act[i]])
    return out


def _same(got, want, scale=0.0):
    """Equal values; floats within REL of the value or of `scale`, the
    column's largest magnitude (NaN equal to NaN)."""
    if isinstance(want, float) and isinstance(got, float):
        if math.isnan(want) or math.isnan(got):
            return math.isnan(want) and math.isnan(got)
        return math.isclose(got, want, rel_tol=REL, abs_tol=REL * scale)
    return got == want


def _scale(values):
    return max((abs(v) for v in values if isinstance(v, float)
                and math.isfinite(v)), default=0.0)


def _squared(nk, specs):
    """Finalized columns of standard deviations: compared as variances,
    since the root of a variance that cancels to about zero magnifies
    its rounding."""
    return {nk + i for i, s in enumerate(specs)
            if s.name in ("stddev", "stddev_samp", "stddev_pop")}


def _square(col):
    return [v * v if isinstance(v, float) else v for v in col]


def _assert_columns(got, want, squared=()):
    assert len(got) == len(want)
    for c, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), c
        if c in squared:
            g, w = _square(g), _square(w)
        bad = [(i, a, b) for i, (a, b) in enumerate(zip(g, w))
               if not _same(a, b, _scale(w))]
        assert not bad, (c, bad[:3])


def _assert_tables(p, r, squared=()):
    _assert_columns(_cols(p, PB.to_numpy), _cols(r, RB.to_numpy), squared)


def _run(rb, pb, keys, specs_r, specs_p, g):
    r = RA.group_by(rb, keys, specs_r, g)
    p = PA.group_by(pb, keys, specs_p, g)
    assert bool(p.overflow) == bool(r.overflow)
    assert int(p.num_groups) == int(r.num_groups)
    return r, p


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("case", CASES)
def test_aggregate_matches_the_reference(case, path):
    """The state table and the finalized values of each aggregate,
    group for group in the reference's order."""
    keys, g, force_hash = PATHS[path]
    rb, pb = _inputs(seed=CASES.index(case))
    sr, sp = _specs(RA.AggSpec, RT, case), _specs(PA.AggSpec, PT, case)
    if force_hash:
        sr = sr + [RA.AggSpec("checksum", BIG, RT.BIGINT)]
        sp = sp + [PA.AggSpec("checksum", BIG, PT.BIGINT)]
    sorted_r = g > RA._SMALL_G and RA._sorted_capable(rb, keys, sr)
    assert (g > PA.SMALL_G and PA._sorted_capable(pb, keys, sp)) == sorted_r
    if force_hash:
        assert not sorted_r
    r, p = _run(rb, pb, keys, sr, sp, g)
    assert not bool(p.overflow)
    _assert_tables(p.batch, r.batch)
    nk = len(keys)
    _assert_tables(PA.finalize_states(p.batch, nk, sp),
                   RA.finalize_states(r.batch, nk, sr), _squared(nk, sp))


def _hash_cases():
    return {"bigint": [BIG], "varchar": [STR], "long_decimal": [LONG],
            "double": [DBL], "varchar_integer": [STR, KEY8],
            "bigint_key": [KEY120]}


@pytest.mark.parametrize("g", [65, 1024, 4096])
@pytest.mark.parametrize("keys", list(_hash_cases()))
def test_hash_group_ids_match_the_reference(keys, g):
    """ids, perm_first, num_groups and overflow of the hash-slot table,
    bit for bit; 65 groups under more distinct keys overflow."""
    rb, pb = _inputs(seed=11, n=900)
    chans = _hash_cases()[keys]
    rw, _ = RK.key_words([rb.columns[c] for c in chans])
    pw = PK.key_words([pb.columns[c] for c in chans])
    want = RA._group_ids_hash(rw, rb.active, g)
    got = PA._group_ids_hash(pw, pb.active, g)
    for w, x in zip(want, got):
        assert np.array_equal(np.asarray(w).astype(np.int64),
                              x.numpy().astype(np.int64))


def test_hash_group_ids_full_table_and_exhausted_probes(monkeypatch):
    """More distinct keys than the 1,024 slots fill the table and leave
    rows unresolved after every probe; with a budget of one round,
    colliding rows are left over with fewer groups than max_groups.
    Both overflow as in the reference."""
    n = 3000
    keys = np.arange(n, dtype=np.int64) * 7919 - (1 << 62)
    keys[:2] = [np.iinfo(np.int64).max, np.iinfo(np.int64).min]
    rb = RB.batch_from_numpy([RT.BIGINT], [keys])
    pb = PB.batch_from_numpy([PT.BIGINT], [keys], device="cpu")
    rw, _ = RK.key_words(rb.columns)
    pw = PK.key_words(pb.columns)
    for budget, g in ((64, 65), (1, 4096)):
        monkeypatch.setattr(RA, "_MAX_PROBES", budget)
        monkeypatch.setattr(PA, "_MAX_PROBES", budget)
        want = RA._group_ids_hash(rw, rb.active, g)
        got = PA._group_ids_hash(pw, pb.active, g)
        assert bool(got[3]) and bool(want[3])
        assert int(got[2]) == int(want[2])
        if budget == 1:
            assert int(got[2]) < g
        for w, x in zip(want, got):
            assert np.array_equal(np.asarray(w).astype(np.int64),
                                  x.numpy().astype(np.int64))
    assert PA.HASH_STATS["rounds"] == 1


def test_hashes_are_the_reference_bits():
    """mix64, _hash_words and hash64_block on int64 extremes, doubles
    (-0.0, NaN, infinities), strings across the 8-byte word boundary,
    long decimals and NULLs."""
    ints = np.array([0, 1, -1, np.iinfo(np.int64).max, np.iinfo(np.int64).min,
                     0x9E3779B97F4A7C15 - (1 << 64), 12345678901234],
                    dtype=np.int64)
    got = PF.mix64(torch.from_numpy(ints)).numpy()
    want = np.asarray(RF._mix64(jnp.asarray(ints.astype(np.uint64))))
    assert np.array_equal(got.view(np.uint64), want)
    dbl = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.5, -2.25, 1e300])
    strs = np.array(WORDS + [None, "abcdefghijklmnopq"], dtype=object)
    longs = np.array([0, -1, (1 << 100) + 3, -(1 << 90), None], dtype=object)
    for ty, vals, null in (("bigint", ints, None), ("double", dbl, None),
                           ("varchar(20)", strs, None),
                           ("decimal(38, 2)", longs, None),
                           ("boolean", np.array([True, False, True]),
                            np.array([False, False, True]))):
        nulls = null if null is not None else np.array(
            [v is None for v in vals])
        rc = RB.from_numpy(RT.parse_type(ty), vals, nulls)
        pc = PB.from_numpy(PT.parse_type(ty), vals, nulls, device="cpu")
        want = np.asarray(RF.hash64_block(rc))
        assert np.array_equal(PF.hash64_block(pc).numpy().view(np.uint64),
                              want), ty
        rw, _ = RK.key_words([rc])
        pw = PK.key_words([pc])
        assert np.array_equal(PA._hash_words(pw).numpy().view(np.uint64),
                              np.asarray(RA._hash_words(rw))), ty


@pytest.mark.parametrize("path", ["small", "sorted", "hash", "keyless"])
def test_hll_registers_and_estimates_match(path):
    """The register matrix itself, then the estimates, over 20,000 rows
    with about 6,000 distinct values a column."""
    keys, g, force = PATHS[path]
    n = 20_000
    rng = np.random.default_rng(21)
    vals = rng.integers(0, 6000 * 8, n).astype(np.int64) * 13
    key = rng.integers(0, 8 if g == 16 else 120, n).astype(np.int64)
    rb = RB.batch_from_numpy([RT.BIGINT, RT.BIGINT], [vals, key])
    pb = PB.batch_from_numpy([PT.BIGINT, PT.BIGINT], [vals, key],
                             device="cpu")
    keys = [1] if keys else []
    sr = [RA.AggSpec("approx_distinct", 0, RT.BIGINT)]
    sp = [PA.AggSpec("approx_distinct", 0, PT.BIGINT)]
    if force:
        sr.append(RA.AggSpec("checksum", 0, RT.BIGINT))
        sp.append(PA.AggSpec("checksum", 0, PT.BIGINT))
    r, p = _run(rb, pb, keys, sr, sp, g)
    regs = p.batch.columns[len(keys)].elements.numpy()
    assert np.array_equal(regs, np.asarray(r.batch.columns[len(keys)]
                                           .elements))
    assert regs.max() > 10
    est = PA.hll_estimate(torch.from_numpy(regs)).numpy()
    assert np.array_equal(est, np.asarray(RA.hll_estimate(jnp.asarray(regs))))
    _assert_tables(PA.finalize_states(p.batch, len(keys), sp),
                   RA.finalize_states(r.batch, len(keys), sr))


@pytest.mark.parametrize("path", list(PATHS))
def test_masked_aggregates_match(path):
    """Aggregates restricted by a BOOLEAN mask column (NULL excludes),
    beside the same aggregates unmasked."""
    keys, g, force = PATHS[path]
    rb, pb = _inputs(seed=31)

    def specs(A, T):
        B = T.BIGINT
        out = [A("count_star", None, B, mask_channel=BOOL),
               A("sum", BIG, B, mask_channel=BOOL), A("sum", BIG, B),
               A("min", DBL, T.DOUBLE, mask_channel=BOOL),
               A("avg", DEC, T.decimal(12, 2), mask_channel=BOOL),
               A("var_pop", DBL, T.DOUBLE, mask_channel=BOOL),
               A("count_distinct", STR, B, mask_channel=BOOL),
               A("count", STR, B, mask_channel=BOOL)]
        if force:
            out.append(A("checksum", BIG, B, mask_channel=BOOL))
        return out
    sr, sp = specs(RA.AggSpec, RT), specs(PA.AggSpec, PT)
    r, p = _run(rb, pb, keys, sr, sp, g)
    _assert_tables(p.batch, r.batch)
    _assert_tables(PA.finalize_states(p.batch, len(keys), sp),
                   RA.finalize_states(r.batch, len(keys), sr))


@pytest.mark.parametrize("g", [16, 128])
def test_two_distinct_columns_take_the_hash_path(g):
    """count(DISTINCT) of two columns in one aggregation: the sorted
    path's sort carries one, so the reference takes its hash path."""
    rb, pb = _inputs(seed=41)

    def specs(A, T):
        return [A("count_distinct", STR, T.BIGINT),
                A("count_distinct", BIG, T.BIGINT),
                A("sum", DEC, T.decimal(38, 2))]
    sr, sp = specs(RA.AggSpec, RT), specs(PA.AggSpec, PT)
    assert not PA._sorted_capable(pb, [KEY120], sp)
    r, p = _run(rb, pb, [KEY120] if g > 16 else [KEY8], sr, sp, g)
    _assert_tables(p.batch, r.batch)
