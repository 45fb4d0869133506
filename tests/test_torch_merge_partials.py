"""merge_partials, the FINAL step of the port's two-stage aggregation,
against presto_tpu on the inputs of tests/test_torch_hash_groupby.py:
the PARTIAL tables of two halves of the rows, concatenated and merged,
equal the reference's merge and finalize to the single step's values;
the states that do not merge raise as in the reference.
"""

import math

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

from test_torch_hash_groupby import (BIG, CASES, DEC, KEY8, PATHS,
                                     _assert_columns, _assert_tables, _cols,
                                     _inputs, _specs, _squared)


MERGEABLE = [c for c in CASES if c not in ("count_distinct", "percentile",
                                           "percentile_double")]


def _by_key(batch, nk, keep):
    """{key tuple: row} over the active rows, the columns in `keep`."""
    cols = _cols(batch, PB.to_numpy)
    keys = list(zip(*cols[:nk])) if nk else [()] * len(cols[0])
    return [cols[c] for c in keep], keys


def _assert_by_key(got, want, nk, keep, squared=()):
    """The columns `keep` of two group tables, group by group, in the
    order of `want`'s keys."""
    gcols, gkeys = _by_key(got, nk, keep)
    wcols, wkeys = _by_key(want, nk, keep)
    assert sorted(gkeys, key=repr) == sorted(wkeys, key=repr)
    pos = {k: i for i, k in enumerate(gkeys)}
    order = [pos[k] for k in wkeys]
    _assert_columns([[col[i] for i in order] for col in gcols], wcols,
                    {j for j, c in enumerate(keep) if c in squared})


@pytest.mark.parametrize("path", ["small", "sorted", "hash", "keyless"])
@pytest.mark.parametrize("case", MERGEABLE)
def test_merge_partials_of_two_halves_equals_single(case, path):
    """PARTIAL tables of the even and the odd rows, concatenated and
    merged (FINAL), equal the reference's merge of the same halves in
    its order, and finalize to the single step's values group by group.
    Where ties let min_by/max_by or arbitrary answer from another row,
    the single step is held to the winning order value instead. A
    geometric_mean over nonpositive inputs is NaN in its group; the
    sorted merge's cumsum then carries that NaN into every later group
    (the reference does the same, test below), so such a column is held
    to the reference's merge only."""
    keys, g, force = PATHS[path]
    rb, pb = _inputs(seed=51 + MERGEABLE.index(case))
    sr, sp = _specs(RA.AggSpec, RT, case), _specs(PA.AggSpec, PT, case)
    if force:
        sr = sr + [RA.AggSpec("checksum", BIG, RT.BIGINT)]
        sp = sp + [PA.AggSpec("checksum", BIG, PT.BIGINT)]
    nk = len(keys)
    even = np.arange(rb.capacity) % 2 == 0
    act = np.asarray(rb.active)
    halves_r, halves_p = [], []
    for half in (even, ~even):
        halves_r.append(RA.group_by(rb.with_active(jnp.asarray(act & half)),
                                    keys, sr, g).batch)
        halves_p.append(PA.group_by(pb.with_active(torch.from_numpy(
            act & half)), keys, sp, g).batch)
    r = RA.merge_partials(RB.concat_batches(halves_r), nk, sr, g)
    p = PA.merge_partials(PB.concat_batches(halves_p), nk, sp, g)
    assert bool(p.overflow) == bool(r.overflow) is False
    _assert_tables(p.batch, r.batch)
    fin = PA.finalize_states(p.batch, nk, sp)
    squared = _squared(nk, sp)
    _assert_tables(fin, RA.finalize_states(r.batch, nk, sr), squared)
    single = PA.group_by(pb, keys, sp, g).batch
    tied = {nk + i for i, s in enumerate(sp)
            if s.canonical in ("min_by", "max_by", "arbitrary")
            or (s.input_channel == DEC and s.name == "geometric_mean"
                and g > PA.SMALL_G)}
    keep = [c for c in range(fin.num_columns) if c not in tied]
    _assert_by_key(fin, PA.finalize_states(single, nk, sp), nk, keep,
                   squared)
    # min_by/max_by: the order state (each spec's second state column)
    orders, ch = [], nk
    for s in sp:
        if s.canonical in ("min_by", "max_by"):
            orders.append(ch + 1)
        ch += PA.state_width(s)
    if orders:
        _assert_by_key(p.batch, single, nk, orders)


def test_sorted_merge_carries_a_nan_state_into_later_groups():
    """The sorted path sums doubles as differences of one cumsum, so a
    NaN state (a geometric_mean over a negative input) makes every
    later group NaN, in the reference and in the port alike (ROADMAP
    queue 3)."""
    vals = np.array([-1.0, 2.0, 4.0, 8.0])
    keys = np.array([0, 1, 1, 2], dtype=np.int64)
    tables = []
    for B, T, A, kw in ((RB, RT, RA, {}), (PB, PT, PA, {"device": "cpu"})):
        b = B.batch_from_numpy([T.DOUBLE, T.BIGINT], [vals, keys], **kw)
        spec = [A.AggSpec("geometric_mean", 0, T.DOUBLE)]
        part = A.group_by(b, [1], spec, 128).batch
        merged = A.merge_partials(part, 1, spec, 128)
        tables.append(A.finalize_states(merged.batch, 1, spec))
    want = _cols(tables[0], RB.to_numpy)
    _assert_columns(_cols(tables[1], PB.to_numpy), want)
    assert want[0] == [0, 1, 2]
    assert all(math.isnan(v) for v in want[1])


@pytest.mark.parametrize("name", ["count_distinct", "approx_percentile"])
def test_unmergeable_states_raise_like_the_reference(name):
    """Their partial states do not merge: both packages refuse."""
    rb, pb = _inputs(seed=61)
    specs = [(RA, RT, rb), (PA, PT, pb)]
    for A, T, b in specs:
        spec = A.AggSpec(name, BIG, T.BIGINT, parameter=0.5)
        part = A.group_by(b, [KEY8], [spec], 16).batch
        with pytest.raises(NotImplementedError, match="don't merge"):
            A.merge_partials(part, 1, [spec], 16)
