"""group_by + finalize_states and the expression layer of the port
against presto_tpu's on the same staged lineitem batch.

The reference runs its small-table pool form (PRESTO_TPU_SMALLG=einsum;
PRESTO_TPU_BF16=1 adds its 8-bit limbs) so both packages take the same
dataflow; results must be exact.
"""

import numpy as np
import pytest
import torch

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
from presto_tpu import block as RB
from presto_tpu import types as RT
from presto_tpu.connectors import tpch as rtpch
from presto_tpu.expr import compile as RC
from presto_tpu.expr import ir as RE
from presto_tpu.ops import aggregation as RA
from presto_tpu.queries.tpch_queries import Q1_COLUMNS

from presto_tpu_torch import block as PB
from presto_tpu_torch import types as PT
from presto_tpu_torch.expr import compile as PC
from presto_tpu_torch.expr import ir as PE
from presto_tpu_torch.ops import aggregation as PA

SF = 0.002
PHYS = [None, None, "int16", "int32", "int8", "int8", "int16"]


def _q1_exprs(E, T):
    d2 = T.decimal(12, 2)
    qty, price = E.input_ref(2, d2), E.input_ref(3, d2)
    disc, tax = E.input_ref(4, d2), E.input_ref(5, d2)
    one = E.const(100, d2)
    pred = E.call("le", T.BOOLEAN, E.input_ref(6, T.DATE),
                  E.const("1998-09-02", T.DATE))
    disc_price = E.call("multiply", T.decimal(24, 4), price,
                        E.call("subtract", d2, one, disc))
    charge = E.call("multiply", T.decimal(36, 6), disc_price,
                    E.call("add", d2, one, tax))
    return pred, [E.input_ref(0, T.char(1)), E.input_ref(1, T.char(1)), qty,
                  price, disc_price, charge, disc]


def _aggs(Spec, T, d2):
    return [Spec("sum", 2, T.decimal(38, 2)), Spec("sum", 3, T.decimal(38, 2)),
            Spec("sum", 4, T.decimal(38, 4)), Spec("sum", 5, T.decimal(38, 6)),
            Spec("avg", 2, d2), Spec("avg", 3, d2), Spec("avg", 6, d2),
            Spec("count", 6, T.BIGINT), Spec("count_star", None, T.BIGINT)]


@pytest.fixture(scope="module")
def staged():
    data = rtpch.generate_columns("lineitem", SF, Q1_COLUMNS)
    arrays = [data[c] for c in Q1_COLUMNS]
    tys = [rtpch.column_type("lineitem", c) for c in Q1_COLUMNS]
    n = len(arrays[0])
    cap = n + 8
    ref = RB.batch_from_numpy(tys, arrays, capacity=cap, physical_dtypes=PHYS)
    port = PB.batch_from_numpy([PT.parse_type(str(t)) for t in tys], arrays,
                               capacity=cap, physical_dtypes=PHYS,
                               device="cpu")
    return ref, port


def _table(batch, to_numpy, active):
    act = np.asarray(active)
    return [[(v, bool(m)) for v, m in zip(*[a[act] for a in to_numpy(c)])]
            for c in batch.columns]


def _project(staged):
    ref, port = staged
    rpred, rexprs = _q1_exprs(RE, RT)
    ppred, pexprs = _q1_exprs(PE, PT)
    rb = RC.compile_projections(rexprs)(RC.compile_filter(rpred)(ref))
    pb = PC.compile_projections(pexprs)(PC.compile_filter(ppred)(port))
    return rb, pb


def test_filter_and_projection_match(staged):
    rb, pb = _project(staged)
    assert np.array_equal(np.asarray(rb.active), pb.active.numpy())
    assert _table(rb, RB.to_numpy, rb.active) == \
        _table(pb, PB.to_numpy, pb.active.numpy())


@pytest.mark.parametrize("form", ["narrow", "wide"])
def test_group_by_and_finalize_match(staged, form, monkeypatch):
    monkeypatch.setenv("PRESTO_TPU_SMALLG", "einsum")
    monkeypatch.setenv("PRESTO_TPU_BF16", "1" if form == "narrow" else "0")
    rb, pb = _project(staged)
    raggs = _aggs(RA.AggSpec, RT, RT.decimal(12, 2))
    paggs = _aggs(PA.AggSpec, PT, PT.decimal(12, 2))
    r = RA.group_by(rb, [0, 1], raggs, 16)
    p = PA.group_by(pb, [0, 1], paggs, 16, limb_form=form)
    assert int(r.num_groups) == int(p.num_groups) == 4
    assert not bool(r.overflow) and not bool(p.overflow)
    rs = _table(r.batch, RB.to_numpy, r.batch.active)
    ps = _table(p.batch, PB.to_numpy, p.batch.active.numpy())
    assert rs == ps
    rf = RA.finalize_states(r.batch, 2, raggs)
    pf = PA.finalize_states(p.batch, 2, paggs)
    assert _table(rf, RB.to_numpy, rf.active) == \
        _table(pf, PB.to_numpy, pf.active.numpy())


def test_fused_request_pool_matches_the_reference(staged, monkeypatch):
    """q1's aggregates hand the fused limb sum the same requests as the
    reference, in the same order: 31 thirteen-bit limb sums and 8
    one-bit counts. The port queues descriptors of the lanes; each one's
    materialize() equals the reference's contribution. In 7-bit limbs
    the fused kernel sums L = 31 * 2 + 8 = 70 limb columns."""
    monkeypatch.setenv("PRESTO_TPU_SMALLG", "einsum")
    monkeypatch.setenv("PRESTO_TPU_BF16", "1")
    seen = {"ref": [], "port": []}

    def spy(mod, key, unpack):
        inner = mod._fused_limb_sums

        def run(ids, requests, max_groups, *a, **k):
            seen[key].append([unpack(r) for r in requests])
            return inner(ids, requests, max_groups, *a, **k)
        monkeypatch.setattr(mod, "_fused_limb_sums", run)

    spy(RA, "ref", lambda r: (np.asarray(r[0]).astype(np.int64), int(r[1])))
    spy(PA, "port", lambda r: (r.materialize().numpy(), r.bits))
    rb, pb = _project(staged)
    q1 = [a for a in range(9) if a != 7]   # drop the extra count(disc)
    raggs = [_aggs(RA.AggSpec, RT, RT.decimal(12, 2))[a] for a in q1]
    paggs = [_aggs(PA.AggSpec, PT, PT.decimal(12, 2))[a] for a in q1]
    RA.group_by(rb, [0, 1], raggs, 16)
    PA.group_by(pb, [0, 1], paggs, 16, limb_form="narrow")
    (ref,), (port,) = seen["ref"], seen["port"]
    assert [b for _, b in port] == [b for _, b in ref]
    assert all(np.array_equal(rc, pc) for (rc, _), (pc, _) in zip(ref, port))
    bits = [b for _, b in port]
    assert (bits.count(13), bits.count(1), len(bits)) == (31, 8, 39)
    assert sum(-(-b // 7) for b in bits) == 70


def test_keyless_aggregation_matches(staged):
    ref, port = staged
    raggs = [RA.AggSpec("sum", 3, RT.decimal(38, 2)),
             RA.AggSpec("avg", 2, RT.decimal(12, 2)),
             RA.AggSpec("count_star", None, RT.BIGINT)]
    paggs = [PA.AggSpec(a.name, a.input_channel,
                        PT.parse_type(str(a.output_type))) for a in raggs]
    r = RA.finalize_states(RA.group_by(ref, [], raggs, 1 << 16).batch, 0,
                           raggs)
    p = PA.finalize_states(PA.group_by(port, [], paggs, 1 << 16).batch, 0,
                           paggs)
    assert _table(r, RB.to_numpy, r.active) == \
        _table(p, PB.to_numpy, p.active.numpy())
    # zero input rows still give the one global group
    empty = port.with_active(torch.zeros_like(port.active))
    e = PA.group_by(empty, [], paggs, 1)
    assert e.batch.active.tolist() == [True]
    assert PB.to_numpy(e.batch.columns[-1])[0].tolist() == [0]


def test_overflow_flags_like_the_reference(staged):
    ref, port = staged
    spec_r = [RA.AggSpec("count_star", None, RT.BIGINT)]
    spec_p = [PA.AggSpec("count_star", None, PT.BIGINT)]
    r = RA.group_by(ref, [0, 1], spec_r, 2)
    p = PA.group_by(port, [0, 1], spec_p, 2)
    assert bool(r.overflow) and bool(p.overflow)
    assert int(r.num_groups) == int(p.num_groups) == 2


def test_out_of_slice_aggregates_raise(staged):
    """What earlier slices refused now equals the reference: HLL
    registers on the small-table path, two count(DISTINCT) columns
    (the hash-slot path) and approx_percentile riding the sorted path's
    sort. What still raises is what the reference refuses too: merging
    count(DISTINCT) or approx_percentile partial states."""
    ref, port = staged
    cases = [(16, [("approx_distinct", 2, "bigint", None)]),
             (128, [("count_distinct", 2, "bigint", None),
                    ("count_distinct", 3, "bigint", None)]),
             (128, [("approx_percentile", 2, "decimal(12, 2)", 0.5)])]
    for g, specs in cases:
        raggs = [RA.AggSpec(n, c, RT.parse_type(t), parameter=q)
                 for n, c, t, q in specs]
        paggs = [PA.AggSpec(n, c, PT.parse_type(t), parameter=q)
                 for n, c, t, q in specs]
        r = RA.group_by(ref, [0], raggs, g)
        p = PA.group_by(port, [0], paggs, g)
        assert int(r.num_groups) == int(p.num_groups) == 3
        assert _table(r.batch, RB.to_numpy, r.batch.active) == \
            _table(p.batch, PB.to_numpy, p.batch.active.numpy())
        rf = RA.finalize_states(r.batch, 1, raggs)
        pf = PA.finalize_states(p.batch, 1, paggs)
        assert _table(rf, RB.to_numpy, rf.active) == \
            _table(pf, PB.to_numpy, pf.active.numpy())
        if g == 128:
            for A, b, aggs in ((RA, r, raggs), (PA, p, paggs)):
                with pytest.raises(NotImplementedError,
                                   match="don't merge across partials"):
                    A.merge_partials(b.batch, 1, aggs, g)


def test_key_words_and_sort_match(staged):
    """Key words are the reference's uint64 words bit for bit, and the
    LSD per-word sort gives the reference's stable permutation
    (ascending and descending, nulls first and last)."""
    from presto_tpu.ops import keys as RK
    from presto_tpu.ops import sort as RS
    from presto_tpu_torch.ops import keys as PK
    from presto_tpu_torch.ops import sort as PS
    ref, port = staged
    cols = [0, 1, 2, 3, 6]
    rw, _ = RK.key_words([ref.columns[c] for c in cols], nulls_last=True)
    pw = PK.key_words([port.columns[c] for c in cols], nulls_last=True)
    assert len(rw) == len(pw)
    for r, p in zip(rw, pw):
        assert np.array_equal(np.asarray(r).view(np.int64), p.numpy())
    for keys in ([(0, False, True), (3, True, False)],
                 [(6, True, True), (1, False, False), (2, False, True)]):
        rp = RS.sort_permutation(ref, [RS.SortKey(*k) for k in keys])
        pp = PS.sort_permutation(port, keys)
        assert np.array_equal(np.asarray(rp), pp.numpy())
