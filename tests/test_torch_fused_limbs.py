"""fused_limb_sums: the port's plain version (what the wrapper takes for
CPU tensors) against the reference's fused limb pool fed the
materialised requests, against exact Python sums, and the wrapper's
argument checks. The CUDA kernel itself is held against the plain
version on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
import jax.numpy as jnp
from presto_tpu.ops import aggregation as RA

from presto_tpu_torch import int128 as PI
from presto_tpu_torch.ops import aggregation as PA
from presto_tpu_torch.ops import kernels as K

R = K.LimbRequest
BIG = 10 ** 38 - 1


def _lanes(rng, n):
    """One lane of every kind the kernel reads, at its extremes too."""
    out = {}
    for dt in (np.int8, np.int16, np.int32, np.int64):
        info = np.iinfo(dt)
        v = rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
        v[:2] = (info.min, info.max)
        out[np.dtype(dt).name] = torch.from_numpy(v)
    out["bool"] = torch.from_numpy(rng.random(n) < 0.6)
    vals = [int(x) for x in rng.integers(-(1 << 50), 1 << 50, n)]
    vals = [v * (1 << 64) + 12345 for v in vals[:n // 2]] + vals[n // 2:]
    vals[:2] = [BIG, -BIG]
    hi, lo = PI.python_to_int128(vals)
    out["int128"] = (torch.from_numpy(hi), torch.from_numpy(lo))
    return out, vals


def _ids(rng, n, groups):
    # ids outside [0, G) on both sides contribute nothing
    return torch.from_numpy(rng.integers(-3, groups + 3, n).astype(np.int32))


def _requests(sources):
    """Whole-lane sums and counts, 13-bit limb splits of every lane (the
    _sum128 descriptors), masked and not."""
    names = list(sources)
    mask = names.index("bool")
    reqs = [R(mask, -1, 0, 1, True)]  # a count
    for i, name in enumerate(names):
        width = 128 if name == "int128" else \
            1 if name == "bool" else np.dtype(name).itemsize * 8
        if width <= 64:
            reqs.append(R(i, mask, 0, width, True))  # a whole-lane sum
        nl = max(-(-width // 13), 1)
        reqs += [R(i, mask if k % 2 else -1, 13 * k, 13, k == nl - 1)
                 for k in range(nl)]
    return reqs


@pytest.mark.parametrize("groups", [2, 16, 64])
def test_plain_matches_reference_pool(groups, monkeypatch):
    """The plain version against presto_tpu's _fused_limb_sums (its
    einsum form with 8-bit limbs, as its CPU tests run it) fed each
    descriptor's materialised contribution: exact equality."""
    monkeypatch.setenv("PRESTO_TPU_SMALLG", "einsum")
    monkeypatch.setenv("PRESTO_TPU_BF16", "1")
    rng = np.random.default_rng(groups)
    n = 3001
    lanes, _ = _lanes(rng, n)
    sources = list(lanes.values())
    reqs = _requests(lanes)
    ids = _ids(rng, n, groups)
    got = K.fused_limb_sums(ids, sources, reqs, groups)
    assert got.shape == (groups, len(reqs)) and got.dtype == torch.int64
    contribs = []
    for r in reqs:
        x = K.source_field(sources[r.source], r.shift, r.bits, r.remainder)
        if r.mask != -1:
            x = torch.where(sources[r.mask], x, 0)
        contribs.append((jnp.asarray(x.numpy()), r.bits))
    want = RA._fused_limb_sums(jnp.asarray(ids.numpy()), contribs, groups)
    for ri, w in enumerate(want):
        assert np.array_equal(np.asarray(w), got[:, ri].numpy()), reqs[ri]


@pytest.mark.parametrize("groups", [2, 16, 64])
def test_plain_matches_exact_python_sums(groups):
    """Every lane kind at its extremes, (hi, lo) at +-(10^38 - 1): the
    whole-lane sums equal Python's sums (mod 2^64) and the 13-bit limb
    totals of the 128-bit lane recombine into the exact 128-bit sum."""
    rng = np.random.default_rng(100 + groups)
    n = 2000
    lanes, vals = _lanes(rng, n)
    sources = list(lanes.values())
    names = list(lanes)
    reqs = _requests(lanes)
    ids = _ids(rng, n, groups)
    got = K.fused_limb_sums(ids, sources, reqs, groups)
    idn = ids.numpy()
    live = lanes["bool"].numpy()

    def wrap(v):
        return (v + (1 << 63)) % (1 << 64) - (1 << 63)

    for ri, r in enumerate(reqs):
        if r.shift or not r.remainder or names[r.source] == "int128":
            continue
        v = lanes[names[r.source]].numpy().astype(object)
        if r.mask != -1:
            v = np.where(live, v, 0)
        for g in range(groups):
            assert got[g, ri].item() == wrap(int(v[idn == g].sum())), r
    i128 = names.index("int128")
    cols = [ri for ri, r in enumerate(reqs) if r.source == i128]
    assert len(cols) == 10
    # unmask the 128-bit limbs for this check
    plain = [R(i128, -1, r.shift, r.bits, r.remainder)
             for r in (reqs[c] for c in cols)]
    tot = K.fused_limb_sums(ids, sources, plain, groups)
    hi, lo = PI.combine_limb_totals_128(tot)
    got128 = PI.int128_to_python(hi.numpy(), lo.numpy())
    vals = np.array(vals, dtype=object)
    for g in range(groups):
        assert got128[g] == sum(vals[idn == g].tolist())


def test_worst_case_one_group_at_the_extremes():
    """Every row in one group, every lane at its extreme: the largest
    limb totals the kernel's int32 sums must hold."""
    n = 4096
    for sign in (1, -1):
        sources = []
        for dt in (torch.int8, torch.int16, torch.int32, torch.int64):
            info = torch.iinfo(dt)
            sources.append(torch.full((n,), info.max if sign > 0
                                      else info.min, dtype=dt))
        hi, lo = PI.python_to_int128([sign * BIG] * n)
        sources.append((torch.from_numpy(hi), torch.from_numpy(lo)))
        sources.append(torch.ones(n, dtype=torch.bool))
        reqs = [R(s, 5, 0, w, True)
                for s, w in zip(range(4), (8, 16, 32, 64))]
        reqs += [R(4, 5, 13 * k, 13, k == 9) for k in range(10)]
        reqs.append(R(5, -1, 0, 1, True))
        got = K.fused_limb_sums(torch.zeros(n, dtype=torch.int32), sources,
                                reqs, 2)
        for s, dt in enumerate((torch.int8, torch.int16, torch.int32)):
            info = torch.iinfo(dt)
            assert got[0, s].item() == n * (info.max if sign > 0
                                            else info.min)
        assert got[0, 14].item() == n and not got[1].any()
        # n * BIG overflows 128 bits: each 13-bit limb total is exact
        for k in range(10):
            field = (sign * BIG) >> (13 * k)
            want = field if k == 9 else field & 0x1FFF
            assert got[0, 4 + k].item() == n * want


def test_limbs_are_seven_bit_s8():
    """The plain version's limbs: low limbs in [0, 127], the last the
    signed remainder, every one an s8; their weighted sum is the
    field."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(-(1 << 47), 1 << 47, 999))
    limbs = PI.limbs_of_i64(x, K.LIMB_BITS, K.limb_count(48))
    assert len(limbs) == 7
    for l in limbs[:-1]:
        assert int(l.min()) >= 0 and int(l.max()) <= 127
    assert int(limbs[-1].min()) >= -128 and int(limbs[-1].max()) <= 127
    back = sum(l.to(torch.int8).to(torch.int64) << (7 * j)
               for j, l in enumerate(limbs))
    assert torch.equal(back, x)


def test_pool_passes_each_lane_once(monkeypatch):
    """q1's aggregates hand the kernel 11 distinct sources (six live
    masks, quantity, extendedprice, discount and two 128-bit lanes:
    49 bytes a row with the int32 ids) for 39 requests."""
    from presto_tpu.connectors import tpch as rtpch
    from presto_tpu.queries.tpch_queries import Q1_COLUMNS
    from presto_tpu_torch import block as PB
    from presto_tpu_torch import types as T
    from presto_tpu_torch.expr import call, const, input_ref
    from presto_tpu_torch.expr.compile import (compile_filter,
                                               compile_projections)
    seen = []
    inner = K.fused_limb_sums

    def spy(ids, sources, requests, groups, **kw):
        seen.append((sources, requests))
        return inner(ids, sources, requests, groups, **kw)

    monkeypatch.setattr(K, "fused_limb_sums", spy)
    data = rtpch.generate_columns("lineitem", 0.002, Q1_COLUMNS)
    tys = [T.parse_type(str(rtpch.column_type("lineitem", c)))
           for c in Q1_COLUMNS]
    batch = PB.batch_from_numpy(
        tys, [data[c] for c in Q1_COLUMNS], device="cpu",
        physical_dtypes=[None, None, "int16", "int32", "int8", "int8",
                         "int16"])
    d2 = T.decimal(12, 2)
    qty, price = input_ref(2, d2), input_ref(3, d2)
    disc, tax, one = input_ref(4, d2), input_ref(5, d2), const(100, d2)
    disc_price = call("multiply", T.decimal(24, 4), price,
                      call("subtract", d2, one, disc))
    charge = call("multiply", T.decimal(36, 6), disc_price,
                  call("add", d2, one, tax))
    pred = call("le", T.BOOLEAN, input_ref(6, T.DATE),
                const("1998-09-02", T.DATE))
    pb = compile_projections([input_ref(0, T.char(1)),
                              input_ref(1, T.char(1)), qty, price,
                              disc_price, charge, disc])(
        compile_filter(pred)(batch))
    A = PA.AggSpec
    aggs = [A("sum", 2, T.decimal(38, 2)), A("sum", 3, T.decimal(38, 2)),
            A("sum", 4, T.decimal(38, 4)), A("sum", 5, T.decimal(38, 6)),
            A("avg", 2, d2), A("avg", 3, d2), A("avg", 6, d2),
            A("count_star", None, T.BIGINT)]
    PA.group_by(pb, [0, 1], aggs, 16)
    ((sources, requests),) = seen
    assert len(requests) == 39 and len(sources) == 11
    row_bytes = 4 + sum(t.element_size() for s in sources
                        for t in (s if isinstance(s, tuple) else (s,)))
    assert row_bytes == 49


def test_wrapper_refuses_what_the_kernel_does_not_take():
    ids = torch.zeros(8, dtype=torch.int32)
    v = torch.zeros(8, dtype=torch.int32)
    m = torch.ones(8, dtype=torch.bool)
    ok = [R(0, 1, 0, 32, True)]
    assert K.fused_limb_sums(ids, [v, m], ok, 4).shape == (4, 1)
    with pytest.raises(TypeError):
        K.fused_limb_sums(ids.to(torch.int64), [v, m], ok, 4)
    with pytest.raises(TypeError):
        K.fused_limb_sums(ids, [v.to(torch.float32), m], ok, 4)
    with pytest.raises(TypeError):
        K.fused_limb_sums(ids, [(v, v), m], ok, 4)
    with pytest.raises(ValueError):
        K.fused_limb_sums(ids, [v, m], ok, 65)
    with pytest.raises(ValueError):
        K.fused_limb_sums(ids, [v[:4], m], ok, 4)
    with pytest.raises(ValueError, match="mask"):
        K.fused_limb_sums(ids, [v, m], [R(1, 0, 0, 1, True)], 4)
    for bad in (R(0, -1, 128, 13, True), R(0, -1, 0, 0, True),
                R(0, -1, 0, 65, True), R(2, -1, 0, 8, True)):
        with pytest.raises(ValueError):
            K.fused_limb_sums(ids, [v, m], [bad], 4)
    # a device with no kernel raises; nothing falls back to the CPU form
    with pytest.raises(ValueError, match="no kernel"):
        K.fused_limb_sums(ids.to("meta"), [v.to("meta"), m.to("meta")], ok,
                          4)


@pytest.mark.parametrize("form", ["narrow", "wide"])
def test_fused_pool_takes_plain_requests_too(form):
    """_fused_limb_sums takes plain (contrib, value_bits) pairs as
    whole-lane requests beside descriptors, in both forms."""
    rng = np.random.default_rng(3)
    n, groups = 777, 16
    ids = torch.from_numpy(rng.integers(0, groups, n).astype(np.int32))
    v = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, n))
    live = torch.from_numpy(rng.random(n) < 0.5)
    got = PA._fused_limb_sums(
        ids, [(v, 32), PA._Request(v, live, 0, 32, True), (live, 1)],
        groups, form)
    idn, vn, ln = ids.numpy(), v.numpy(), live.numpy()
    for g in range(groups):
        assert got[0][g].item() == int(vn[idn == g].sum())
        assert got[1][g].item() == int(vn[(idn == g) & ln].sum())
        assert got[2][g].item() == int(((idn == g) & ln).sum())


@pytest.mark.parametrize("nsources,width", [(17, 8), (40, 1), (12, 16)])
def test_pool_cuts_what_one_launch_cannot_take(nsources, width):
    """More sources, limbs or shared memory than one launch holds (a
    projection of many distinct lanes): the wrapper refuses them on the
    CPU as the kernel does on the card, and the pool cuts them into
    launches that each fit, in order, with the exact sums."""
    rng = np.random.default_rng(nsources)
    n, groups = 999, 8
    ids = _ids(rng, n, groups)
    dt = {1: torch.int8, 8: torch.int64}.get(width)
    lanes = []
    for _ in range(nsources):
        if width == 16:
            v = torch.from_numpy(rng.integers(-(1 << 60), 1 << 60, n))
            lanes.append((v >> 63, v))
        else:
            lanes.append(torch.from_numpy(
                rng.integers(-100, 100, n)).to(dt))
    bits = 64 if width == 16 else 8 * width
    reqs = [PA._Request(s, None, 0, bits, True) for s in lanes]
    chunks = PA._fused_chunks(reqs)
    assert len(chunks) >= 2
    assert [r for c in chunks for r in c] == reqs
    for c in chunks:
        assert K.fused_fits(len(c), sum(K.source_bytes(r.source) for r in c),
                            len(c), sum(K.limb_count(r.bits) for r in c))
    kreqs = [R(i, -1, 0, bits, True) for i in range(nsources)]
    with pytest.raises(ValueError, match="refused"):
        K.fused_limb_sums(ids, lanes, kreqs, groups)
    got = PA._fused_limb_sums(ids, reqs, groups)
    live = (ids >= 0) & (ids < groups)
    for s, g in zip(lanes, got):
        v = s[1] if isinstance(s, tuple) else s.to(torch.int64)
        want = torch.zeros(groups, dtype=torch.int64).index_add_(
            0, ids[live].to(torch.int64), v[live])
        assert g.tolist() == want.tolist()
