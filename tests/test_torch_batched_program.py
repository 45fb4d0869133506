"""The batched dispatch as one program over a member axis: the port's
counterpart of the reference's `jax.jit(jax.vmap(fn, in_axes=(None,
0)))` (presto_tpu/exec/batching.py), on the CPU at sf 0.01.

  * fused_limb_sums_batched's plain version (what the wrapper takes for
    CPU tensors) against B calls of the unbatched plain version: lanes
    shared by every member and lanes per member, masks, ids outside
    [0, G), 128-bit pairs at +-(10^38 - 1), B = 1, 3 and 8; and the
    wrapper's refusals;
  * the custom op `presto_tpu_torch::fused_limb_sums` under
    torch.func.vmap against the same, its vmap rule calling the batched
    entry once;
  * a BatchParam under vmap (expr/compile.py): a NULL and a double
    passed as its float64's bit pattern;
  * each of the three families of scripts/loadgen.py at B = 3 through
    BatchingExecutor.bench_dispatch: its rows against the reference's
    vmapped executor's and the port's serial rows, with no collapse, the
    dashboard and the keyless sums calling the batched entry once and
    fused_limb_sums never; a family whose parameter is a double, NULL in
    one member; and a dashboard grouped and ordered by a DOUBLE, its key
    words bit casts of values with a member axis (ops/keys.py's
    double_bits, whose vmap rule works on the tensor under the axis);
  * every TPC-H template of tests/test_torch_batching.py::_tpch_texts at
    B = 2 as one program with no collapse, the second member with a
    literal of its own where the template lifts one, each member's rows
    against the reference's serial rows of its text and the port's.

The CUDA kernel is held against its plain version on the card by
chip_smoke.py (phase_fused, phase_batching).
"""

import numpy as np
import presto_tpu  # noqa: F401  (jax x64 before any array is made)
import pytest
import torch

from presto_tpu_torch import int128 as PI
from presto_tpu_torch.ops import kernels as K

R = K.LimbRequest
BIG = 10 ** 38 - 1
SF = 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: six xdist workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the batched plain version and the custom op ------------------------------

def _case(rng, batch, n=203, groups=5):
    """ids per member (some outside [0, G)), then sources: int8, int16
    and int32 lanes shared by every member, an int64 lane per member, a
    128-bit pair shared (first rows at +-(10^38 - 1)) and one per
    member, and a bool mask per member; requests over all of them,
    masked and not. Every per-member lane is (batch, n)."""
    ids = torch.from_numpy(rng.integers(-2, groups + 2, (batch, n))
                           .astype(np.int32))
    shared = [torch.from_numpy(rng.integers(np.iinfo(dt).min,
                                            np.iinfo(dt).max, n, dtype=dt,
                                            endpoint=True))
              for dt in (np.int8, np.int16, np.int32)]
    i64 = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, (batch, n)))

    def pair(count):
        vals = [int(v) * (1 << 64) + 777 for v in
                rng.integers(-(1 << 50), 1 << 50, count)]
        vals[:2] = [BIG, -BIG]
        hi, lo = PI.python_to_int128(vals)
        return torch.from_numpy(hi), torch.from_numpy(lo)

    shared_pair = pair(n)
    member_pairs = [pair(n) for _ in range(batch)]
    member_pair = (torch.stack([p[0] for p in member_pairs]),
                   torch.stack([p[1] for p in member_pairs]))
    mask = torch.from_numpy(rng.random((batch, n)) < 0.6)
    sources = [*shared, i64, shared_pair, member_pair, mask]
    m = len(sources) - 1
    reqs = [R(m, -1, 0, 1, True)]  # a count of the mask
    for i, width in enumerate((8, 16, 32, 64, 128, 128)):
        if width <= 64:
            reqs.append(R(i, m, 0, width, True))
        nl = -(-width // 13)
        reqs += [R(i, m if k % 2 else -1, 13 * k, 13, k == nl - 1)
                 for k in range(nl)]
    return ids, sources, reqs, groups


def _member_calls(ids, sources, reqs, groups, batch):
    def pick(t, b):
        return t[b] if t.dim() == 2 else t
    return torch.stack([K.fused_limb_sums_reference(
        pick(ids, b), [tuple(pick(t, b) for t in s) if isinstance(s, tuple)
                       else pick(s, b) for s in sources], reqs, groups)
        for b in range(batch)])


@pytest.mark.parametrize("batch", [1, 3, 8])
def test_batched_plain_version_equals_member_calls(batch):
    rng = np.random.default_rng(batch)
    ids, sources, reqs, groups = _case(rng, batch)
    want = _member_calls(ids, sources, reqs, groups, batch)
    got = K.fused_limb_sums_batched(ids, sources, reqs, groups, batch)
    assert got.shape == (batch, groups, len(reqs))
    assert torch.equal(got, want)
    assert torch.equal(K.fused_limb_sums_batched_reference(
        ids, sources, reqs, groups, batch), want)
    # shared ids: every member groups its rows alike
    got = K.fused_limb_sums_batched(ids[0], sources, reqs, groups, batch)
    assert torch.equal(got, _member_calls(ids[0], sources, reqs, groups,
                                          batch))


def test_batched_wrapper_refuses_a_bad_batch_or_lane():
    rng = np.random.default_rng(0)
    ids, sources, reqs, groups = _case(rng, 3)
    for bad in (0, K.FUSED_MAX_BATCH + 1):
        with pytest.raises(ValueError, match="batch must lie"):
            K.fused_limb_sums_batched(ids[0], sources[:3], reqs[:2], groups,
                                      bad)
    with pytest.raises(ValueError, match="per member"):
        K.fused_limb_sums_batched(ids, sources, reqs, groups, 2)
    with pytest.raises(ValueError, match="per member"):
        K.fused_limb_sums_batched(ids[:, None], sources, reqs, groups, 3)


@pytest.mark.parametrize("batch", [1, 3, 8])
def test_custom_op_under_vmap_runs_the_batched_entry_once(batch,
                                                          monkeypatch):
    rng = np.random.default_rng(10 + batch)
    ids, sources, reqs, groups = _case(rng, batch)
    calls = {"batched": 0, "plain": 0}
    batched, plain = K.fused_limb_sums_batched, K.fused_limb_sums

    def spy_batched(*a, **kw):
        calls["batched"] += 1
        return batched(*a, **kw)

    def spy_plain(*a, **kw):
        calls["plain"] += 1
        return plain(*a, **kw)

    monkeypatch.setattr(K, "fused_limb_sums_batched", spy_batched)
    monkeypatch.setattr(K, "fused_limb_sums", spy_plain)
    member = [s.dim() == 2 if not isinstance(s, tuple) else
              s[0].dim() == 2 for s in sources]
    mapped = [s for s, m in zip(sources, member) if m]
    fixed = [s for s, m in zip(sources, member) if not m]

    def one(i, per_member):
        it, rest = iter(per_member), iter(fixed)
        srcs = [next(it) if m else next(rest) for m in member]
        return K.fused_limb_sums_op(i, srcs, reqs, groups)

    got = torch.func.vmap(one, in_dims=(0, 0))(ids, mapped)
    assert calls == {"batched": 1, "plain": 0}
    assert torch.equal(got, _member_calls(ids, sources, reqs, groups, batch))
    # called plainly, the op is fused_limb_sums
    first = [tuple(t[0] for t in s) if isinstance(s, tuple) and
             s[0].dim() == 2 else s[0] if not isinstance(s, tuple) and
             s.dim() == 2 else s for s in sources]
    assert torch.equal(K.fused_limb_sums_op(ids[0], first, reqs, groups),
                       K.fused_limb_sums_reference(ids[0], first, reqs,
                                                   groups))
    assert calls["plain"] == 1


def test_double_bits_under_vmap_equals_the_view():
    """ops/keys.py's float64 -> int64 bit cast under torch.func.vmap
    (mapped on either axis, and nested) equals Tensor.view's bits: -0.0,
    NaN, infinities and a subnormal included."""
    from presto_tpu_torch.ops.keys import double_bits
    x = torch.tensor([[1.5, -0.0, float("nan"), 5e-324],
                      [float("inf"), -float("inf"), -3.25, 0.1]],
                     dtype=torch.float64)
    want = x.view(torch.int64)
    assert torch.equal(double_bits(x), want)
    assert torch.equal(torch.func.vmap(double_bits)(x), want)
    assert torch.equal(torch.func.vmap(double_bits, in_dims=1,
                                       out_dims=1)(x), want)
    assert torch.equal(torch.func.vmap(torch.func.vmap(double_bits))(x),
                       want)
    with pytest.raises(TypeError):
        double_bits(x.to(torch.float32))


def test_thread_launches_count_only_this_threads_launches():
    """A launch counts in LAUNCHES and in its own thread's counts only:
    a batch reads its program's launches from its thread's counts, which
    another thread's queries do not move."""
    import threading
    name = "fused_limb_sums_batched"
    total, mine = K.LAUNCHES[name], K.thread_launches()[name]
    try:
        other = threading.Thread(target=K._count, args=(name,))
        other.start()
        other.join()
        assert K.LAUNCHES[name] == total + 1
        assert K.thread_launches()[name] == mine
        K._count(name)
        assert K.LAUNCHES[name] == total + 2
        assert K.thread_launches()[name] == mine + 1
    finally:
        K.LAUNCHES[name] = total
        K.thread_launches()[name] = mine


# -- a BatchParam under vmap ---------------------------------------------------

def test_param_block_under_vmap_reads_nulls_and_doubles():
    """Three members' parameters bound under torch.func.vmap as
    exec/batching.py binds them: a double (its float64 read from the
    int64 bit pattern the parameters are stacked as, a NULL member) and
    a bigint; each block is the member's value expanded to the capacity,
    bit for bit, its nulls the member's."""
    from presto_tpu_torch import types as T
    from presto_tpu_torch.expr.compile import _param_block, bound_params
    from presto_tpu_torch.expr.ir import BatchParam
    doubles = np.array([2.5, -0.1, 0.0])
    vals = torch.from_numpy(np.stack([doubles.view(np.int64),
                                      np.array([7, -3, 1 << 40])], axis=1))
    nulls = torch.tensor([[False, False], [False, True], [True, False]])
    cap = 4

    def member(v, fv, nl):
        with bound_params([(fv[0], nl[0]), (v[1], nl[1])]):
            d = _param_block(BatchParam(T.DOUBLE, 0), cap, "cpu")
            i = _param_block(BatchParam(T.BIGINT, 1), cap, "cpu")
        return d.values, d.nulls, i.values, i.nulls

    dv, dn, iv, inl = torch.func.vmap(member, in_dims=(0, 0, 0))(
        vals, vals.view(torch.float64), nulls)
    assert dv.dtype == torch.float64 and dv.shape == (3, cap)
    assert np.array_equal(dv.numpy().view(np.int64),
                          np.repeat(doubles.view(np.int64)[:, None], cap, 1))
    assert dn.tolist() == [[False] * cap, [False] * cap, [True] * cap]
    assert iv.tolist() == [[7] * cap, [-3] * cap, [1 << 40] * cap]
    assert inl.tolist() == [[False] * cap, [True] * cap, [False] * cap]


# -- the three families and the TPC-H templates --------------------------------

LOOKUP = "SELECT custkey, name, acctbal FROM customer WHERE custkey = {}"
DASH = ("SELECT orderpriority, count(*) AS c, sum(totalprice) AS s "
        "FROM orders WHERE custkey = {} "
        "GROUP BY orderpriority ORDER BY orderpriority")
LINEITEM = ("SELECT sum(extendedprice * discount) FROM lineitem "
            "WHERE discount BETWEEN 0.05 AND 0.07 AND quantity < {}")
DOUBLES = ("SELECT count(*) AS c FROM lineitem "
           "WHERE CAST(quantity AS double) < {}")
BANDS = ("SELECT floor(CAST(totalprice AS double) / 100000) AS band, "
         "count(*) AS c, sum(totalprice) AS s FROM orders "
         "WHERE custkey = {} "
         "GROUP BY floor(CAST(totalprice AS double) / 100000) ORDER BY band")
_FAMILIES = {"lookup": (LOOKUP, (42, "NULL", 99999), 0),
             "dashboard": (DASH, (4, 10, 99999), 1),
             "bands": (BANDS, (4, 10, 99999), 0),
             "lineitem": (LINEITEM, (1, 24, 50), 1),
             "doubles": (DOUBLES, ("CAST(24.5 AS double)",
                                   "CAST(NULL AS double)",
                                   "CAST(10.0 AS double)"), 1)}


def _exact(res):
    from presto_tpu_torch import types as PT
    from presto_tpu_torch.queries import exact_rows
    types = [PT.parse_type(str(t)) for t in res.types]
    return (list(res.names), [str(t) for t in res.types],
            exact_rows(res.columns, res.nulls, types, res.row_count))


def _one_program(texts, monkeypatch, **kw):
    """`texts` as one batched dispatch of a fresh port executor: their
    results, and the calls of the batched entry and of fused_limb_sums
    the dispatch made, which must not have collapsed."""
    from presto_tpu_torch.exec.batching import (BatchingExecutor,
                                                batching_totals,
                                                clear_batching)
    calls = {"batched": 0, "plain": 0}
    batched, plain = K.fused_limb_sums_batched, K.fused_limb_sums

    def spy_batched(*a, **k):
        calls["batched"] += 1
        return batched(*a, **k)

    def spy_plain(*a, **k):
        calls["plain"] += 1
        return plain(*a, **k)

    clear_batching()
    monkeypatch.setattr(K, "fused_limb_sums_batched", spy_batched)
    monkeypatch.setattr(K, "fused_limb_sums", spy_plain)
    try:
        got = BatchingExecutor().bench_dispatch(texts, sf=SF, device="cpu",
                                                **kw)
    finally:
        monkeypatch.undo()
    t = batching_totals()
    assert t["collapses"] == {"failpoint": 0, "overflow": 0, "error": 0}
    # one program for the batch; on the CPU it launches no kernel
    assert all(r.stats["batch_programs"] == 1 and
               r.stats["batch_kernel_launches"] == 0 and
               r.query_stats.counters["batch_programs"] == 1 for r in got)
    assert t["batches"] == 1 and t["batched_queries"] == len(texts)
    clear_batching()
    return got, calls


def _serial(text, **kw):
    """The port's serial rows of `text` (its batching executor's own
    planning, run through run_query)."""
    from presto_tpu_torch.exec import run_query
    from presto_tpu_torch.exec.batching import BatchingExecutor
    prepared = BatchingExecutor()._prepare(
        text, sf=SF, session={}, catalog=None, device=torch.device("cpu"),
        max_groups=kw.get("max_groups"),
        join_capacity=kw.get("join_capacity"))[0]
    return run_query(prepared, sf=SF, device="cpu", prepared=True)


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_family_as_one_program_equals_the_reference_and_serial(
        family, monkeypatch):
    from presto_tpu.exec.batching import BatchingExecutor as RefExecutor
    from presto_tpu.exec.batching import clear_batching as ref_clear
    from presto_tpu_torch.ops import keys as KY
    template, keys, batched_calls = _FAMILIES[family]
    texts = [template.format(k) for k in keys]
    casts, cast = [], KY.double_bits

    def spy_cast(x):
        casts.append(torch._C._functorch.is_batchedtensor(x))
        return cast(x)

    monkeypatch.setattr(KY, "double_bits", spy_cast)
    got, calls = _one_program(texts, monkeypatch)
    assert calls == {"batched": batched_calls, "plain": 0}, calls
    # the bands' DOUBLE key words: bit casts of values with a member axis
    assert any(casts) == (family == "bands"), casts
    ref_clear()
    want = RefExecutor().bench_dispatch(texts, sf=SF)
    ref_clear()
    for text, g, w in zip(texts, got, want):
        assert _exact(g) == _exact(w), text
        assert _exact(g) == _exact(_serial(text)), text


def _tpch_texts():
    from presto_tpu.queries.tpch_sql import TPCH_QUERIES
    return [(f"q{n}", q.text, q.max_groups, q.join_capacity)
            for n, q in sorted(TPCH_QUERIES.items())]


_TPCH = _tpch_texts()

# the second member of each template that lifts a literal from its text:
# that literal moved, so that the members' rows differ (q11 and q22 lift
# only a literal of the planner's own, q13, q17, q18, q20 and q21 none:
# their members are the same text)
_SECOND = {
    "q1": ("interval '90' day", "interval '120' day"),
    "q2": ("p.size = 15", "p.size = 16"),
    "q3": ("o.orderdate < date '1995-03-15'",
           "o.orderdate < date '1995-03-01'"),
    "q4": ("date '1993-10-01'", "date '1993-09-01'"),
    "q5": ("date '1995-01-01'", "date '1994-07-01'"),
    "q6": ("quantity < 24", "quantity < 20"),
    "q7": ("date '1996-12-31'", "date '1995-12-31'"),
    "q8": ("date '1996-12-31'", "date '1995-12-31'"),
    "q9": ("(1 - l.discount)", "(2 - l.discount)"),
    "q10": ("date '1994-01-01'", "date '1993-12-01'"),
    "q12": ("date '1995-01-01'", "date '1994-07-01'"),
    "q14": ("date '1995-10-01'", "date '1995-09-16'"),
    "q15": ("date '1996-04-01'", "date '1996-03-01'"),
    "q16": ("45, 19", "45, 20"),
    "q19": ("BETWEEN 1 AND 11", "BETWEEN 1 AND 9"),
}


@pytest.mark.parametrize("name,text,max_groups,join_capacity", _TPCH,
                         ids=[t[0] for t in _TPCH])
def test_tpch_template_as_one_program_at_b2(name, text, max_groups,
                                            join_capacity, monkeypatch):
    """Two members of the template in one program, the second with its
    own literal where the template lifts one: each member's rows equal
    the reference's serial rows of its own text and the port's."""
    from presto_tpu.sql import sql as ref_sql
    kw = {k: v for k, v in (("max_groups", max_groups),
                            ("join_capacity", join_capacity))
          if v is not None}
    texts = [text, text]
    if name in _SECOND:
        old, new = _SECOND[name]
        assert old in text
        texts[1] = text.replace(old, new)
    got, _calls = _one_program(texts, monkeypatch, **kw)
    want = [_exact(ref_sql(t, sf=SF, session={"query_batching": "false"},
                           **kw)) for t in texts]
    if name in _SECOND:
        # members whose rows differ: a member axis mixed up shows
        assert want[0] != want[1], name
    for t, res, w in zip(texts, got, want):
        assert _exact(_serial(t, **kw)) == w, t
        assert _exact(res) == w, t


def test_hash_slot_ids_under_vmap_read_no_exit_flag():
    """The hash-slot group ids of three members under torch.func.vmap
    (each member's own active rows, the key words shared) equal each
    member's serial ids; under the batch every probe round runs and the
    exit flag is never read on the host, while a serial call reads it
    every _HASH_CHECK_EVERY rounds and stops early."""
    from presto_tpu_torch.ops import aggregation as PA
    rng = np.random.default_rng(7)
    n, groups = 3000, 200
    words = [torch.from_numpy(rng.integers(0, 150, n))]
    active = torch.from_numpy(rng.random((3, n)) < 0.7)
    serial = [PA._group_ids_hash(words, a, groups) for a in active]
    assert PA.HASH_STATS["exit_checks"] > 0
    assert PA.HASH_STATS["rounds"] < PA._MAX_PROBES
    got = torch.func.vmap(lambda a: PA._group_ids_hash(words, a, groups))(
        active)
    assert PA.HASH_STATS == {"rounds": PA._MAX_PROBES, "exit_checks": 0}
    for b, want in enumerate(serial):
        for g, w in zip(got, want):
            assert torch.equal(g[b], w)
