"""Split streaming, grouped execution, the spilled sort and the row hash
of the port, on the CPU, against presto_tpu.

Plans are built with the reference's nodes and cross to the port as
plan-fragment JSON; the reference's prepare_plan shapes them where its
run_query would. Rows must be equal exactly: streamed against the
reference's streamed and unsplit runs, each grouped-execution bucket's
keys against the reference's bucket, and every statement of the
reference's verifier corpus under split_rows=4096 against the
reference's "streaming" configuration.
"""

import numpy as np
import pytest
import torch

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
import jax.numpy as jnp
from presto_tpu import block as RB
from presto_tpu import types as RT
from presto_tpu.connectors import tpch as rtpch
from presto_tpu.exec.runner import prepare_plan
from presto_tpu.exec.runner import run_query as ref_run_query
from presto_tpu.exec.streaming import run_grouped_agg as ref_grouped
from presto_tpu.exec.streaming import run_spilled_sort as ref_sorted
from presto_tpu.expr import call, const, input_ref
from presto_tpu.expr.functions import combine_hash as ref_combine
from presto_tpu.expr.functions import hash64_block as ref_hash
from presto_tpu.ops.aggregation import AggSpec
from presto_tpu.parallel.exchange import _row_hash as ref_row_hash
from presto_tpu.plan import nodes as RN
from presto_tpu.sql import plan_sql
from presto_tpu.verifier import DEFAULT_CORPUS

from presto_tpu_torch import block as PB
from presto_tpu_torch import types as PT
from presto_tpu_torch.exec import run_query
from presto_tpu_torch.exec.streaming import (run_grouped_agg,
                                             run_spilled_sort,
                                             streamable_agg_shape)
from presto_tpu_torch.expr.functions import combine_hash, hash64_block
from presto_tpu_torch.parallel.exchange import bucket_of, row_hash
from presto_tpu_torch.plan import from_json
from presto_tpu_torch.queries import exact_rows

SF = 0.02
CORPUS_SF = 0.01


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while the module runs: the port's CPU plans are
    many small ops, which several threads a worker only oversubscribe
    under the parallel test run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scan(table, cols):
    return RN.TableScanNode("tpch", table, cols,
                            [rtpch.column_type(table, c) for c in cols])


def _q1_like():
    """returnflag's sum, count, min and avg of quantity where shipdate
    <= 1998-09-02: the reference's test_streaming.py plan."""
    s = _scan("lineitem", ["returnflag", "quantity", "shipdate"])
    f = RN.FilterNode(s, call("le", RT.BOOLEAN, input_ref(2, RT.DATE),
                              const("1998-09-02", RT.DATE)))
    agg = RN.AggregationNode(f, [0], [
        AggSpec("sum", 1, RT.decimal(38, 2)),
        AggSpec("count_star", None, RT.BIGINT),
        AggSpec("min", 1, RT.decimal(12, 2)),
        AggSpec("avg", 1, RT.decimal(12, 2))], max_groups=16)
    return RN.OutputNode(agg, ["rf", "sum_qty", "cnt", "min_qty", "avg_qty"])


def _exact(res):
    types = [PT.parse_type(str(t)) for t in res.types]
    return sorted(map(str, exact_rows(res.columns, res.nulls, types,
                                      res.row_count)))


@pytest.fixture(scope="module")
def q1_like():
    """(plan JSON, the reference's unsplit rows)."""
    plan = prepare_plan(_q1_like(), sf=SF)
    assert streamable_agg_shape(from_json(RN.to_json(plan))) is not None
    return RN.to_json(plan), _exact(ref_run_query(plan, sf=SF,
                                                  prepared=True))


@pytest.mark.parametrize("split_rows", [8192, 10000, 4096])
def test_streamed_rows_equal_the_reference(q1_like, split_rows):
    plan_json, whole = q1_like
    want = ref_run_query(RN.from_json(plan_json), sf=SF, prepared=True,
                         split_rows=split_rows)
    got = run_query(from_json(plan_json), sf=SF, device="cpu", prepared=True,
                    split_rows=split_rows)
    rows = rtpch.table_row_count("lineitem", SF)
    assert got.stats["splits"] == -(-rows // split_rows)
    assert _exact(got) == _exact(want) == whole
    unsplit = run_query(from_json(plan_json), sf=SF, device="cpu",
                        prepared=True)
    assert "splits" not in unsplit.stats
    assert _exact(unsplit) == whole


def test_grouped_execution_buckets_equal_the_reference():
    """orderkey's groups (30,000 at sf 0.02) in 8 buckets of 8192
    slots: each bucket holds the reference's bucket's keys and
    states, and together they are every group."""
    agg = RN.AggregationNode(_scan("lineitem", ["orderkey", "quantity"]),
                             [0], [AggSpec("sum", 1, RT.decimal(38, 2)),
                                   AggSpec("count_star", None, RT.BIGINT)],
                             max_groups=8192)
    root = RN.OutputNode(agg, ["orderkey", "sum_qty", "cnt"])
    want = ref_grouped(root, sf=SF, split_rows=16384, n_buckets=8)
    got = run_grouped_agg(from_json(RN.to_json(root)), SF, 16384, 8, "cpu")
    assert len(got) == len(want) == 8
    union = {}
    for g, w in zip(got, want):
        assert not bool(g.overflow) and not bool(np.asarray(w.overflow))
        gk = _bucket_rows(g.batch, PB.to_numpy, g.batch.active.numpy())
        wk = _bucket_rows(w.batch, RB.to_numpy, np.asarray(w.batch.active))
        assert gk == wk
        assert not set(gk) & set(union)  # buckets are disjoint
        union.update(gk)
    li = rtpch.generate_columns("lineitem", SF, ["orderkey", "quantity"])
    oracle = {}
    for ok, q in zip(li["orderkey"], li["quantity"]):
        s0, c0 = oracle.get(int(ok), (0, 0))
        oracle[int(ok)] = (s0 + int(q), c0 + 1)
    assert union == oracle


def _bucket_rows(batch, to_numpy, active):
    cols = [to_numpy(batch.column(c))[0] for c in range(3)]
    return {int(cols[0][i]): (int(cols[1][i]), int(cols[2][i]))
            for i in np.nonzero(active)[0]}


def test_spilled_sort_equals_the_reference():
    s = _scan("orders", ["orderkey", "totalprice"])
    f = RN.FilterNode(s, call("gt", RT.BOOLEAN,
                              input_ref(1, RT.decimal(15, 2)),
                              const(50000000, RT.decimal(15, 2))))
    plan = RN.OutputNode(RN.SortNode(f, [(1, True, True), (0, False, True)]),
                         ["orderkey", "totalprice"])
    want = ref_sorted(plan, sf=0.01, split_rows=4096)
    got = run_spilled_sort(from_json(RN.to_json(plan)), 0.01, 4096, "cpu")
    assert got[2] == want[2] == ["orderkey", "totalprice"]
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert g.tolist() == np.asarray(w).tolist()
    oc = rtpch.generate_columns("orders", 0.01, ["orderkey", "totalprice"])
    m = oc["totalprice"] > 50000000
    assert len(got[0][0]) == int(m.sum()) > 0


@pytest.mark.parametrize("i", range(len(DEFAULT_CORPUS)),
                         ids=lambda i: f"entry{i}")
def test_verifier_statement_under_split_rows_equals_the_reference(i):
    """The reference verifier's "streaming" configuration: sql(text,
    max_groups=1 << 14, split_rows=4096). A streamable statement
    streams in both packages, any other takes the normal path."""
    plan = prepare_plan(plan_sql(DEFAULT_CORPUS[i], max_groups=1 << 14),
                        sf=CORPUS_SF)
    want = ref_run_query(plan, sf=CORPUS_SF, prepared=True, split_rows=4096)
    got = run_query(from_json(RN.to_json(plan)), sf=CORPUS_SF,
                    device="cpu", prepared=True, split_rows=4096)
    assert got.names == list(want.names)
    assert _exact(got) == _exact(want)
    assert ("splits" in got.stats) == \
        (streamable_agg_shape(from_json(RN.to_json(plan))) is not None)


# ---------------------------------------------------------------------------
# the row hash that buckets rows
# ---------------------------------------------------------------------------

HASH_TYPES = ["boolean", "tinyint", "smallint", "integer", "bigint", "real",
              "double", "date", "decimal(12, 2)", "decimal(38, 2)",
              "varchar(12)", "dictionary"]
WORDS = ["", "a", "abcdefgh", "abcdefghi", "zz", "BUILDINGS", "héllo",
         "sixteen chars xy"]


def _hash_inputs(sig, seed, n=257):
    """One seeded column of `sig` with NULLs, staged by both packages."""
    rng = np.random.default_rng(seed)
    nulls = rng.random(n) < 0.1
    if sig == "dictionary":
        words = np.array(WORDS, dtype=object)
        idx = rng.integers(0, len(WORDS), n).astype(np.int32)
        rd = RB.from_numpy(RT.varchar(16), words)
        pd = PB.from_numpy(PT.varchar(16), words, device="cpu")
        return (RB.DictionaryColumn(jnp.asarray(idx), rd, jnp.asarray(nulls),
                                    RT.varchar(16)),
                PB.DictionaryColumn(torch.from_numpy(idx), pd,
                                    torch.from_numpy(nulls), PT.varchar(16)))
    rty, pty = RT.parse_type(sig), PT.parse_type(sig)
    if sig.startswith("varchar"):
        v = np.array([WORDS[i] for i in rng.integers(0, len(WORDS), n)],
                     dtype=object)
    elif sig == "decimal(38, 2)":
        v = np.array([int(x) * (1 << 70) + int(y) for x, y in
                      zip(rng.integers(-9, 9, n), rng.integers(0, 99, n))],
                     dtype=object)
    elif sig in ("real", "double"):
        v = rng.normal(size=n).astype(rty.to_dtype())
        v[:4] = [0.0, -0.0, np.nan, np.inf]
    elif sig == "boolean":
        v = rng.random(n) < 0.5
    else:
        info = np.iinfo(rty.to_dtype())
        v = rng.integers(max(info.min, -(1 << 40)), min(info.max, 1 << 40),
                         n).astype(rty.to_dtype())
    return (RB.from_numpy(rty, v, nulls),
            PB.from_numpy(pty, v, nulls, device="cpu"))


def _u64(t):
    return t.numpy().view(np.uint64) if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@pytest.mark.parametrize("sig", HASH_TYPES)
def test_row_hash_equals_the_reference_bit_for_bit(sig):
    """hash64_block of the column, combine_hash with a bigint column,
    the row hash of the pair, and its bucket among 8 and 7."""
    (r1, p1), (r2, p2) = _hash_inputs(sig, 1), _hash_inputs("bigint", 2)
    if sig != "dictionary":
        assert (_u64(hash64_block(p1)) == _u64(ref_hash(r1))).all()
    assert (_u64(combine_hash(hash64_block(p2), hash64_block(
        PB.decoded(p1)))) == _u64(ref_combine(ref_hash(r2), ref_hash(
            r1.decode() if sig == "dictionary" else r1)))).all()
    h, want = row_hash([p1, p2]), _u64(ref_row_hash([r1, r2]))
    assert (_u64(h) == want).all()
    for n in (8, 7):
        assert (bucket_of(h, n).numpy() == want % np.uint64(n)).all()
