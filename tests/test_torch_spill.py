"""The port's spilled aggregation, spilled join, disk spill tier and
memory pool, on the CPU, against presto_tpu.

Plans are built with the reference's nodes (or its SQL front door),
prepared by its prepare_plan and sent to the port as plan-fragment
JSON. The spilled runs must equal the unspilled ones and the
reference's, bucket counts and spilled bytes must be the reference's,
run files must be gone after the query, and the same sequence of
reservations on both packages' MemoryPools must leave the same state.
"""

import os

import numpy as np
import pytest
import torch

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
from presto_tpu import types as RT
from presto_tpu.connectors import tpch as rtpch
from presto_tpu.exec import memory as RM
from presto_tpu.exec.runner import prepare_plan
from presto_tpu.exec.runner import run_query as ref_run_query
from presto_tpu.exec.spill import plan_state_bytes as ref_state_bytes
from presto_tpu.ops.aggregation import AggSpec
from presto_tpu.plan import nodes as RN
from presto_tpu.sql import plan_sql

from presto_tpu_torch import types as PT
from presto_tpu_torch.block import to_numpy
from presto_tpu_torch.exec import memory as PM
from presto_tpu_torch.exec import run_query
from presto_tpu_torch.exec.spill import (plan_state_bytes, run_spilled_join,
                                         spill_bucket_count)
from presto_tpu_torch.exec.streaming import streamable_agg_shape
from presto_tpu_torch.plan import from_json
from presto_tpu_torch.queries import exact_rows

SF = 0.01
NO_REFINE = {"stats_capacity_refinement": False}


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


def _exact(res):
    types = [PT.parse_type(str(t)) for t in res.types]
    return sorted(map(str, exact_rows(res.columns, res.nulls, types,
                                      res.row_count)))


@pytest.fixture(scope="module")
def agg_plan():
    """count, sum of quantity and min of extendedprice by orderkey
    (15,000 groups at sf 0.01) in a 32,768-slot table, prepared without
    the reference's NDV refinement; (plan JSON, the reference's rows)."""
    agg = RN.AggregationNode(
        _scan("lineitem", ["orderkey", "quantity", "extendedprice"]), [0], [
            AggSpec("count_star", None, RT.BIGINT),
            AggSpec("sum", 1, RT.decimal(38, 2)),
            AggSpec("min", 2, RT.decimal(12, 2))], max_groups=1 << 15)
    plan = prepare_plan(RN.OutputNode(agg, ["k", "c", "q", "mn"]), sf=SF,
                        session=NO_REFINE)
    j = RN.to_json(plan)
    assert streamable_agg_shape(from_json(j)) is not None
    return j, _exact(ref_run_query(plan, sf=SF, prepared=True,
                                   session=NO_REFINE))


def test_spilled_agg_equals_unspilled_and_the_reference(agg_plan):
    j, want = agg_plan
    (agg, _), rplan = streamable_agg_shape(from_json(j)), RN.from_json(j)
    ragg = rplan.source
    while not isinstance(ragg, RN.AggregationNode):
        ragg = ragg.source
    assert plan_state_bytes(agg) == ref_state_bytes(ragg)
    budget = plan_state_bytes(agg) // 4
    assert spill_bucket_count(plan_state_bytes(agg), budget) >= 8
    got = run_query(from_json(j), sf=SF, device="cpu", prepared=True,
                    split_rows=8192,
                    hbm_budget_bytes=budget)
    ref = ref_run_query(rplan, sf=SF, prepared=True, split_rows=8192,
                        hbm_budget_bytes=budget)
    unspilled = run_query(from_json(j), sf=SF, device="cpu", prepared=True)
    assert _exact(got) == _exact(ref) == _exact(unspilled) == want
    assert got.stats["spill_buckets"] == ref.stats["spill_buckets"]["total"]
    assert got.stats["spill_buckets"] >= 8
    assert got.stats["spilled_bytes"] == ref.stats["spilled_bytes"]["total"]
    assert "spilled_bytes" not in unspilled.stats


def test_spilled_agg_through_the_session_property(agg_plan):
    j, want = agg_plan
    got = run_query(from_json(j), sf=SF, device="cpu", prepared=True,
                    split_rows=8192,
                    session={"hbm_budget_bytes": 1 << 17})
    assert got.stats["spilled_bytes"] > 0
    assert _exact(got) == want
    # under a budget the table fits, the aggregation streams unspilled
    roomy = run_query(from_json(j), sf=SF, device="cpu", prepared=True,
                      split_rows=8192,
                      session={"hbm_budget_bytes": 1 << 40})
    assert "spilled_bytes" not in roomy.stats and roomy.stats["splits"] > 1
    assert _exact(roomy) == want


def test_spilled_join_equals_the_direct_join_and_the_reference():
    """lineitem x orders on orderkey in four buckets, against the
    port's direct join and the reference's (the reference's own
    spilled join compiles a join per bucket shape, ~13 s here)."""
    join = RN.JoinNode(_scan("lineitem", ["orderkey", "quantity"]),
                       _scan("orders", ["orderkey", "totalprice"]),
                       [0], [0], "inner")
    root = RN.OutputNode(join, ["k", "q", "k2", "tp"])
    stats = {}
    out = run_spilled_join(from_json(RN.to_json(join)), SF, 8192, 1 << 20,
                           "cpu", stats)
    direct = run_query(from_json(RN.to_json(root)), sf=SF, device="cpu",
                       default_join_capacity=1 << 18)
    ref = ref_run_query(prepare_plan(root, sf=SF), sf=SF, prepared=True,
                        default_join_capacity=1 << 18)
    act = out.active.numpy()
    cols = [to_numpy(c)[0] for c in out.columns]
    got = sorted(tuple(int(c[i]) for c in cols) for i in np.nonzero(act)[0])
    assert got == sorted(tuple(int(v) for v in r) for r in direct.rows()) \
        == sorted(tuple(int(v) for v in r) for r in ref.rows())
    assert len(got) == rtpch.table_row_count("lineitem", SF)
    # four buckets: each side partitioned into them, then each joined
    assert stats["spill_buckets"] == 12
    # every input row, then every output row, moved to the host: the
    # keys and quantity as int64, totalprice as int64, a NULL byte each
    n_li, n_o = len(got), rtpch.table_row_count("orders", SF)
    assert stats["spilled_bytes"] == n_li * 18 + n_o * 18 + len(got) * 36


def test_disk_spill_tier_round_trips_and_leaves_no_run_file(tmp_path):
    text = ("SELECT custkey, sum(totalprice) AS s, count(*) AS c "
            "FROM orders GROUP BY custkey")
    plan = prepare_plan(plan_sql(text, max_groups=1 << 11), sf=SF)
    want = ref_run_query(plan, sf=SF, prepared=True)
    spill_dir = str(tmp_path / "spill")
    session = {"hbm_budget_bytes": 1 << 16, "spill_path": spill_dir,
               "spill_file_threshold_bytes": 1 << 12}
    got = run_query(from_json(RN.to_json(plan)), sf=SF, device="cpu",
                    prepared=True,
                    split_rows=4096, session=session)
    assert _exact(got) == _exact(want)
    assert got.stats["spilled_to_disk_bytes"] > 0
    assert got.stats["spill_run_files"] >= 1
    assert os.listdir(spill_dir) == []


def _pool_sequence(mod):
    """One reserve/revoke/free sequence on a 1000-byte pool of `mod`;
    the pool, what was revoked, and whether the over-capacity reserve
    raised."""
    pool = mod.MemoryPool(1000)
    moved = []
    rid = pool.register_revocable("q1", 600, lambda: moved.append(600))
    pool.reserve("q2", 800)  # over capacity: q1's 600 are revoked first
    ctx = mod.MemoryContext(pool, "q3")
    ctx.set_bytes(150)
    ctx.set_bytes(100)
    raised = False
    try:
        pool.reserve("q4", 400)  # nothing left to revoke
    except mod.MemoryReservationError:
        raised = True
    state = (pool.reserved_bytes, pool.peak_bytes, pool.revoked_bytes,
             pool.query_bytes("q2"), pool.query_peak_bytes("q3"),
             pool.try_reserve("q5", 100), pool.free_bytes)
    pool.free("q2")
    ctx.close()
    pool.unregister_revocable(rid)  # already revoked: no effect
    return state + (pool.reserved_bytes, pool.peak_bytes,
                    pool.query_peak_bytes("q2", pop=True),
                    pool.query_peak_bytes("q2")), moved, raised


def test_memory_pool_sequence_leaves_the_reference_state():
    got, want = _pool_sequence(PM), _pool_sequence(RM)
    assert got == want
    assert got[1] == [600] and got[2]  # revoked, then refused
    pool = PM.MemoryPool(1000)
    rid = pool.register_revocable("q1", 400, lambda: None)
    pool.unregister_revocable(rid)
    assert pool.reserved_bytes == 0


def test_run_query_reserves_the_reference_scan_bytes(agg_plan):
    j, want = agg_plan
    pool, rpool = PM.MemoryPool(1 << 30), RM.MemoryPool(1 << 30)
    got = run_query(from_json(j), sf=SF, device="cpu", prepared=True,
                    memory_pool=pool,
                    query_id="a")
    ref = ref_run_query(RN.from_json(j), sf=SF, prepared=True,
                        memory_pool=rpool, query_id="a")
    assert _exact(got) == want
    assert got.stats["reserved_bytes"] == ref.stats["reserved_bytes"]["total"]
    assert got.stats["peak_reserved_bytes"] == \
        got.stats["reserved_bytes"] > 0
    assert pool.reserved_bytes == rpool.reserved_bytes == 0
    assert pool.peak_bytes == rpool.peak_bytes
    # a pool too small for the planned scan refuses before staging
    small = PM.MemoryPool(got.stats["reserved_bytes"] - 1)
    with pytest.raises(PM.MemoryReservationError):
        run_query(from_json(j), sf=SF, device="cpu", prepared=True,
                  memory_pool=small)
    assert small.reserved_bytes == 0
