"""Structured query telemetry and distributed tracing of the port
(presto_tpu_torch/exec/stats.py, server/tracing.py, plan/explain.py,
traceview.py) held against the reference's.

The reference's own cases run over the port's modules: those of
tests/test_query_telemetry.py and all of tests/test_trace_stitching.py,
less two of the first: XLA's cost analysis (the port has no source for
FLOPs and bytes accessed; its compile stage keeps the keys at 0.0, held
below) and EXPLAIN ANALYZE on the reference's JAX mesh fixture (run
below on the port's mesh of 8 CPU workers). Then, across the packages:
either package's coordinator over the other's workers merges one
QueryStats and stitches one trace, and EXPLAIN of every TPC-H text
equals the reference's `explain(..., regions=False)` line for line,
as planned and as execution shapes it.
"""

import re

import presto_tpu  # noqa: F401  (jax x64 before any array is made)
import pytest
import torch

from _torch_ledger_common import (all_test_names,  # noqa: F401
                                  fresh_ledgers, port_sql, reference_cases)

_LEFT_OUT = {"test_cost_analysis_flops_when_enabled",
             "test_explain_analyze_mesh_tpch_annotations"}

globals().update(reference_cases(
    "test_query_telemetry.py",
    [n for n in all_test_names("test_query_telemetry.py")
     if n not in _LEFT_OUT]))
globals().update(reference_cases("test_trace_stitching.py",
                                 all_test_names("test_trace_stitching.py")))

SF = 0.01
GROUP_BY = "SELECT custkey, count(*) AS c FROM orders GROUP BY custkey"


def test_a_kernel_build_inside_a_dispatch_is_compile_time(monkeypatch,
                                                          fresh_ledgers):
    """A dispatch that builds a kernel (ops/kernels.py's BUILD_SECONDS
    grows inside it) pays that build as the query's compile time,
    which the runner reads around the dispatch, and marks the
    profiler's row retraced. The plan is lowered afresh (an empty
    compiled-plan cache), through the lowering patched here."""
    from presto_tpu_torch.exec import plan_cache
    from presto_tpu_torch.exec.profiler import profile_snapshot
    from presto_tpu_torch.ops import kernels
    real = plan_cache.compile_plan

    def building(*a, **kw):
        plan = real(*a, **kw)
        fn = plan.fn

        def first_use(batches):
            kernels.BUILD_SECONDS["total"] += 0.05
            return fn(batches)
        plan.fn = first_use
        return plan

    monkeypatch.setattr(plan_cache, "compile_plan", building)
    plan_cache.clear_plan_cache()
    res = port_sql(GROUP_BY)
    qs = res.query_stats
    assert qs.stages["compile"].compile_us >= \
        min(50_000, qs.stages["execute"].wall_us)
    rows = [p for p in profile_snapshot() if p["tables"] == "tpch.orders"]
    assert len(rows) == 1 and rows[0]["calls"] == 1 and \
        rows[0]["retraces"] == 1


def test_compile_stage_keeps_the_cost_keys_at_zero():
    from presto_tpu_torch.exec.plan_cache import clear_plan_cache
    clear_plan_cache()  # a lowering: the compile stage is there
    qs = port_sql("SELECT sum(quantity) FROM lineitem").query_stats
    st = qs.stages["compile"]
    assert st.compile_us > 0 and st.flops == 0.0 and \
        st.bytes_accessed == 0.0
    assert set(st.to_json()) == {"name", "wall_us", "compile_us",
                                 "invocations", "rows", "bytes", "flops",
                                 "bytes_accessed", "max_wall_us"}


def test_explain_analyze_on_the_port_mesh():
    from presto_tpu_torch.parallel import make_mesh
    from presto_tpu_torch.plan import explain_analyze
    from presto_tpu_torch.sql import plan_sql
    mesh = make_mesh(8, devices=("cpu",) * 8)
    out = explain_analyze(plan_sql(
        "SELECT returnflag, linestatus, sum(quantity) AS q, count(*) AS c "
        "FROM lineitem WHERE shipdate <= date '1998-09-02' "
        "GROUP BY returnflag, linestatus"), sf=SF, mesh=mesh)
    scan_line = next(ln for ln in out.splitlines() if "TableScan" in ln)
    m = re.search(r"rows=(\d+)", scan_line)
    assert m and int(m.group(1)) > 0
    out_line = next(ln for ln in out.splitlines()
                    if ln.startswith("- Output"))
    assert "rows=4" in out_line
    assert re.search(r"staging: wall=\d+us", out)
    assert re.search(r"execute: wall=\d+us", out)
    assert re.search(r"compile: wall=\d+us compile=\d+us", out)
    # the mesh's exchanges were counted as they ran
    assert "exchange.hash: " in out and "exchanges: " in out
    assert "peak memory:" in out


# -- EXPLAIN of every TPC-H text ------------------------------------------

def _tpch(num):
    from presto_tpu.queries.tpch_sql import TPCH_QUERIES
    q = TPCH_QUERIES[num]
    kw = dict(max_groups=q.max_groups)
    if q.join_capacity:
        kw["join_capacity"] = q.join_capacity
    return q.text, kw


@pytest.mark.parametrize("num", range(1, 23))
def test_explain_equals_the_reference(num):
    from presto_tpu.plan import explain as ref_explain
    from presto_tpu.sql import plan_sql as ref_plan_sql

    from presto_tpu_torch.plan import explain
    from presto_tpu_torch.sql import plan_sql
    text, kw = _tpch(num)
    want = ref_explain(ref_plan_sql(text, **kw), regions=False, sf=SF)
    got = explain(plan_sql(text, **kw), sf=SF)
    assert got.splitlines() == want.splitlines()


@pytest.mark.parametrize("num", range(1, 23))
def test_explain_of_the_shaped_plan_equals_the_reference(num):
    from presto_tpu.exec.runner import prepare_plan as ref_prepare
    from presto_tpu.plan import explain as ref_explain
    from presto_tpu.sql import plan_sql as ref_plan_sql

    from presto_tpu_torch.plan import explain
    from presto_tpu_torch.sql import plan_sql
    text, kw = _tpch(num)
    want = ref_explain(ref_prepare(ref_plan_sql(text, **kw), sf=SF),
                       regions=False, sf=SF)
    got = explain(plan_sql(text, **kw), sf=SF, prepare=True)
    assert got.splitlines() == want.splitlines()


# -- either coordinator over the other's workers ---------------------------

@pytest.fixture(scope="module")
def crossed():
    from presto_tpu.server import TpuWorkerServer as RefWorker

    from presto_tpu_torch.server import TpuWorkerServer
    torch.set_num_threads(1)
    port = [TpuWorkerServer(sf=SF, device="cpu").start() for _ in range(2)]
    ref = [RefWorker(sf=SF).start() for _ in range(2)]
    yield [w.url for w in port], [w.url for w in ref]
    for w in port + ref:
        w.stop()


def _check_merged(qs, tracer, ctx, rows):
    assert qs is not None and qs.task_count >= 3
    assert qs.stages["execute"].invocations >= 3
    assert qs.stages["exchange"].invocations >= 3
    assert sum(o.output_rows for k, o in qs.operators.items()
               if k == "output") >= rows
    assert qs.datapath["device_put"].bytes > 0
    assert any(k.startswith("scan[0]:TableScan[tpch.orders]")
               for k in qs.accuracy)
    doc = tracer.trace_doc(ctx.trace_id)
    names = [s["name"] for s in doc["spans"]]
    assert "coordinator.execute" in names
    assert sum(n.startswith("task.") for n in names) >= 3
    assert "stage.execute" in names and "exchange.fetch" in names
    # every span hangs in the trace, coordinator.execute under the
    # caller's span
    ids = {s["spanId"] for s in doc["spans"]} | {ctx.span_id}
    orphans = [s["name"] for s in doc["spans"]
               if s["parentId"] is not None and s["parentId"] not in ids]
    assert orphans == []


def test_reference_coordinator_over_port_workers_merges_and_stitches(
        crossed):
    from presto_tpu.plan.distribute import add_exchanges
    from presto_tpu.server import Coordinator
    from presto_tpu.server.tracing import (RecordingTracer, TraceContext,
                                           new_span_id, set_tracer)
    from presto_tpu.sql import plan_sql
    tracer = RecordingTracer()
    set_tracer(tracer)
    try:
        ctx = TraceContext("cross.ref-over-port", new_span_id())
        coord = Coordinator(crossed[0])
        cols, _ = coord.execute(add_exchanges(plan_sql(
            GROUP_BY, max_groups=1 << 14)), sf=SF, trace_ctx=ctx)
        _check_merged(coord.last_query_stats, tracer, ctx,
                      len(cols[0][0]))
    finally:
        set_tracer(None)


def test_port_coordinator_over_reference_workers_merges_and_stitches(
        crossed):
    from presto_tpu_torch.plan.distribute import add_exchanges
    from presto_tpu_torch.server import Coordinator
    from presto_tpu_torch.server.tracing import (RecordingTracer,
                                                 TraceContext, new_span_id,
                                                 set_tracer)
    from presto_tpu_torch.sql import plan_sql
    tracer = RecordingTracer()
    set_tracer(tracer)
    try:
        ctx = TraceContext("cross.port-over-ref", new_span_id())
        coord = Coordinator(crossed[1])
        cols, _ = coord.execute(add_exchanges(plan_sql(
            GROUP_BY, max_groups=1 << 14)), sf=SF, trace_ctx=ctx)
        _check_merged(coord.last_query_stats, tracer, ctx,
                      len(cols[0][0]))
    finally:
        set_tracer(None)
