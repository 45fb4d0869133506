"""The port's worker (presto_tpu_torch/server/worker.py) against the
reference's.

A port worker on the CPU and a reference worker run the same
fragments (the reference's plan JSON): q1's PARTIAL over a scan range,
`orders` hash-partitioned by custkey into 4 output buffers, and a
result buffer spooled to disk. Their result pages must be byte-equal,
buffer by buffer. Then the token/ack/410 contract and DELETE, the
fragment cache's hits and invalidation (tests/test_fragment_cache.py)
and the task slots (tests/test_worker_concurrency.py), on the port.
"""

import threading
import time

import numpy as np
import pytest
import torch

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
from presto_tpu.plan import nodes as RN
from presto_tpu.plan.fragment import distribute_simple_agg, fragment_plan
from presto_tpu.server import TpuWorkerServer as RefWorker
from presto_tpu.sql import plan_sql as ref_plan_sql

from presto_tpu_torch import types as T
from presto_tpu_torch.connectors import memory
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.server import TaskManager, TpuWorkerServer, WorkerClient
from presto_tpu_torch.sql import plan_sql

SF = 0.01
Q1 = """
  SELECT returnflag, linestatus, sum(quantity) AS sum_qty,
         sum(extendedprice) AS sum_base_price, avg(discount) AS avg_disc,
         count(*) AS count_order
  FROM lineitem WHERE shipdate <= date '1998-09-02'
  GROUP BY returnflag, linestatus"""


@pytest.fixture(scope="module")
def workers():
    torch.set_num_threads(2)
    port = TpuWorkerServer(sf=SF, device="cpu").start()
    ref = RefWorker(sf=SF).start()
    yield port, ref
    port.stop()
    ref.stop()


def _pages(url, task_id, buffer_id=0):
    """The raw pages of one buffer, pulled without acks."""
    c = WorkerClient(url, 60.0)
    assert c.wait(task_id, 60.0)["state"] == "FINISHED"
    out, token = [], 0
    while True:
        data, headers = c._request(
            "GET", f"/v1/task/{task_id}/results/{buffer_id}/{token}")
        if data:
            out.append(data)
            token = int(headers["X-Presto-Page-Next-Token"])
        elif headers["X-Presto-Buffer-Complete"] == "true":
            return out
        else:
            time.sleep(0.02)


def _both(workers, task_id, body, buffers=(0,)):
    port, ref = workers
    for w in (port, ref):
        WorkerClient(w.url, 60.0).submit_body(task_id, body)
    out = {b: (_pages(port.url, task_id, b), _pages(ref.url, task_id, b))
           for b in buffers}
    for w in (port, ref):
        WorkerClient(w.url, 60.0).abort(task_id)
    return out


def _scan_ids(plan_json):
    out = []

    def walk(j):
        if isinstance(j, dict):
            if j.get("@type") == "tablescan":
                out.append(j["id"])
            for v in j.values():
                walk(v)
        elif isinstance(j, list):
            for v in j:
                walk(v)
    walk(plan_json)
    return out


def test_q1_partial_pages_byte_equal(workers):
    frags = fragment_plan(distribute_simple_agg(ref_plan_sql(Q1,
                                                             max_groups=16)))
    leaf = frags[0].root
    plan = RN.to_json(RN.OutputNode(leaf, [
        f"c{i}" for i in range(len(leaf.output_types()))]))
    scan, = _scan_ids(plan)
    body = {"plan": plan, "sf": SF, "scanRanges": {scan: [10000, 25000]}}
    (port_pages, ref_pages), = _both(workers, "q1-partial", body).values()
    assert len(port_pages) == len(ref_pages) == 1
    assert port_pages == ref_pages


@pytest.mark.parametrize("codec", ["none", "zstd", "zlib"])
def test_hash_partitioned_orders_pages_byte_equal(workers, codec):
    cols = ["orderkey", "custkey", "totalprice", "orderpriority"]
    from presto_tpu.connectors import tpch as rtpch
    scan = RN.TableScanNode("tpch", "orders", cols,
                            [rtpch.column_type("orders", c) for c in cols])
    plan = RN.to_json(RN.OutputNode(scan, cols))
    body = {"plan": plan, "sf": SF,
            "session": {"exchange_compression": codec},
            "outputPartitions": {"count": 4, "channels": [1]}}
    pages = _both(workers, f"orders-hash-{codec}", body, buffers=range(4))
    rows = 0
    for b, (p, r) in pages.items():
        assert len(p) == len(r) == 1, b
        assert p == r, b
        rows += int.from_bytes(p[0][:4], "little")
    assert rows == 15000


def test_spooled_buffer_pages_byte_equal(workers):
    port, ref = workers
    for w in (port, ref):
        w.manager.output_spool_threshold_bytes = 1  # every page spools
    try:
        plan = RN.to_json(ref_plan_sql(
            "SELECT name, regionkey FROM nation ORDER BY name"))
        (p, r), = _both(workers, "spooled", {"plan": plan, "sf": SF}).values()
    finally:
        for w in (port, ref):
            w.manager.output_spool_threshold_bytes = 64 << 20
    assert p == r and len(p) == 1


def test_spooled_pages_live_on_disk():
    mgr = TaskManager(sf=SF, device="cpu", output_spool_threshold_bytes=1)
    info = mgr.create_or_update("t-spool", {
        "plan": N.to_json(plan_sql("SELECT name FROM nation")), "sf": SF})
    assert info["taskId"] == "t-spool"
    _wait_state(mgr, "t-spool", ("FINISHED",), timeout=30)
    doc = mgr.get("t-spool").info()
    assert doc["spooledBytes"] > 0 and doc["bufferedPages"] == 1
    page, nxt, complete = mgr.results("t-spool", 0)
    assert page and nxt == 1 and not complete


def test_token_ack_gone_and_delete(workers):
    port, _ = workers
    c = WorkerClient(port.url, 30.0)
    c.submit("t-ack", plan_sql("SELECT regionkey FROM region"), sf=SF)
    assert c.wait("t-ack", 30)["state"] == "FINISHED"
    data, h = c._request("GET", "/v1/task/t-ack/results/0/0")
    assert data and h["X-Presto-Page-Token"] == "0"
    assert h["X-Presto-Page-Next-Token"] == "1"
    assert h["X-Presto-Buffer-Complete"] == "false"
    # the same token again re-reads (no ack yet)
    again, _ = c._request("GET", "/v1/task/t-ack/results/0/0")
    assert again == data
    c._request("GET", "/v1/task/t-ack/results/0/1/acknowledge")
    # token 0 was acked away: 410
    import urllib.error
    with pytest.raises(urllib.error.HTTPError) as ei:
        c._request("GET", "/v1/task/t-ack/results/0/0")
    assert ei.value.code == 410
    data, h = c._request("GET", "/v1/task/t-ack/results/0/1")
    assert not data and h["X-Presto-Buffer-Complete"] == "true"
    # an unknown task is 404
    with pytest.raises(urllib.error.HTTPError) as ei:
        c._request("GET", "/v1/task/no-such/results/0/0")
    assert ei.value.code == 404
    # DELETE aborts and drops the buffers
    c.submit("t-del", plan_sql("SELECT regionkey FROM region"), sf=SF)
    c.wait("t-del", 30)
    info = c.abort("t-del")
    assert info["state"] == "FINISHED" and info["bufferedPages"] == 0
    (v, _), = c.fetch_results("t-del", [T.BIGINT])
    assert len(v) == 0


def test_fetch_results_with_acks(workers):
    port, _ = workers
    c = WorkerClient(port.url, 30.0)
    c.submit("t-fetch", plan_sql("SELECT regionkey, name FROM region "
                                 "ORDER BY regionkey"), sf=SF)
    c.wait("t-fetch", 30)
    (k, _), (n, _) = c.fetch_results("t-fetch", [T.BIGINT, T.varchar(25)])
    assert list(k) == [0, 1, 2, 3, 4]
    assert list(n) == ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
    assert c.task_info("t-fetch")["bufferedPages"] == 0  # acked away


def test_info_and_status(workers):
    port, _ = workers
    c = WorkerClient(port.url)
    assert c.info()["state"] == "ACTIVE"
    st = c.status()
    assert st["device"] == "cpu" and "memory" in st


def test_worker_without_cuda_refuses_to_start():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TpuWorkerServer(sf=SF)


# -- the fragment result cache (tests/test_fragment_cache.py) -----------

def test_hit_replay_and_version_invalidation():
    memory.reset()
    memory.create_table("fc", ["x"], [T.BIGINT])
    h = memory.begin_insert("fc")
    memory.append(h, [np.array([1, 2, 3], dtype=np.int64)])
    memory.finish_insert(h)
    w = TpuWorkerServer(sf=SF, device="cpu").start()
    try:
        c = WorkerClient(w.url)
        plan = plan_sql("SELECT sum(x) AS s FROM fc", catalog="memory")
        c.submit("fc-1", plan, sf=SF)
        c.wait("fc-1", 30)
        cache = w.manager.fragment_cache
        assert cache.misses >= 1 and cache.hits == 0
        types = plan.output_types()
        (v1, _), = c.fetch_results("fc-1", types)
        c.submit("fc-2", plan_sql("SELECT sum(x) AS s FROM fc",
                                  catalog="memory"), sf=SF)
        info = c.wait("fc-2", 30)
        assert info["stats"].get("fragmentCacheHit") == 1
        assert cache.hits == 1
        (v2, _), = c.fetch_results("fc-2", types)
        assert list(v1) == list(v2) == [6]
        h = memory.begin_insert("fc")
        memory.append(h, [np.array([10], dtype=np.int64)])
        memory.finish_insert(h)
        c.submit("fc-3", plan_sql("SELECT sum(x) AS s FROM fc",
                                  catalog="memory"), sf=SF)
        info = c.wait("fc-3", 30)
        assert "fragmentCacheHit" not in info["stats"]
        (v3, _), = c.fetch_results("fc-3", types)
        assert list(v3) == [16]
    finally:
        w.stop()
        memory.reset()


def test_generator_scans_cache_by_sf():
    w = TpuWorkerServer(sf=SF, device="cpu").start()
    try:
        c = WorkerClient(w.url)
        c.submit("g-1", plan_sql("SELECT count(*) AS n FROM nation"), sf=SF)
        c.wait("g-1", 30)
        c.submit("g-2", plan_sql("SELECT count(*) AS n FROM nation"), sf=SF)
        assert c.wait("g-2", 30)["stats"].get("fragmentCacheHit") == 1
        c.submit("g-3", plan_sql("SELECT count(*) AS n FROM nation"),
                 sf=0.02)
        assert "fragmentCacheHit" not in c.wait("g-3", 30)["stats"]
        # a catalog without data_version is not cached
        key = w.manager.fragment_cache.key_of(
            plan_sql("SELECT count(*) AS n FROM information_schema.tables"),
            SF, {}, None, None)
        assert key is None
    finally:
        w.stop()


def test_write_and_ddl_fragments_never_cache():
    from presto_tpu_torch.server.worker import FragmentResultCache
    memory.reset()
    memory.create_table("wfc", ["x"], [T.BIGINT])
    for text in ("INSERT INTO memory.wfc VALUES (1)",
                 "DROP TABLE memory.wfc"):
        assert FragmentResultCache.key_of(plan_sql(text), SF, {}, None,
                                          None) is None, text
    memory.reset()


# -- task slots (tests/test_worker_concurrency.py) -----------------------

def _plan(marker: str):
    return N.to_json(N.OutputNode(N.ValuesNode([T.BIGINT], [[1]]),
                                  [marker]))


class _FakeResult:
    row_count = 1
    columns = [np.array([1], dtype=np.int64)]
    nulls = [np.array([False])]
    types = [T.BIGINT]
    stats = {}


def _patched_run_query(monkeypatch, durations):
    """run_query stubbed by the plan's output name, recording each
    marker's (start, end) wall times."""
    import presto_tpu_torch.exec.runner as runner
    spans = {}

    def fake(plan, **kw):
        marker = plan.names[0]
        spans[marker] = [time.time(), None]
        time.sleep(durations[marker])
        spans[marker][1] = time.time()
        return _FakeResult()

    monkeypatch.setattr(runner, "run_query", fake)
    return spans


def _submit(mgr, tid, marker):
    return mgr.create_or_update(tid, {
        "plan": _plan(marker),
        "session": {"tpu_execution_enabled": True,
                    "fragment_result_cache": False}})


def _wait_state(mgr, tid, want, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        t = mgr.get(tid)
        if t is not None and t.info()["state"] in want:
            return t.info()["state"]
        time.sleep(0.01)
    raise AssertionError(f"task {tid} never reached {want}")


def test_short_task_passes_long_task(monkeypatch):
    mgr = TaskManager(task_concurrency=2, device="cpu")
    spans = _patched_run_query(monkeypatch, {"long": 1.5, "short": 0.05})
    _submit(mgr, "t-long", "long")
    time.sleep(0.1)
    _submit(mgr, "t-short", "short")
    _wait_state(mgr, "t-short", ("FINISHED",), timeout=5)
    assert mgr.get("t-long").info()["state"] == "RUNNING"
    _wait_state(mgr, "t-long", ("FINISHED",), timeout=5)
    assert spans["short"][1] < spans["long"][1]


def test_concurrency_one_serializes(monkeypatch):
    mgr = TaskManager(task_concurrency=1, device="cpu")
    spans = _patched_run_query(monkeypatch, {"a": 0.4, "b": 0.05})
    _submit(mgr, "t-a", "a")
    time.sleep(0.1)
    _submit(mgr, "t-b", "b")
    _wait_state(mgr, "t-b", ("FINISHED",), timeout=5)
    assert spans["b"][0] >= spans["a"][1] - 0.01


def test_two_concurrent_tasks_both_progress(monkeypatch):
    mgr = TaskManager(task_concurrency=2, device="cpu")
    spans = _patched_run_query(monkeypatch, {"x": 0.4, "y": 0.4})
    _submit(mgr, "t-x", "x")
    _submit(mgr, "t-y", "y")
    _wait_state(mgr, "t-x", ("FINISHED",), timeout=5)
    _wait_state(mgr, "t-y", ("FINISHED",), timeout=5)
    overlap = min(spans["x"][1], spans["y"][1]) - max(spans["x"][0],
                                                      spans["y"][0])
    assert overlap > 0.2


def test_tpu_execution_disabled_refuses_the_fragment():
    mgr = TaskManager(device="cpu")
    mgr.create_or_update("t-off", {
        "plan": _plan("m"), "session": {"tpu_execution_enabled": "false"}})
    _wait_state(mgr, "t-off", ("FAILED",), timeout=5)
    assert "tpu_execution_enabled" in mgr.get("t-off").info()["error"]


def test_memory_pool_blocking_admission():
    """A contended reserve waits for a release; one beyond the
    capacity fails at once."""
    from presto_tpu_torch.exec.memory import (MemoryPool,
                                              MemoryReservationError)
    pool = MemoryPool(100, admission_timeout_s=5.0)
    pool.reserve("a", 80)
    t = threading.Timer(0.2, lambda: pool.free("a"))
    t.start()
    t0 = time.time()
    pool.reserve("b", 50)
    assert time.time() - t0 >= 0.15
    pool.free("b")
    with pytest.raises(MemoryReservationError):
        pool.reserve("c", 101)
    p2 = MemoryPool(100)
    p2.reserve("a", 80)
    with pytest.raises(MemoryReservationError):
        p2.reserve("b", 50)


def test_requests_do_not_wait_for_delayed_acks(workers):
    """A worker answers without Nagle's algorithm (TCP_NODELAY): with
    it, each keep-alive request waited ~40 ms for the client's delayed
    ACK."""
    port, _ = workers
    c = WorkerClient(port.url)
    c.info()
    t0 = time.perf_counter()
    for _ in range(20):
        c.info()
    assert time.perf_counter() - t0 < 0.4


def test_tpcds_scan_ranges_stage_their_rows():
    """A scan range of a TPC-DS fact table stages exactly those rows."""
    from presto_tpu_torch.connectors import tpcds
    from presto_tpu_torch.exec import run_query
    cols = ["ss_item_sk", "ss_quantity"]
    scan = N.TableScanNode("tpcds", "store_sales", cols,
                           [tpcds.column_type("store_sales", c)
                            for c in cols])
    whole = tpcds.generate_columns("store_sales", SF, cols)
    res = run_query(N.OutputNode(scan, cols), sf=SF, device="cpu",
                    prepared=True, scan_ranges={scan.id: (1000, 2500)})
    assert res.row_count == 2500
    for c, name in enumerate(cols):
        np.testing.assert_array_equal(res.columns[c],
                                      whole[name][1000:3500])


def test_worker_on_a_mesh_runs_fragments():
    """A worker whose tasks run on a mesh of two CPU workers (the
    mesh's scans cut into shards, a remote source padded to 8 x its
    size) beside a one-device worker: q1 through the coordinator
    equals one device."""
    from presto_tpu_torch.exec import run_query
    from presto_tpu_torch.parallel import make_mesh
    from presto_tpu_torch.plan.fragment import distribute_simple_agg
    from presto_tpu_torch.server import Coordinator
    mesh_worker = TpuWorkerServer(
        sf=SF, mesh=make_mesh(2, devices=("cpu", "cpu"))).start()
    one = TpuWorkerServer(sf=SF, device="cpu").start()
    try:
        for text in (Q1, "SELECT count(*) AS n, sum(totalprice) AS s "
                         "FROM orders"):
            want = sorted(run_query(plan_sql(text, max_groups=16), sf=SF,
                                    device="cpu").rows())
            for urls in ([mesh_worker.url, one.url],
                         [one.url, mesh_worker.url]):
                cols, _ = Coordinator(urls).execute(
                    distribute_simple_agg(plan_sql(text, max_groups=16)),
                    sf=SF)
                got = sorted(zip(*[[None if m else v
                                    for v, m in zip(vs, ms)]
                                   for vs, ms in cols]))
                assert got == want, (text, urls)
    finally:
        mesh_worker.stop()
        one.stop()
