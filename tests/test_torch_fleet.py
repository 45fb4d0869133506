"""The elastic fleet of the port: graceful drain with page migration,
discovery's fleet state and the coordinator failover
(presto_tpu_torch/server/{worker,buffers,discovery,resource_manager}.py)
against the reference's.

The drain and fleet cases of tests/test_elastic_fleet.py run through
the port: the migration's wire format and checksum, a drained
worker's pages replayed exactly once through its redirect (on an open
and on a secured cluster), the refusal of new tasks, a failed
migration that keeps the pages served, membership following discovery
(a DRAINING node takes no new task, nor one whose announced TTL ends
within the coordinator's horizon), a lost goodbye, the announcer's
backoff, the standby's exactly-once adoption, the lost heartbeat and
the router's standby, and the failpoint catalog. Then: a drain in the
middle of a distributed q1 (its PARTIAL pages migrated before the
FINAL pulls them, rows equal to one-device run_query), the reference's
Coordinator over port workers while one drains, the reference's client
following a port worker's redirect, and the buffers' wire format read
by the other package.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
from presto_tpu.server.buffers import SpoolingOutputBuffer as RefBuffer

from presto_tpu_torch import failpoints as fp
from presto_tpu_torch.exec import run_query
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.plan.fragment import (distribute_simple_agg,
                                            fragment_plan)
from presto_tpu_torch.server import Coordinator, TpuWorkerServer
from presto_tpu_torch.server.buffers import SpoolingOutputBuffer
from presto_tpu_torch.server.client import WorkerClient
from presto_tpu_torch.server.discovery import (Announcer, DiscoveryServer,
                                               alive_nodes,
                                               announce_retry_totals,
                                               fleet_membership_totals,
                                               recently_unannounced,
                                               reset_fleet_state)
from presto_tpu_torch.server.resource_manager import (ClusterStateSender,
                                                      ResourceManager,
                                                      StandbyCoordinator,
                                                      failover_totals,
                                                      reset_failover_totals)
from presto_tpu_torch.server.router import RouterServer
from presto_tpu_torch.server.statement import StatementServer
from presto_tpu_torch.sql import plan_sql, sql

SF = 0.01
Q1 = """
  SELECT returnflag, linestatus, sum(quantity) AS sum_qty,
         sum(extendedprice) AS sum_base_price, avg(discount) AS avg_disc,
         count(*) AS count_order
  FROM lineitem WHERE shipdate <= date '1998-09-02'
  GROUP BY returnflag, linestatus"""
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]


@pytest.fixture(autouse=True)
def _clean():
    torch.set_num_threads(1)
    fp.disarm_all()
    reset_fleet_state()  # other files' servers count into it too
    yield
    fp.disarm_all()
    # the goodbye registry is process-wide: a stale mark could hide a
    # later test's worker on a reused port
    reset_fleet_state()


def _wait_for(cond, timeout=10.0, step=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        v = cond()
        if v:
            return v
        time.sleep(step)
    raise AssertionError("condition not reached in time")


def _stop_all(*servers):
    for s in servers:
        try:
            s.stop()
        except Exception:  # noqa: BLE001 - already stopped
            pass


def _drained(client):
    st = client.drain_status()
    return st if st["state"] == "DRAINED" else None


def _worker(**kw):
    return TpuWorkerServer(sf=SF, device="cpu", **kw).start()


# -- the migration's wire format -------------------------------------------

@pytest.mark.parametrize("src_cls,dst_cls", [
    (SpoolingOutputBuffer, SpoolingOutputBuffer),
    (SpoolingOutputBuffer, RefBuffer), (RefBuffer, SpoolingOutputBuffer)],
    ids=["port", "port-to-reference", "reference-to-port"])
def test_buffer_export_restore_checksum_roundtrip(tmp_path, src_cls,
                                                  dst_cls):
    src = src_cls(memory_threshold_bytes=32, spool_dir=str(tmp_path))
    pages = [bytes([i]) * (20 + i) for i in range(5)]  # the tail spools
    src.extend(pages)
    assert src.spooled_bytes > 0
    src.drop_prefix(1)  # the acked prefix must not migrate
    want = src.stream_checksum()
    dst = dst_cls(memory_threshold_bytes=32, spool_dir=str(tmp_path))
    total = dst.restore_pages(src.export_pages())
    assert total == sum(len(p) for p in pages[1:])
    assert dst.stream_checksum() == want
    assert [dst.get(i) for i in range(len(dst))] == pages[1:]
    src.clear()
    dst.clear()


# -- the drain ---------------------------------------------------------------

@pytest.mark.parametrize("secret", [None, "fleet-secret"],
                         ids=["open", "secured"])
def test_drain_migrates_pages_exactly_once(secret):
    """A drained worker's pages replay byte for byte (the checksum
    before the drain equals the peer's after) and once (a second pull
    at the peer finds them acked: 410); on a secured cluster the
    migration hop and the redirected pull carry the secret."""
    w1, w2 = _worker(shared_secret=secret), _worker(shared_secret=secret)
    try:
        plan = plan_sql("SELECT regionkey, name FROM region")
        c1 = WorkerClient(w1.url, 30.0, shared_secret=secret)
        c1.submit("mig1", plan, sf=SF)
        assert c1.wait("mig1", 30)["state"] == "FINISHED"
        task = w1.manager.get("mig1")
        with task.lock:
            pre = {b: buf.stream_checksum() for b, buf in task.buffers.items()}
        st = c1.drain(migrate_to=w2.url, timeout_ms=15000)
        assert st["state"] in ("DRAINING", "DRAINED")
        st = _wait_for(lambda: _drained(c1), timeout=15)
        assert st["unreplayedPages"] == 0 and st["migratedPages"] >= 1
        atask = w2.manager.get("mig1")
        with atask.lock:
            post = {b: buf.stream_checksum()
                    for b, buf in atask.buffers.items()}
        assert post == pre
        assert w2.drain_status()["adoptedTasks"] == 1
        types = plan.output_types()
        cols = c1.fetch_results("mig1", types)
        assert len(cols[0][0]) == 5
        assert sorted(str(v) for v in cols[1][0]) == REGIONS
        with pytest.raises(urllib.error.HTTPError) as ei:
            WorkerClient(w2.url, 5.0, shared_secret=secret) \
                .fetch_results("mig1", types)
        assert ei.value.code == 410
    finally:
        _stop_all(w1, w2)


def test_drain_refuses_new_tasks_and_reports_fleet_state():
    w = _worker()
    try:
        c = WorkerClient(w.url, 10.0)
        assert c.status()["fleetState"] == "ACTIVE"
        c.drain(timeout_ms=5000)
        st = c.status()
        assert st["fleetState"] in ("DRAINING", "DRAINED")
        assert st["state"] == "SHUTTING_DOWN"
        with pytest.raises(urllib.error.HTTPError) as ei:
            c.submit("refused", plan_sql("SELECT 1"), sf=SF)
        assert ei.value.code == 503
        st = _wait_for(lambda: _drained(c), timeout=10)
        assert st["unreplayedPages"] == 0 and st["activeTasks"] == 0
    finally:
        _stop_all(w)


def test_graceful_shutdown_put_refuses_new_tasks():
    w = _worker()
    try:
        req = urllib.request.Request(f"{w.url}/v1/info/state", method="PUT",
                                     data=b'"SHUTTING_DOWN"')
        with urllib.request.urlopen(req, timeout=5) as r:
            assert json.loads(r.read()) == {"state": "SHUTTING_DOWN"}
        assert w.manager.drain_state == "DRAINING"
        with pytest.raises(urllib.error.HTTPError) as ei:
            WorkerClient(w.url, 5.0).submit("late", plan_sql("SELECT 1"),
                                            sf=SF)
        assert ei.value.code == 503
    finally:
        _stop_all(w)


def test_drain_migration_failure_keeps_pages_served_locally():
    """worker.drain_stall=error: the migration dies, the pages stay
    here and correct, and the worker does not claim DRAINED."""
    w1, w2 = _worker(), _worker()
    try:
        plan = plan_sql("SELECT regionkey FROM region")
        c1 = WorkerClient(w1.url, 30.0)
        c1.submit("stall1", plan, sf=SF)
        assert c1.wait("stall1", 30)["state"] == "FINISHED"
        fp.arm("worker.drain_stall", "error(OSError):once")
        c1.drain(migrate_to=w2.url, timeout_ms=600)
        time.sleep(1.2)  # past the budget
        st = c1.drain_status()
        assert st["state"] == "DRAINING"
        assert st["unreplayedPages"] >= 1
        assert w2.manager.get("stall1") is None
        cols = c1.fetch_results("stall1", plan.output_types())
        assert len(cols[0][0]) == 5
        assert fp.active()["worker.drain_stall"]["fires"] == 1
    finally:
        _stop_all(w1, w2)


def _q1_rows(cols):
    return sorted(tuple(v[i] if not m[i] else None for v, m in cols)
                  for i in range(len(cols[0][0])))


def test_drain_between_partial_and_final_of_q1():
    """q1's PARTIAL tasks finish on both workers; the first drains into
    the second before the FINAL pulls; the FINAL reads the migrated
    pages through the redirect, once: its rows equal one-device
    run_query, and the adopting peer holds the drained worker's pages
    byte for byte."""
    w1, w2 = _worker(), _worker()
    try:
        plan = distribute_simple_agg(plan_sql(Q1, max_groups=16))
        partial, final = fragment_plan(plan)
        scan = [n for n in _nodes(partial.root)
                if isinstance(n, N.TableScanNode)][0]
        from presto_tpu_torch.connectors import tpch
        total = tpch.table_row_count("lineitem", SF)
        half = total // 2
        ranges = [[0, half], [half, total - half]]
        tids = ["q1.p0", "q1.p1"]
        for w, tid, rng in zip((w1, w2), tids, ranges):
            WorkerClient(w.url, 60.0).submit_body(tid, {
                "plan": N.to_json(N.OutputNode(partial.root, [
                    f"c{i}" for i in range(len(partial.root.output_types()))
                ])), "sf": SF, "scanRanges": {scan.id: rng}})
        for w, tid in zip((w1, w2), tids):
            assert WorkerClient(w.url, 60.0).wait(tid, 60)["state"] == \
                "FINISHED"
        task = w1.manager.get(tids[0])
        with task.lock:
            pre = task.buffers[0].stream_checksum()
        WorkerClient(w1.url, 10.0).drain(migrate_to=w2.url, timeout_ms=15000)
        _wait_for(lambda: _drained(WorkerClient(w1.url, 10.0)), timeout=15)
        rn = [n for n in _nodes(final.root)
              if isinstance(n, N.RemoteSourceNode)][0]
        c2 = WorkerClient(w2.url, 60.0)
        c2.submit_body("q1.f", {
            "plan": N.to_json(final.root), "sf": SF,
            "remoteSources": {rn.id: {
                "sources": [w1.url, w2.url], "taskIds": tids,
                "types": [str(t) for t in rn.types], "ack": False}}})
        assert c2.wait("q1.f", 60)["state"] == "FINISHED"
        got = _q1_rows(c2.fetch_results("q1.f", final.root.output_types()))
        one = run_query(plan_sql(Q1, max_groups=16), sf=SF, device="cpu")
        assert got == sorted(one.rows())
        adopted = w2.manager.get(tids[0])
        with adopted.lock:
            assert adopted.buffers[0].stream_checksum() == pre
    finally:
        _stop_all(w1, w2)


def _nodes(root):
    out, stack = [], [root]
    while stack:
        n = stack.pop()
        out.append(n)
        stack.extend(n.sources)
    return out


def test_reference_client_follows_a_port_redirect():
    """The reference's WorkerClient pulls a drained port worker's task
    from the peer that adopted it."""
    from presto_tpu.server.client import WorkerClient as RefClient
    from presto_tpu.sql import plan_sql as ref_plan_sql
    w1, w2 = _worker(), _worker()
    try:
        plan = ref_plan_sql("SELECT regionkey, name FROM region")
        rc = RefClient(w1.url, 30.0)
        rc.submit("xmig", plan, sf=SF)
        assert rc.wait("xmig", 30)["state"] == "FINISHED"
        rc.drain(migrate_to=w2.url, timeout_ms=15000)
        _wait_for(lambda: rc.drain_status()["state"] == "DRAINED",
                  timeout=15)
        cols = rc.fetch_results("xmig", plan.output_types())
        assert sorted(str(v) for v in cols[1][0]) == REGIONS
    finally:
        _stop_all(w1, w2)


def test_reference_coordinator_over_port_workers_while_one_drains():
    """A port worker announces DRAINING to the port's discovery: the
    reference's Coordinator places no task on it, and q1's rows equal
    one-device run_query."""
    from presto_tpu.plan.fragment import distribute_simple_agg as ref_dsa
    from presto_tpu.server import Coordinator as RefCoordinator
    from presto_tpu.sql import plan_sql as ref_plan_sql
    disc = DiscoveryServer().start()
    w1 = _worker(discovery_url=disc.url, announce_interval_s=30.0)
    w2 = _worker(discovery_url=disc.url, announce_interval_s=30.0)
    try:
        _wait_for(lambda: len(alive_nodes(disc.url)) == 2)
        w1.begin_drain()
        coord = RefCoordinator(discovery_url=disc.url)
        assert coord.workers() == [w2.url]
        cols, _ = coord.execute(ref_dsa(ref_plan_sql(Q1, max_groups=16)),
                                sf=SF, timeout=60.0)
        one = run_query(plan_sql(Q1, max_groups=16), sf=SF, device="cpu")
        assert _q1_rows(cols) == sorted(one.rows())
        assert not w1.manager.tasks
    finally:
        _stop_all(w1, w2, disc)


# -- membership --------------------------------------------------------------

def test_workers_follow_discovery_join_leave_and_draining():
    disc = DiscoveryServer().start()
    w1 = _worker(discovery_url=disc.url, announce_interval_s=30.0)
    w2 = _worker(discovery_url=disc.url, announce_interval_s=30.0)
    try:
        _wait_for(lambda: len(alive_nodes(disc.url)) == 2)
        coord = Coordinator(discovery_url=disc.url)
        assert sorted(coord.workers()) == sorted([w1.url, w2.url])
        assert fleet_membership_totals()["joined"] == 2
        w2._announcer.set_state("DRAINING")
        w2._announcer.announce_once()
        assert coord.workers() == [w1.url]
        # never filtered down to an empty cluster
        w1._announcer.set_state("DRAINING")
        w1._announcer.announce_once()
        assert sorted(coord.workers()) == sorted([w1.url, w2.url])
        w2._announcer.set_state("ACTIVE")
        w2._announcer.announce_once()
        w1._announcer.unannounce_once()
        assert coord.workers() == [w2.url]
        assert fleet_membership_totals()["left"] == 1
        assert w1.url.rstrip("/") in recently_unannounced()
    finally:
        _stop_all(w1, w2, disc)


@pytest.mark.parametrize("package", ["port", "reference"])
def test_ttl_expiring_nodes_excluded_from_placement(package):
    """tests/test_ttl_tracing_session_defaults.py's case through the
    port's discovery, read by either package's Coordinator."""
    if package == "port":
        coord_cls = Coordinator
    else:
        from presto_tpu.server.coordinator import Coordinator as coord_cls
    disc = DiscoveryServer().start()
    try:
        fresh = Announcer(disc.url, "n-fresh", "http://w-fresh",
                          ttl_epoch_s=time.time() + 3600)
        dying = Announcer(disc.url, "n-dying", "http://w-dying",
                          ttl_epoch_s=time.time() + 5)
        fresh.announce_once()
        dying.announce_once()
        assert coord_cls(discovery_url=disc.url,
                         ttl_horizon_s=60.0).workers() == ["http://w-fresh"]
        # horizon off: both nodes take tasks
        assert sorted(coord_cls(discovery_url=disc.url,
                                ttl_horizon_s=0.0).workers()) == \
            ["http://w-dying", "http://w-fresh"]
        # never filtered down to an empty cluster
        fresh.stop(unannounce=True)
        assert coord_cls(discovery_url=disc.url,
                         ttl_horizon_s=60.0).workers() == ["http://w-dying"]
    finally:
        _stop_all(disc)


def test_unannounce_lost_failpoint_leaves_node_to_age_out():
    disc = DiscoveryServer().start()
    try:
        a = Announcer(disc.url, "ghost", "http://127.0.0.1:9", 30.0)
        a.announce_once()
        fp.arm("discovery.unannounce_lost", "error(OSError):once")
        a.stop(unannounce=True)
        assert fp.active()["discovery.unannounce_lost"]["fires"] == 1
        assert any(n["nodeId"] == "ghost"
                   for n in alive_nodes(disc.url, max_age_s=1e9))
    finally:
        _stop_all(disc)


def test_announcer_backoff_retries_then_recovers():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    a = Announcer(f"http://127.0.0.1:{port}", "late-node",
                  "http://127.0.0.1:9", interval_s=60.0)
    a.start()
    disc = None
    try:
        _wait_for(lambda: announce_retry_totals() >= 2, timeout=10)
        disc = DiscoveryServer(port=port).start()
        _wait_for(lambda: any(
            n["nodeId"] == "late-node"
            for n in alive_nodes(disc.url, max_age_s=1e9)), timeout=10)
    finally:
        a.stop(unannounce=False)
        if disc is not None:
            _stop_all(disc)


# -- coordinator failover ----------------------------------------------------

def test_standby_adopts_inflight_queries_exactly_once():
    reset_failover_totals()
    rm = ResourceManager(heartbeat_ttl_s=1.0).start()
    gate = threading.Event()

    def wedged_executor(text, session_values, query_id, txn_id):
        gate.wait(20)
        return sql(text, sf=SF, device="cpu")

    primary = StatementServer(sf=SF, executor=wedged_executor,
                              queue_poll_s=0.05, device="cpu").start()
    standby = StatementServer(sf=SF, queue_poll_s=0.05,
                              device="cpu").start()
    try:
        sender = ClusterStateSender(rm.url, "primary", primary.dispatcher,
                                    inflight_fn=primary.inflight_doc)
        monitor = StandbyCoordinator(rm.url, "primary", standby, ttl_s=0.4)
        from presto_tpu_torch.client import StatementClient
        c = StatementClient(primary.url, "SELECT count(*) FROM region")
        qid = c.query_id
        with primary._qlock:
            slug = primary._queries[qid].slug
        _wait_for(lambda: primary.inflight_doc())
        sender.send_once()
        assert monitor.check_once() is False  # the primary is alive
        time.sleep(1.1)                       # its heartbeat lapses
        assert monitor.check_once() is True
        assert failover_totals() == 1
        assert monitor.check_once() is False  # once
        assert monitor.is_primary
        q = standby.get_query(qid, slug)      # the same id and slug
        assert q is not None
        q.machine.wait_done(20)
        assert q.machine.state == "FINISHED" and q.rows == [[5]]
        assert standby.adopt_query(qid, slug, "SELECT 1", "x", {}) is q
    finally:
        gate.set()
        _stop_all(primary, standby, rm)


def test_heartbeat_lapse_failpoint_and_router_standby_promotion():
    rm = ResourceManager(heartbeat_ttl_s=5.0).start()
    primary = StatementServer(sf=SF, queue_poll_s=0.05, device="cpu").start()
    standby = StatementServer(sf=SF, queue_poll_s=0.05, device="cpu").start()
    router = RouterServer([{"url": primary.url, "kind": "tpu"},
                           {"url": standby.url, "kind": "standby"}],
                          health_ttl_s=0.0).start()
    try:
        sender = ClusterStateSender(rm.url, "p1", primary.dispatcher)
        fp.arm("coordinator.heartbeat_lapse", "error(OSError):once")
        with pytest.raises(OSError):
            sender.send_once()
        assert fp.active()["coordinator.heartbeat_lapse"]["fires"] == 1
        sender.send_once()
        with urllib.request.urlopen(f"{rm.url}/v1/resourcemanager",
                                    timeout=5) as r:
            assert "p1" in json.loads(r.read())["coordinators"]
        assert router.pick("SELECT 1").url == primary.url.rstrip("/")
        primary.stop()
        assert router.pick("SELECT 1").url == standby.url.rstrip("/")
    finally:
        _stop_all(router, primary, standby, rm)


def test_new_failpoint_sites_cataloged():
    from presto_tpu.failpoints import SITES as REF_SITES
    from presto_tpu_torch.failpoints import SITES, sites_by_layer
    for site in ("discovery.unannounce_lost", "worker.drain_stall",
                 "coordinator.heartbeat_lapse"):
        assert SITES[site] == REF_SITES[site]
    by_layer = sites_by_layer()
    assert "worker.drain_stall" in by_layer["fleet"]
    assert "coordinator.heartbeat_lapse" in by_layer["fleet"]
    assert "discovery.unannounce_lost" in by_layer["discovery"]
