"""The port's resource manager, router and catalog server
(presto_tpu_torch/server/{resource_manager,dispatcher,router,
catalog_server}.py) against the reference's.

The cases of tests/test_resource_manager.py, tests/test_router.py and
tests/test_catalog_server.py run through the port (statement servers
on the CPU). Then across the packages: the reference's heartbeat and
load view against the port's resource manager, the reference's
remote-catalog proxy against the port's catalog server, and the port's
plan checker against the reference's.
"""

import threading
import time
import urllib.request
import json

import pytest
import torch

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)

from presto_tpu_torch import types as T
from presto_tpu_torch.client import QueryError, execute
from presto_tpu_torch.server.catalog_server import (CatalogServer,
                                                    register_remote_catalog,
                                                    unregister_remote_catalog)
from presto_tpu_torch.server.dispatcher import (Dispatcher, QueryRejected,
                                                ResourceGroup)
from presto_tpu_torch.server.resource_manager import (ClusterStateSender,
                                                      ResourceManager,
                                                      remote_group_load)
from presto_tpu_torch.server.router import RouterServer, tpu_plan_checker
from presto_tpu_torch.server.statement import StatementServer
from presto_tpu_torch.sql import sql

SF = 0.01


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(1)


def _server(**kw):
    return StatementServer(sf=SF, device="cpu", **kw)


# -- tests/test_resource_manager.py through the port ----------------------

def test_heartbeats_aggregate_and_expire():
    with ResourceManager(heartbeat_ttl_s=0.3) as rm:
        d1 = Dispatcher([ResourceGroup("g", hard_concurrency_limit=4)],
                        selector=lambda s: "g")
        s1 = ClusterStateSender(rm.url, "c1", d1)
        s1.send_once()
        assert remote_group_load(rm.url, "g",
                                 exclude_coordinator="other") == 0
        release = threading.Event()

        def hold(qid):
            s1.send_once()
            release.wait(5)
            return "ok"

        t = threading.Thread(target=lambda: d1.submit(hold))
        t.start()
        time.sleep(0.15)
        s1.send_once()
        assert remote_group_load(rm.url, "g",
                                 exclude_coordinator="other") == 1
        release.set()
        t.join(5)
        time.sleep(0.4)  # the heartbeat expires
        assert remote_group_load(rm.url, "g",
                                 exclude_coordinator="other") == 0


def _tree():
    root = ResourceGroup("etl", hard_concurrency_limit=4)
    root.add_child(ResourceGroup("nightly", hard_concurrency_limit=4))
    return root


@pytest.mark.parametrize("path,limit_on", [("g", "g"),
                                           ("etl.nightly", "etl")],
                         ids=["group", "ancestor"])
def test_cluster_limit_enforced_across_coordinators(path, limit_on):
    """Coordinator 2 has local room, but coordinator 1 holds the
    cluster's one slot of the group (or of an ancestor of the group):
    admission on 2 times out naming the cluster limit, then admits once
    1's query is done."""
    def groups():
        return [ResourceGroup("g", hard_concurrency_limit=4)] \
            if path == "g" else [_tree()]
    with ResourceManager() as rm:
        ds = [Dispatcher(groups(), selector=lambda s: path,
                         resource_manager_url=rm.url, coordinator_id=cid,
                         cluster_limits={limit_on: 1})
              for cid in ("c1", "c2")]
        senders = [ClusterStateSender(rm.url, cid, d, interval_s=0.05)
                   .start() for cid, d in zip(("c1", "c2"), ds)]
        try:
            release, started = threading.Event(), threading.Event()

            def hold(qid):
                started.set()
                release.wait(10)
                return "held"

            t = threading.Thread(target=lambda: ds[0].submit(hold))
            t.start()
            started.wait(5)
            time.sleep(0.2)  # c1's heartbeat carries running=1
            with pytest.raises(QueryRejected, match="cluster limit"):
                ds[1].submit(lambda qid: "nope", queue_timeout=0.3)
            release.set()
            t.join(5)
            time.sleep(0.2)  # c1's heartbeat drops to running=0
            assert ds[1].submit(lambda qid: "now", queue_timeout=5.0) == \
                "now"
        finally:
            for s in senders:
                s.stop()


def test_rm_outage_fails_open_to_local_admission():
    d = Dispatcher([ResourceGroup("g")], selector=lambda s: "g",
                   resource_manager_url="http://127.0.0.1:1",
                   coordinator_id="c1", cluster_limits={"g": 1})
    assert d.submit(lambda qid: "ok", queue_timeout=2.0) == "ok"


def test_reference_sender_and_view_against_the_port_manager():
    from presto_tpu.server.dispatcher import Dispatcher as RefDispatcher
    from presto_tpu.server.dispatcher import ResourceGroup as RefGroup
    from presto_tpu.server import resource_manager as ref_rm
    with ResourceManager() as rm:
        d = RefDispatcher([RefGroup("g")], selector=lambda s: "g")
        ref_rm.ClusterStateSender(rm.url, "ref", d).send_once()
        ClusterStateSender(rm.url, "port", Dispatcher(
            [ResourceGroup("g")], selector=lambda s: "g")).send_once()
        with urllib.request.urlopen(f"{rm.url}/v1/resourcemanager") as r:
            view = json.loads(r.read())
        assert set(view["coordinators"]) == {"ref", "port"}
        assert view["coordinators"]["ref"]["groups"]["g"] == \
            view["coordinators"]["port"]["groups"]["g"]
        assert ref_rm.remote_group_load(rm.url, "g", "x") == \
            remote_group_load(rm.url, "g", "x") == 0


# -- tests/test_router.py through the port --------------------------------

def test_round_robin_across_clusters():
    with _server() as a, _server() as b:
        with RouterServer([{"url": a.url}, {"url": b.url}]) as r:
            for _ in range(4):
                c = execute(r.url, "SELECT count(*) AS n FROM region",
                            session={"sf": str(SF)})
                assert c.data == [[5]]
            served_a, served_b = len(a.queries_doc()), len(b.queries_doc())
            assert served_a >= 1 and served_b >= 1
            assert served_a + served_b == 4


def test_plan_checker_routes_to_fallback():
    with _server() as primary, _server() as fallback:
        def always_ok(text, sess, qid, tid):
            return sql("SELECT count(*) AS n FROM region", sf=SF,
                       device="cpu")

        fallback._executor = always_ok
        with RouterServer([{"url": primary.url},
                           {"url": fallback.url, "kind": "fallback"}]) as r:
            execute(r.url, "SELECT count(*) AS n FROM nation",
                    session={"sf": str(SF)})
            assert len(primary.queries_doc()) == 1
            assert len(fallback.queries_doc()) == 0
            execute(r.url, "MERGE INTO t USING u ON t.x = u.x "
                           "WHEN MATCHED THEN DELETE")
            assert len(primary.queries_doc()) == 1
            assert len(fallback.queries_doc()) == 1


def test_unhealthy_cluster_excluded():
    with _server() as a:
        clusters = [{"url": a.url}, {"url": "http://127.0.0.1:1"}]
        with RouterServer(clusters, health_ttl_s=0.0) as r:
            for _ in range(3):
                c = execute(r.url, "SELECT count(*) AS n FROM region",
                            session={"sf": str(SF)})
                assert c.data == [[5]]
            assert len(a.queries_doc()) == 3
            with urllib.request.urlopen(f"{r.url}/v1/info") as resp:
                info = json.loads(resp.read())
            health = {c["url"]: c["healthy"] for c in info["clusters"]}
            assert health[a.url] is True
            assert health["http://127.0.0.1:1"] is False


def test_no_cluster_available():
    with RouterServer([{"url": "http://127.0.0.1:1"}],
                      health_ttl_s=0.0) as r:
        with pytest.raises(QueryError) as ei:
            execute(r.url, "SELECT count(*) AS n FROM region")
        assert ei.value.error_name == "NO_CLUSTER_AVAILABLE"


@pytest.mark.parametrize("text", [
    "SELECT count(*) AS n FROM nation",
    "SELECT returnflag, sum(quantity) FROM lineitem GROUP BY returnflag",
    "MERGE INTO t USING u ON t.x = u.x WHEN MATCHED THEN DELETE",
    "SELECT * FROM no_such_table", "SELEC 1"],
    ids=["count", "group", "merge", "missing", "syntax"])
def test_plan_checker_agrees_with_the_reference(text):
    from presto_tpu.server.router import tpu_plan_checker as ref_checker
    assert tpu_plan_checker(text) == ref_checker(text)


# -- tests/test_catalog_server.py through the port ------------------------

@pytest.fixture
def remote_tpch():
    with CatalogServer() as srv:
        proxy = register_remote_catalog("rtpch", srv.url, "tpch")
        yield proxy, srv
        unregister_remote_catalog("rtpch")


def test_remote_metadata_matches_local(remote_tpch):
    from presto_tpu_torch.connectors import tpch
    proxy, _ = remote_tpch
    assert set(proxy.SCHEMA.keys()) == set(tpch.TPCH_SCHEMA)
    assert proxy.SCHEMA["region"] == dict(tpch.TPCH_SCHEMA["region"])
    assert proxy.table_row_count("nation", 0.01) == 25
    assert proxy.column_distinct_count("nation", "regionkey", 0.01) == \
        tpch.column_distinct_count("nation", "regionkey", 0.01)


def test_show_and_describe_work_against_remote_catalog(remote_tpch):
    tabs = [r[0] for r in sql("SHOW TABLES FROM rtpch", sf=0.01,
                              device="cpu").rows()]
    assert "lineitem" in tabs
    cols = sql("DESCRIBE rtpch.region", sf=0.01, device="cpu").rows()
    assert [c[0] for c in cols] == ["regionkey", "name", "comment"]


def test_remote_scan_is_rejected_with_catalogserver_semantics(remote_tpch):
    with pytest.raises(Exception, match="METADATA|not executable"):
        sql("SELECT count(*) FROM rtpch.region", sf=0.01, device="cpu")


def test_planner_stats_flow_through_remote_catalog(remote_tpch):
    from presto_tpu_torch.plan import nodes as N
    from presto_tpu_torch.plan.stats import estimate_rows
    scan = N.TableScanNode("rtpch", "orders", ["orderkey"], [T.BIGINT])
    assert estimate_rows(scan, 0.01) == 15000.0


@pytest.mark.parametrize("table", ["region", "orders", "lineitem"])
def test_reference_proxy_reads_the_port_catalog_server(remote_tpch, table):
    from presto_tpu.server.catalog_server import RemoteCatalogProxy
    _, srv = remote_tpch
    ref = RemoteCatalogProxy(srv.url, "tpch")
    port, _ = remote_tpch
    assert {c: str(t) for c, t in ref.SCHEMA[table].items()} == \
        {c: str(t) for c, t in port.SCHEMA[table].items()}
    assert ref.table_row_count(table, 0.01) == \
        port.table_row_count(table, 0.01)
    col = next(iter(port.SCHEMA[table]))
    assert ref.column_distinct_count(table, col, 0.01) == \
        port.column_distinct_count(table, col, 0.01)
