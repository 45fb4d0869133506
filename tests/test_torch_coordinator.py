"""The port's coordinator over two port workers on the CPU, against the
reference's coordinator over two reference workers.

The cases of tests/test_coordinator.py and the cluster cases of
tests/test_merge_exchange.py: the same statement, planned by each
package's own front door and distributed by its own AddExchanges (or
`distribute_simple_agg`), must return the same rows (in order where
the query orders them). Then one case in each crossed layout (the
reference's coordinator over port workers, the port's over reference
workers), "all_at_once" against "phased", failover (a dead URL, and
`worker.run_task` armed through POST /v1/failpoint), speculation, a
cluster found through discovery, and verify_corpus(cluster_urls=).
"""

import collections
import json
import time
import urllib.request

import numpy as np
import pytest
import torch

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
from presto_tpu.plan import nodes as RN
from presto_tpu.plan.distribute import add_exchanges as ref_add_exchanges
from presto_tpu.plan.fragment import \
    distribute_simple_agg as ref_distribute_simple_agg
from presto_tpu.server import Coordinator as RefCoordinator
from presto_tpu.server import TpuWorkerServer as RefWorker
from presto_tpu.sql import plan_sql as ref_plan_sql

from presto_tpu_torch import failpoints as fp
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.plan.distribute import add_exchanges
from presto_tpu_torch.plan.fragment import (distribute_simple_agg,
                                            fragment_plan)
from presto_tpu_torch.server import Coordinator, TpuWorkerServer
from presto_tpu_torch.server.coordinator import (reset_speculation_totals,
                                                 speculation_totals)
from presto_tpu_torch.server.discovery import (DiscoveryServer,
                                               HeartbeatProber, alive_nodes)
from presto_tpu_torch.sql import plan_sql

SF = 0.01


@pytest.fixture(scope="module")
def cluster():
    torch.set_num_threads(1)
    port = [TpuWorkerServer(sf=SF, device="cpu").start() for _ in range(2)]
    ref = [RefWorker(sf=SF).start() for _ in range(2)]
    yield [w.url for w in port], [w.url for w in ref]
    for w in port + ref:
        w.stop()


def _py(v):
    return v.item() if isinstance(v, np.generic) else v


def rows(cols):
    n = len(cols[0][0]) if cols else 0
    return [tuple(None if m[i] else _py(v[i]) for v, m in cols)
            for i in range(n)]


def same(got, want, ordered=False):
    if ordered:
        assert got == want
    else:
        assert collections.Counter(got) == collections.Counter(want)


def both(cluster, text, dist="exchanges", sf=SF, max_groups=1 << 16,
         ordered=False, **kw):
    """The statement on each package's own cluster; its rows equal."""
    port_urls, ref_urls = cluster
    if dist == "simple":
        pp = distribute_simple_agg(plan_sql(text, max_groups=max_groups))
        rp = ref_distribute_simple_agg(ref_plan_sql(text,
                                                    max_groups=max_groups))
    else:
        pp = add_exchanges(plan_sql(text, max_groups=max_groups), **kw)
        rp = ref_add_exchanges(ref_plan_sql(text, max_groups=max_groups),
                               **kw)
    got, names = Coordinator(port_urls).execute(pp, sf=sf)
    want, ref_names = RefCoordinator(ref_urls).execute(rp, sf=sf)
    assert names == ref_names
    same(rows(got), rows(want), ordered)
    return rows(got)


Q1 = """
  SELECT returnflag, linestatus, sum(quantity) AS q, count(*) AS c
  FROM lineitem WHERE shipdate <= date '1998-09-02'
  GROUP BY returnflag, linestatus"""
BY_CUST = ("SELECT custkey, sum(totalprice) AS s, count(*) AS c "
           "FROM orders GROUP BY custkey")


def test_fragmented_plan_has_remote_source():
    p = distribute_simple_agg(plan_sql(
        "SELECT custkey, count(*) AS c FROM orders GROUP BY custkey"))
    frags = fragment_plan(p)
    assert len(frags) == 2
    found = []

    def walk(n):
        if isinstance(n, N.RemoteSourceNode):
            found.append(n)
        for s in n.sources:
            walk(s)
    walk(frags[-1].root)
    assert len(found) == 1 and found[0].fragment_id == 0


def test_distributed_q1_matches_the_reference(cluster):
    got = both(cluster, Q1, dist="simple", max_groups=16)
    assert len(got) == 4


def test_repartitioned_exchange_across_workers(cluster):
    assert fragment_plan(add_exchanges(plan_sql(
        BY_CUST, max_groups=1 << 14)))[0].partitioning == "HASH"
    got = both(cluster, BY_CUST, max_groups=1 << 14)
    assert len(got) == len({r[0] for r in got})  # partitions disjoint


def test_union_of_scans_range_splits(cluster):
    both(cluster, "SELECT custkey FROM orders UNION ALL "
                  "SELECT custkey FROM customer")


def _hand_built(ref_builder):
    """A plan built with the reference's nodes, and the port's copy of
    it read from its JSON."""
    rp = ref_builder()
    return N.from_json(RN.to_json(rp)), rp


def test_single_upstream_with_scan_runs_unduplicated(cluster):
    from presto_tpu import types as RT
    from presto_tpu.connectors import tpch as rtpch
    from presto_tpu.expr import input_ref

    def build():
        cust = RN.TableScanNode("tpch", "customer", ["custkey"],
                                [rtpch.column_type("customer", "custkey")])
        orders = RN.TableScanNode(
            "tpch", "orders", ["custkey", "totalprice"],
            [rtpch.column_type("orders", c)
             for c in ("custkey", "totalprice")])
        inner = RN.ExchangeNode(orders, kind="GATHER", scope="REMOTE")
        top = RN.ProjectNode(RN.TopNNode(inner, [(1, True, True)], 10),
                             [input_ref(0, RT.BIGINT)])
        gathered = RN.ExchangeNode(top, kind="GATHER", scope="REMOTE")
        return RN.OutputNode(RN.UnionNode([cust, gathered]), ["custkey"])
    pp, rp = _hand_built(build)
    got, _ = Coordinator(cluster[0]).execute(pp, sf=SF)
    want, _ = RefCoordinator(cluster[1]).execute(rp, sf=SF)
    same(rows(got), rows(want))
    assert len(rows(got)) == 1500 + 10  # the gathered rows once


def test_distributed_partitioned_join(cluster):
    text = ("SELECT c.mktsegment, count(*) AS cnt FROM orders o "
            "JOIN customer c ON o.custkey = c.custkey GROUP BY c.mktsegment")
    frags = fragment_plan(add_exchanges(plan_sql(text, max_groups=64),
                                        join_strategy="partitioned"))
    assert sum(1 for f in frags if f.partitioning == "HASH") >= 2
    both(cluster, text, max_groups=64, join_strategy="partitioned")


def test_distributed_broadcast_join_dag(cluster):
    text = """
      SELECT c.mktsegment, count(*) AS cnt, sum(o.totalprice) AS s
      FROM orders o JOIN customer c ON o.custkey = c.custkey
      GROUP BY c.mktsegment ORDER BY cnt DESC LIMIT 3"""
    frags = fragment_plan(add_exchanges(plan_sql(text, max_groups=64)))
    assert len(frags) >= 3
    assert any(f.partitioning == "BROADCAST" for f in frags)
    assert len(both(cluster, text, max_groups=64, ordered=True)) == 3


def test_failover_to_live_worker(cluster):
    """One configured worker URL is dead: its tasks fail over to the
    live ones."""
    port_urls, _ = cluster
    text = "SELECT count(*) AS c FROM orders"
    coord = Coordinator([port_urls[0], "http://127.0.0.1:1", port_urls[1]])
    cols, _ = coord.execute(distribute_simple_agg(plan_sql(text,
                                                           max_groups=4)),
                            sf=SF, timeout=30.0)
    assert rows(cols) == [(15000,)]


def test_distributed_high_cardinality(cluster):
    both(cluster, BY_CUST, dist="simple", max_groups=1 << 14)


def test_former_scheduler_gaps_degrade_to_single_task(cluster):
    from presto_tpu.connectors import tpch as rtpch

    def ts(table, cols):
        return RN.TableScanNode("tpch", table, cols,
                                [rtpch.column_type(table, c) for c in cols])

    def join_of_two_scans():
        j = RN.JoinNode(ts("orders", ["custkey", "totalprice"]),
                        ts("customer", ["custkey", "mktsegment"]),
                        [0], [0], "inner", "broadcast",
                        out_capacity=1 << 18)
        return RN.OutputNode(j, ["ck", "tp", "ck2", "seg"])

    def scan_beside_hash_upstream():
        rep = RN.ExchangeNode(ts("customer", ["custkey"]),
                              kind="REPARTITION", scope="REMOTE",
                              partition_channels=[0])
        return RN.OutputNode(RN.UnionNode([ts("orders", ["custkey"]), rep]),
                             ["k"])

    for build in (join_of_two_scans, scan_beside_hash_upstream):
        pp, rp = _hand_built(build)
        got, _ = Coordinator(cluster[0]).execute(pp, sf=SF)
        want, _ = RefCoordinator(cluster[1]).execute(rp, sf=SF)
        same(rows(got), rows(want))


def test_all_at_once_policy_matches_phased(cluster):
    port_urls, _ = cluster
    coord = Coordinator(port_urls)
    cols_p, _ = coord.execute(distribute_simple_agg(
        plan_sql(BY_CUST, max_groups=1 << 14)), sf=SF, policy="phased")
    cols_a, _ = coord.execute(distribute_simple_agg(
        plan_sql(BY_CUST, max_groups=1 << 14)), sf=SF, policy="all_at_once")
    same(rows(cols_a), rows(cols_p))
    # a three-fragment plan too
    text = ("SELECT orderkey, extendedprice FROM lineitem "
            "WHERE quantity < 10 ORDER BY extendedprice DESC, orderkey")
    a, _ = coord.execute(add_exchanges(plan_sql(text)), sf=SF,
                         policy="all_at_once")
    p, _ = coord.execute(add_exchanges(plan_sql(text)), sf=SF)
    assert rows(a) == rows(p)


# -- tests/test_merge_exchange.py's cluster cases --------------------------

def test_cluster_order_by_merges_sorted_streams(cluster):
    text = ("select orderkey, extendedprice from lineitem "
            "where quantity < 10 order by extendedprice desc, orderkey")
    frags = fragment_plan(add_exchanges(plan_sql(text)))
    assert any(f.partitioning == "SORTED" for f in frags)
    assert len(both(cluster, text, sf=0.005, ordered=True)) > 20


def test_cluster_topn_partial_final(cluster):
    text = ("select orderkey, extendedprice from lineitem "
            "order by extendedprice desc limit 11")
    assert len(both(cluster, text, sf=0.005, ordered=True)) == 11


def test_merge_permutation_equals_the_reference():
    from presto_tpu.server.http_exchange import merge_permutation as ref_mp

    from presto_tpu_torch.server.http_exchange import merge_permutation
    rng = np.random.default_rng(5)
    runs = [np.sort(rng.integers(0, 20, 9)).astype(np.float64)
            for _ in range(3)]
    vals = np.concatenate(runs)
    nulls = rng.random(len(vals)) < 0.2
    names = np.array([f"s{int(v) % 4}" for v in vals], dtype=object)
    for keys in ([(0, False, True)], [(0, True, False)],
                 [(1, False, True), (0, True, True)]):
        got = merge_permutation([vals, names], [nulls, nulls & False], keys)
        want = ref_mp([vals, names], [nulls, nulls & False], keys)
        assert list(got) == list(want)
    perm = merge_permutation([np.array([1.0, 3.0, 5.0, 2.0, 2.5, 9.0])],
                             [np.zeros(6, bool)], [(0, False, True)])
    assert list(perm) == [0, 3, 4, 1, 2, 5]


# -- crossed layouts -------------------------------------------------------

def test_reference_coordinator_over_port_workers(cluster):
    port_urls, ref_urls = cluster
    rp = ref_add_exchanges(ref_plan_sql(BY_CUST, max_groups=1 << 14))
    got, _ = RefCoordinator(port_urls).execute(rp, sf=SF)
    want, _ = RefCoordinator(ref_urls).execute(
        ref_add_exchanges(ref_plan_sql(BY_CUST, max_groups=1 << 14)), sf=SF)
    same(rows(got), rows(want))


def test_port_coordinator_over_reference_workers(cluster):
    port_urls, ref_urls = cluster
    text = ("select orderkey, extendedprice from lineitem "
            "where quantity < 10 order by extendedprice desc, orderkey")
    got, _ = Coordinator(ref_urls).execute(add_exchanges(plan_sql(text)),
                                           sf=SF)
    want, _ = Coordinator(port_urls).execute(add_exchanges(plan_sql(text)),
                                             sf=SF)
    assert rows(got) == rows(want)


# -- failover, speculation, discovery, the verifier ------------------------

def _arm(url, site, spec):
    req = urllib.request.Request(
        f"{url}/v1/failpoint", method="POST",
        data=json.dumps({"site": site, "spec": spec}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as r:
        assert r.status == 200


def test_failover_with_run_task_armed(cluster):
    """worker.run_task fails one task once (armed over HTTP): the
    coordinator aborts it and resubmits, and the rows do not change."""
    port_urls, _ = cluster
    coord = Coordinator(port_urls)
    plan = distribute_simple_agg(plan_sql(Q1, max_groups=16))
    want, _ = coord.execute(plan, sf=SF)
    try:
        _arm(port_urls[1], "worker.run_task", "error(RuntimeError):once")
        got, _ = coord.execute(distribute_simple_agg(
            plan_sql(Q1, max_groups=16)), sf=SF)
        assert fp.active()["worker.run_task"]["fires"] == 1
    finally:
        fp.disarm_all()
    assert rows(got) == rows(want)
    assert any(".r" in t["task"] for t in coord.last_task_stats)


def test_speculative_copy_of_a_straggler(cluster):
    port_urls, _ = cluster
    reset_speculation_totals()
    coord = Coordinator(port_urls, speculation_threshold_ms=300)
    text = "SELECT count(*) AS c FROM nation"
    try:
        fp.arm("worker.run_task", "delay(1500):once")
        cols, _ = coord.execute(plan_sql(text), sf=SF)
    finally:
        fp.disarm_all()
    assert rows(cols) == [(25,)]
    totals = speculation_totals()
    assert totals["launched"] == 1 and totals["wins"] == 1


def test_discovery_driven_cluster():
    disc = DiscoveryServer().start()
    workers = [TpuWorkerServer(sf=SF, device="cpu",
                               discovery_url=disc.url,
                               announce_interval_s=0.2).start()
               for _ in range(2)]
    try:
        deadline = time.time() + 10
        while len(alive_nodes(disc.url)) < 2 and time.time() < deadline:
            time.sleep(0.05)
        assert {n["uri"] for n in alive_nodes(disc.url)} == \
            {w.url for w in workers}
        coord = Coordinator(discovery_url=disc.url)
        cols, _ = coord.execute(distribute_simple_agg(
            plan_sql(Q1, max_groups=16)), sf=SF)
        assert len(rows(cols)) == 4
        assert {t["url"] for t in coord.last_task_stats} == \
            {w.url for w in workers}
        workers[1].stop()  # a goodbye: discovery drops it at once
        assert [n["uri"] for n in alive_nodes(disc.url)] == [workers[0].url]
    finally:
        workers[0].stop()
        disc.stop()


def test_prober_excludes_a_dead_worker(cluster):
    port_urls, _ = cluster
    urls = [port_urls[0], "http://127.0.0.1:1"]
    prober = HeartbeatProber(urls, probe_timeout_s=1.0)
    for _ in range(3):
        prober.probe_all_once()
    assert prober.healthy() == [port_urls[0]]
    assert prober.failure_rate("http://127.0.0.1:1") > 0.5
    coord = Coordinator(urls, prober=prober)
    assert coord.workers() == [port_urls[0]]


def test_verify_corpus_on_the_cluster(cluster):
    from presto_tpu_torch.verifier import DEFAULT_CORPUS, verify_corpus
    results = verify_corpus(DEFAULT_CORPUS[:4], sf=SF, device="cpu",
                            cluster_urls=cluster[0])
    for r in results:
        assert r.ok, (r.query, r.detail)
        assert r.configs == ["control", "cluster"]


def test_tpcds_fact_table_range_split(cluster):
    """A TPC-DS fact table range-splits across the workers like a
    TPC-H one: the cluster's rows equal one device's and the
    reference cluster's."""
    from presto_tpu_torch.exec import run_query
    text = ("SELECT ss_store_sk, count(*) AS c, sum(ss_quantity) AS q "
            "FROM store_sales GROUP BY ss_store_sk")
    port_urls, ref_urls = cluster
    got, _ = Coordinator(port_urls).execute(distribute_simple_agg(
        plan_sql(text, max_groups=64, catalog="tpcds")), sf=SF)
    want, _ = RefCoordinator(ref_urls).execute(ref_distribute_simple_agg(
        ref_plan_sql(text, max_groups=64, catalog="tpcds")), sf=SF)
    same(rows(got), rows(want))
    local = run_query(plan_sql(text, max_groups=64, catalog="tpcds"),
                      sf=SF, device="cpu")
    same(rows(got), [tuple(_py(v) for v in r) for r in local.rows()])


@pytest.mark.parametrize("codec", ["zstd", "zlib"])
def test_compressed_exchanges(cluster, codec):
    """With exchange_compression the producers compress their pages
    and every consumer, the coordinator too, reads them with the same
    codec (the reference's consumers read with none)."""
    port_urls, _ = cluster
    plan = add_exchanges(plan_sql(BY_CUST, max_groups=1 << 14))
    got, _ = Coordinator(port_urls).execute(
        plan, sf=SF, session={"exchange_compression": codec,
                              "fragment_result_cache": False})
    want, _ = Coordinator(port_urls).execute(plan, sf=SF)
    same(rows(got), rows(want))
