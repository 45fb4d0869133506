"""TLS on the port's internal communication (presto_tpu_torch/server/
tls.py) against the reference's.

The cases of tests/test_tls.py through the port: a discovery server
and a worker on https with a cluster secret, the port's Coordinator
running a query over them; the statement protocol over https; plain
HTTP refused by a TLS server. Then across the packages: each
package's WorkerClient drives the other's secured https worker.
"""

import time
import urllib.request

import pytest

# minting certificates needs the cryptography package, as in the
# reference's test
pytest.importorskip("cryptography")

import torch  # noqa: E402

import presto_tpu  # noqa: F401,E402  (enables jax x64 first)
from presto_tpu.server import tls as ref_tls  # noqa: E402

from presto_tpu_torch.server import tls as tlsmod  # noqa: E402

SECRET = "tls-test-secret"
SF = 0.01


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    torch.set_num_threads(1)
    d = tmp_path_factory.mktemp("certs")
    cert, key = tlsmod.generate_self_signed(str(d))
    tlsmod.trust(cert)
    ref_tls.trust(cert)  # the reference's pooled client reads its own
    yield cert, key
    tlsmod.clear_trust()
    ref_tls.clear_trust()


def test_tls_cluster_end_to_end(certs):
    from presto_tpu_torch.server import Coordinator, TpuWorkerServer
    from presto_tpu_torch.server.auth import set_shared_secret
    from presto_tpu_torch.server.discovery import (DiscoveryServer,
                                                   alive_nodes)
    from presto_tpu_torch.sql import plan_sql
    disc = DiscoveryServer(shared_secret=SECRET, tls=certs).start()
    w = TpuWorkerServer(sf=SF, device="cpu", discovery_url=disc.url,
                        shared_secret=SECRET, tls=certs).start()
    try:
        assert disc.url.startswith("https://")
        assert w.url.startswith("https://")
        deadline = time.time() + 10
        while time.time() < deadline:
            if alive_nodes(disc.url, shared_secret=SECRET):
                break
            time.sleep(0.1)
        nodes = alive_nodes(disc.url, shared_secret=SECRET)
        assert nodes and nodes[0]["uri"].startswith("https://")
        set_shared_secret(SECRET)
        try:
            coord = Coordinator(discovery_url=disc.url)
            plan = plan_sql("SELECT count(*) AS n FROM nation")
            cols, _ = coord.execute(plan, sf=SF, timeout=30.0)
            assert int(cols[0][0][0]) == 25
        finally:
            set_shared_secret(None)
    finally:
        w.stop()
        disc.stop()


def test_tls_statement_protocol(certs):
    from presto_tpu_torch.client import execute
    from presto_tpu_torch.server.statement import StatementServer
    with StatementServer(sf=SF, tls=certs, device="cpu") as s:
        assert s.url.startswith("https://")
        c = execute(s.url, "SELECT count(*) AS n FROM region",
                    session={"sf": str(SF)})
        assert c.data == [[5]]


def test_plain_http_rejected_by_tls_server(certs):
    from presto_tpu_torch.server.statement import StatementServer
    with StatementServer(sf=SF, tls=certs, device="cpu") as s:
        plain = s.url.replace("https://", "http://")
        with pytest.raises(Exception):
            urllib.request.urlopen(f"{plain}/v1/info", timeout=5)


def test_reference_client_over_https_to_a_port_worker(certs):
    from presto_tpu.server.client import WorkerClient as RefClient
    from presto_tpu.sql import plan_sql as ref_plan_sql
    from presto_tpu_torch.server import TpuWorkerServer
    w = TpuWorkerServer(sf=SF, device="cpu", shared_secret=SECRET,
                        tls=certs).start()
    try:
        plan = ref_plan_sql("SELECT regionkey FROM region")
        c = RefClient(w.url, 30.0, shared_secret=SECRET)
        c.submit("tls-r", plan, sf=SF)
        assert c.wait("tls-r", 30)["state"] == "FINISHED"
        cols = c.fetch_results("tls-r", plan.output_types())
        assert sorted(cols[0][0].tolist()) == [0, 1, 2, 3, 4]
    finally:
        w.stop()


def test_port_client_over_https_to_a_reference_worker(certs):
    from presto_tpu.server import TpuWorkerServer as RefWorker
    from presto_tpu_torch.server import WorkerClient
    from presto_tpu_torch.sql import plan_sql
    w = RefWorker(sf=SF, shared_secret=SECRET, tls=certs).start()
    try:
        assert w.url.startswith("https://")
        plan = plan_sql("SELECT regionkey FROM region")
        c = WorkerClient(w.url, 30.0, shared_secret=SECRET)
        c.submit("tls-p", plan, sf=SF)
        assert c.wait("tls-p", 60)["state"] == "FINISHED"
        cols = c.fetch_results("tls-p", plan.output_types())
        assert sorted(cols[0][0].tolist()) == [0, 1, 2, 3, 4]
    finally:
        w.stop()
