"""Internal authentication and the thrift status of the port
(presto_tpu_torch/server/auth.py, serde/thrift.py) against the
reference's.

Every case of tests/test_auth.py and tests/test_thrift_status.py runs
through the port. Then, across the packages: the same secret, payload
and clock give the same token bytes, each package verifies the other's
tokens, the reference's WorkerClient drives a secured port worker and
the port's client a secured reference worker, and the thrift bytes of
one status document are equal and decode in either package.
"""

import base64
import hashlib
import hmac
import http.client
import json
import time
import urllib.error
import urllib.request

import pytest
import torch

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
from presto_tpu.server import auth as ref_auth
from presto_tpu.serde import thrift as ref_thrift

from presto_tpu_torch import types as T
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.serde.thrift import (TASK_STATUS_SCHEMA, decode_struct,
                                           decode_task_status, encode_struct,
                                           encode_task_status)
from presto_tpu_torch.server.auth import (AuthError, InternalAuthenticator,
                                          INTERNAL_BEARER_HEADER, sign_jwt,
                                          verify_jwt)

SF = 0.001


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(1)


def _nation_plan():
    from presto_tpu_torch.expr import call, const, input_ref
    scan = N.TableScanNode("tpch", "nation", ["nationkey", "name"],
                           [T.BIGINT, T.varchar()])
    return N.OutputNode(
        N.FilterNode(scan, call("lt", T.BOOLEAN, input_ref(0, T.BIGINT),
                                const(5, T.BIGINT))),
        ["nationkey", "name"])


# -- tests/test_auth.py through the port ---------------------------------

def test_jwt_round_trip_and_subject():
    tok = sign_jwt("s3cret", {"sub": "worker-1", "exp": time.time() + 60})
    assert verify_jwt("s3cret", tok)["sub"] == "worker-1"


def test_jwt_rejects_tampering_wrong_secret_expiry():
    tok = sign_jwt("s3cret", {"sub": "w", "exp": time.time() + 60})
    h, b, s = tok.split(".")
    with pytest.raises(AuthError):
        verify_jwt("s3cret", f"{h}.{b}x.{s}")
    with pytest.raises(AuthError):
        verify_jwt("other", tok)
    old = sign_jwt("s3cret", {"sub": "w", "exp": time.time() - 120})
    with pytest.raises(AuthError):
        verify_jwt("s3cret", old)
    with pytest.raises(AuthError):
        verify_jwt("s3cret", "not-a-token")


def test_authenticator_caches_until_near_expiry():
    a = InternalAuthenticator("k", "node-1", ttl_s=300)
    assert a.bearer() == a.bearer()
    assert verify_jwt("k", a.bearer())["sub"] == "node-1"


def test_alg_none_downgrade_rejected():
    hdr = base64.urlsafe_b64encode(b'{"alg":"none"}').rstrip(b"=").decode()
    body = base64.urlsafe_b64encode(b'{"sub":"evil"}').rstrip(b"=").decode()
    sig = base64.urlsafe_b64encode(hmac.new(
        b"s", f"{hdr}.{body}".encode(), hashlib.sha256).digest()
    ).rstrip(b"=").decode()
    with pytest.raises(AuthError):
        verify_jwt("s", f"{hdr}.{body}.{sig}")


def test_worker_rejects_unauthenticated_when_secret_set():
    from presto_tpu_torch.server.worker import TpuWorkerServer
    server = TpuWorkerServer(sf=SF, device="cpu",
                             shared_secret="cluster-key").start()
    try:
        url = f"{server.url}/v1/info"
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(url, timeout=5)
        assert exc.value.code == 401
        auth = InternalAuthenticator("cluster-key", "test")
        req = urllib.request.Request(
            url, headers={INTERNAL_BEARER_HEADER: auth.bearer()})
        info = json.loads(urllib.request.urlopen(req, timeout=5).read())
        assert info["nodeId"] == server.node_id
        bad = InternalAuthenticator("wrong", "test")
        req = urllib.request.Request(
            url, headers={INTERNAL_BEARER_HEADER: bad.bearer()})
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=5)
        assert exc.value.code == 401
    finally:
        server.stop()


def test_secured_cluster_end_to_end(monkeypatch):
    """The WorkerClient takes the process-wide secret from the
    environment, as the worker does."""
    monkeypatch.setenv("PRESTO_TPU_INTERNAL_SECRET", "e2e-key")
    from presto_tpu_torch.server.client import WorkerClient
    from presto_tpu_torch.server.worker import TpuWorkerServer
    server = TpuWorkerServer(sf=SF, device="cpu").start()
    try:
        client = WorkerClient(server.url)
        client.submit("t0", _nation_plan(), sf=SF)
        assert client.wait("t0")["state"] == "FINISHED"
        cols = client.fetch_results("t0", [T.BIGINT, T.varchar()])
        assert sorted(cols[0][0].tolist()) == [0, 1, 2, 3, 4]
    finally:
        server.stop()


def test_explicit_secret_cluster_without_env():
    from presto_tpu_torch.server.discovery import (Announcer,
                                                   DiscoveryServer,
                                                   alive_nodes)
    disc = DiscoveryServer(shared_secret="explicit-key").start()
    try:
        Announcer(disc.url, "w1", "http://127.0.0.1:1",
                  shared_secret="explicit-key").announce_once()
        nodes = alive_nodes(disc.url, shared_secret="explicit-key")
        assert [n["nodeId"] for n in nodes] == ["w1"]
    finally:
        disc.stop()


def test_401_drains_body_on_keepalive_connection():
    from presto_tpu_torch.server.worker import TpuWorkerServer
    server = TpuWorkerServer(sf=SF, device="cpu",
                             shared_secret="ka-key").start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=5)
        conn.request("POST", "/v1/task/t1", body=b'{"plan": {}}' * 100,
                     headers={"Content-Type": "application/json"})
        r1 = conn.getresponse()
        assert r1.status == 401
        r1.read()
        auth = InternalAuthenticator("ka-key", "t")
        conn.request("GET", "/v1/info",
                     headers={INTERNAL_BEARER_HEADER: auth.bearer()})
        r2 = conn.getresponse()
        assert r2.status == 200
        assert json.loads(r2.read())["nodeId"] == server.node_id
        conn.close()
    finally:
        server.stop()


def test_secured_discovery_round_trip(monkeypatch):
    monkeypatch.setenv("PRESTO_TPU_INTERNAL_SECRET", "disc-key")
    from presto_tpu_torch.server.discovery import (Announcer,
                                                   DiscoveryServer,
                                                   alive_nodes)
    disc = DiscoveryServer().start()
    try:
        req = urllib.request.Request(
            f"{disc.url}/v1/announcement/n1", data=b"{}", method="PUT",
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=5)
        assert exc.value.code == 401
        Announcer(disc.url, "n1", "http://127.0.0.1:1").announce_once()
        assert [n["nodeId"] for n in alive_nodes(disc.url)] == ["n1"]
    finally:
        disc.stop()


# -- across the packages ---------------------------------------------------

PAYLOADS = [{"sub": "worker-1", "iat": 1700000000, "exp": 1700000300},
            {"sub": "", "exp": 1.5},
            {"sub": "né中", "iat": 0, "exp": 2 ** 40, "x": [1, None]}]


@pytest.mark.parametrize("payload", PAYLOADS, ids=["node", "float", "utf8"])
@pytest.mark.parametrize("secret", ["s3cret", "a much longer cluster secret"])
def test_token_bytes_equal_to_the_reference(secret, payload):
    tok = sign_jwt(secret, payload)
    assert tok == ref_auth.sign_jwt(secret, payload)
    # each package verifies the other's token (no expiry check past 2**40)
    late = dict(payload, exp=2 ** 40)
    assert ref_auth.verify_jwt(secret, sign_jwt(secret, late)) == late
    assert verify_jwt(secret, ref_auth.sign_jwt(secret, late)) == late


def test_authenticator_tokens_equal_at_one_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000123.75)
    port = InternalAuthenticator("k", "node-7", ttl_s=120).bearer()
    ref = ref_auth.InternalAuthenticator("k", "node-7", ttl_s=120).bearer()
    assert port == ref


def test_reference_client_drives_a_secured_port_worker():
    from presto_tpu.server.client import WorkerClient as RefClient
    from presto_tpu.sql import plan_sql as ref_plan_sql
    from presto_tpu_torch.server.worker import TpuWorkerServer
    w = TpuWorkerServer(sf=SF, device="cpu", shared_secret="x-key").start()
    try:
        plan = ref_plan_sql("SELECT regionkey, name FROM region")
        with pytest.raises(urllib.error.HTTPError) as ei:
            RefClient(w.url, 10.0).info()
        assert ei.value.code == 401
        c = RefClient(w.url, 30.0, shared_secret="x-key")
        c.submit("xr1", plan, sf=SF)
        assert c.wait("xr1", 30)["state"] == "FINISHED"
        cols = c.fetch_results("xr1", plan.output_types())
        assert sorted(cols[0][0].tolist()) == [0, 1, 2, 3, 4]
    finally:
        w.stop()


def test_port_client_drives_a_secured_reference_worker():
    from presto_tpu.server import TpuWorkerServer as RefWorker
    from presto_tpu_torch.server.client import WorkerClient
    from presto_tpu_torch.sql import plan_sql
    w = RefWorker(sf=SF, shared_secret="y-key").start()
    try:
        plan = plan_sql("SELECT regionkey, name FROM region")
        with pytest.raises(urllib.error.HTTPError) as ei:
            WorkerClient(w.url, 10.0).info()
        assert ei.value.code == 401
        c = WorkerClient(w.url, 30.0, shared_secret="y-key")
        c.submit("xp1", plan, sf=SF)
        assert c.wait("xp1", 60)["state"] == "FINISHED"
        cols = c.fetch_results("xp1", plan.output_types())
        assert sorted(cols[0][0].tolist()) == [0, 1, 2, 3, 4]
    finally:
        w.stop()


# -- tests/test_thrift_status.py through the port, and across -----------

STATUS = {"taskId": "t1", "state": "RUNNING", "self": "http://n1/v1/task/t1",
          "version": 7, "memoryReservationInBytes": 123456789,
          "outputBufferUtilization": 0.25, "outputBufferOverutilized": True,
          "runningPartitionedDrivers": 2, "queuedPartitionedDrivers": 0,
          "failureMessages": ["boom", "again"], "taskAgeInMillis": 42}


def test_round_trip_all_field_kinds():
    out = decode_struct(encode_struct(STATUS, TASK_STATUS_SCHEMA),
                        TASK_STATUS_SCHEMA)
    assert out == STATUS


def test_unknown_fields_skip_forward_compatibly():
    schema_v2 = dict(TASK_STATUS_SCHEMA)
    schema_v2["futureField"] = (99, 10)
    data = encode_struct({"taskId": "x", "futureField": 5}, schema_v2)
    assert decode_struct(data, TASK_STATUS_SCHEMA) == {"taskId": "x"}


SKIPPED = [(3, b"\x07"), (6, b"\x00\x07"), (12, b"\x08\x00\x01\x00\x00\x00"
                                             b"\x05\x00"),
           (13, b"\x0b\x08\x00\x00\x00\x01\x00\x00\x00\x01a\x00\x00\x00"
                b"\x02"),
           (14, b"\x08\x00\x00\x00\x02\x00\x00\x00\x01\x00\x00\x00\x02")]


@pytest.mark.parametrize("ttype,value", SKIPPED,
                         ids=["byte", "i16", "struct", "map", "set"])
def test_every_wire_type_skips_as_in_the_reference(ttype, value):
    import struct
    data = (struct.pack("!bh", ttype, 77) + value +
            encode_struct({"taskId": "after"}, TASK_STATUS_SCHEMA))
    got = decode_struct(data, TASK_STATUS_SCHEMA)
    assert got == ref_thrift.decode_struct(data,
                                           ref_thrift.TASK_STATUS_SCHEMA)
    assert got == {"taskId": "after"}


@pytest.mark.parametrize("doc", [
    STATUS, {"taskId": "q.1.0", "state": "FAILED", "version": -1,
             "failures": [{"message": "xé", "type": "USER_ERROR"}]},
    {"state": "FINISHED", "outputBufferUtilization": float("-0.0")}],
    ids=["full", "failed", "sparse"])
def test_thrift_bytes_equal_to_the_reference(doc):
    port = encode_task_status(doc, "tid")
    assert port == ref_thrift.encode_task_status(doc, "tid")
    assert ref_thrift.decode_task_status(port) == decode_task_status(port)


def test_worker_negotiates_thrift_status():
    from presto_tpu_torch.server.client import WorkerClient
    from presto_tpu_torch.server.worker import TpuWorkerServer
    srv = TpuWorkerServer(sf=SF, device="cpu").start()
    try:
        plan = N.OutputNode(
            N.TableScanNode("tpch", "region", ["regionkey"], [T.BIGINT]),
            ["regionkey"])
        c = WorkerClient(srv.url)
        c.submit("th-1", plan, sf=SF)
        c.wait("th-1")
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
        conn.request("GET", "/v1/task/th-1/status")
        r = conn.getresponse()
        assert r.getheader("Content-Type").startswith("application/json")
        jdoc = json.loads(r.read())
        conn.request("GET", "/v1/task/th-1/status",
                     headers={"Accept": "application/x-thrift"})
        r = conn.getresponse()
        assert r.getheader("Content-Type") == "application/x-thrift"
        raw = r.read()
        tdoc = decode_task_status(raw)
        assert tdoc["taskId"] == "th-1"
        assert tdoc["state"] == jdoc["state"] == "FINISHED"
        assert tdoc["self"] == jdoc["self"]
        # the reference decodes the port worker's bytes to the same doc,
        # and they are the bytes it would write for the JSON document
        assert ref_thrift.decode_task_status(raw) == tdoc
        assert raw == ref_thrift.encode_task_status(jdoc, "th-1")
        conn.close()
    finally:
        srv.stop()
