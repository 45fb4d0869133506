"""The port's Presto-protocol adapter (presto_tpu_torch/server/protocol.py)
against the reference's.

Every fixture in tests/fixtures/protocol/ goes through both packages'
translation (a node through `translate_node`, a fragment through
`translate_fragment`, a TaskUpdateRequest through
`parse_task_update_request`): the plan JSON must be equal (node ids
renumbered by first appearance), and a refusal must be one in both.
The port's JSON also carries the aggregates' masks, which the
reference's JSON drops: those are held to the reference's in-memory
AggSpecs. A port worker answers TaskUpdateRequestQ3.json with the
reference worker's pages.
"""

import base64
import json
import os
import time

import numpy as np
import pytest
import torch

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
from presto_tpu.plan import nodes as RN
from presto_tpu.server import TpuWorkerServer as RefWorker
from presto_tpu.server import protocol as RP

from presto_tpu_torch.connectors import tpch
from presto_tpu_torch.exec import run_query
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.server import TpuWorkerServer, WorkerClient
from presto_tpu_torch.server import protocol as PP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures", "protocol")
SF = 0.01

NODE_FIXTURES = ["AggMaskedDistinct.json", "DistinctLimitNode.json",
                 "ExchangeNode.json", "FilterNode.json", "GroupIdNode.json",
                 "JoinNode.json", "JoinNodeLeft.json",
                 "JoinNodeResidualFilter.json", "MarkDistinctNode.json",
                 "OutputNode.json", "RemoteSourceNodeHttp.json",
                 "RowNumberNode.json", "SemiJoinNode.json",
                 "TopNRowNumberNode.json", "UnnestNode.json",
                 "ValuesNode.json", "WindowNode.json"]
REQUESTS = ["TaskUpdateRequest.1", "TaskUpdateRequest.2",
            "TaskUpdateRequestQ3.json", "external/TaskUpdateRequest.1",
            "external/TaskUpdateRequest.2"]


def load(name):
    with open(os.path.join(FIX, name)) as f:
        return json.load(f)


def canonical(j):
    """Plan JSON with each node id replaced by the index of its first
    appearance."""
    ids = {}

    def walk(v):
        if isinstance(v, dict):
            return {k: ids.setdefault(x, len(ids)) if k == "id" else walk(x)
                    for k, x in v.items()}
        if isinstance(v, list):
            return [walk(x) for x in v]
        return v
    return walk(j)


def _without_masks(j):
    """The port's JSON less the keys the reference's JSON leaves out."""
    if isinstance(j, dict):
        return {k: _without_masks(v) for k, v in j.items()
                if k not in ("maskChannel", "parameter")}
    if isinstance(j, list):
        return [_without_masks(v) for v in j]
    return j


def _aggs(node, kinds_mod):
    out = []

    def walk(n):
        if isinstance(n, kinds_mod.AggregationNode):
            out.extend((a.mask_channel, a.parameter) for a in n.aggregates)
        for s in n.sources:
            walk(s)
    walk(node)
    return out


def _outcome(fn, doc):
    """("ok", plan, layout or info) or ("refused", message)."""
    try:
        return ("ok",) + tuple(fn(doc))
    except (RP.ProtocolUnsupported, PP.ProtocolUnsupported, KeyError,
            TypeError) as e:
        return ("refused", type(e).__name__, str(e))


def _assert_same(port_plan, ref_plan):
    pj = N.to_json(port_plan)
    rj = RN.to_json(ref_plan)
    assert canonical(_without_masks(pj)) == canonical(rj)
    assert _aggs(port_plan, N) == _aggs(ref_plan, RN)


@pytest.mark.parametrize("name", NODE_FIXTURES)
def test_node_fixture_translates_to_the_reference_plan(name):
    j = load(name)
    port = _outcome(PP.translate_node, j)
    ref = _outcome(RP.translate_node, j)
    assert port[0] == ref[0]
    if port[0] == "refused":
        assert port[1:] == ref[1:]
        return
    _assert_same(port[1], ref[1])
    assert [(n, str(t)) for n, t in port[2]] == \
        [(n, str(t)) for n, t in ref[2]]


def test_plan_fragment_with_remote_source():
    j = load("PlanFragmentWithRemoteSource.json")
    (proot, pinfo), (rroot, rinfo) = PP.translate_fragment(j), \
        RP.translate_fragment(j)
    _assert_same(proot, rroot)
    assert pinfo == rinfo
    # the base64 wire form too
    b64 = base64.b64encode(json.dumps(j).encode()).decode()
    _assert_same(PP.translate_fragment(b64)[0], rroot)


@pytest.mark.parametrize("name", REQUESTS)
def test_task_update_request_parses_as_the_reference(name):
    d = load(name)
    try:
        pd = PP.parse_task_update_request(d)
    except PP.ProtocolUnsupported as e:
        with pytest.raises(RP.ProtocolUnsupported) as ei:
            RP.parse_task_update_request(d)
        assert str(e) == str(ei.value)
        return
    rd = RP.parse_task_update_request(d)
    assert set(pd) == set(rd)
    for k in pd:
        if k == "plan":
            _assert_same(pd["plan"], rd["plan"])
        else:
            assert pd[k] == rd[k], k


def test_hive_request_refused_naming_the_connector():
    with pytest.raises(PP.ProtocolUnsupported, match="hive"):
        PP.parse_task_update_request(load("TaskUpdateRequest.1"))


@pytest.mark.parametrize("name,field,value", [
    ("JoinNode.json", "type", "CROSS"),
    ("JoinNodeResidualFilter.json", "type", "LEFT")])
def test_unsupported_shapes_refused_in_both(name, field, value):
    j = load(name)
    j[field] = value
    with pytest.raises(PP.ProtocolUnsupported) as pe:
        PP.translate_node(j)
    with pytest.raises(RP.ProtocolUnsupported) as re_:
        RP.translate_node(j)
    assert str(pe.value) == str(re_.value)


def test_unsupported_node_rejected_with_reason():
    with pytest.raises(PP.ProtocolUnsupported, match="SpatialJoinNode"):
        PP.translate_node({"@type": ".SpatialJoinNode", "id": "9"})


def test_masked_aggregate_arrives_and_runs():
    """AggMaskedDistinct.json: count(custkey) under the MarkDistinct
    mask, count(*), and sum(DISTINCT totalprice). The mask reaches the
    port's AggSpec, survives its plan JSON, and the rows are the
    oracle's."""
    node, out = PP.translate_node(load("AggMaskedDistinct.json"))
    assert [n for n, _ in out] == ["distinct_custs", "n",
                                   "sum_distinct_price"]
    assert _aggs(node, N)[0][0] is not None
    plan = N.from_json(N.to_json(N.OutputNode(node, [n for n, _ in out])))
    assert _aggs(plan, N) == _aggs(node, N)
    res = run_query(plan, sf=SF, device="cpu")
    od = tpch.generate_columns("orders", SF, ["custkey", "totalprice"])
    (custs, n, sum_p), = res.rows()
    assert int(custs) == len(set(od["custkey"].tolist()))
    assert int(n) == len(od["custkey"])
    assert int(sum_p) == sum(set(int(p) for p in od["totalprice"]))


def test_approx_percentile_fraction_comes_from_the_protocol():
    j = load("AggMaskedDistinct.json")
    agg = j["aggregations"]["n<bigint>"]
    call = agg["call"]
    block = base64.b64encode(
        b"\x0a\x00\x00\x00LONG_ARRAY\x01\x00\x00\x00\x00"
        + np.float64(0.5).tobytes()).decode()
    call["functionHandle"]["signature"]["name"] = \
        "presto.default.approx_percentile"
    call["returnType"] = "bigint"
    call["arguments"] = [
        {"@type": "variable", "name": "o_custkey", "type": "bigint"},
        {"@type": "constant", "type": "double", "valueBlock": block}]
    node, _out = PP.translate_node(j)
    assert (None, 0.5) in _aggs(node, N)


def test_protocol_structs_are_the_vocabulary_generated():
    """The port's envelope mirrors are the reference generator's
    output for the port's copy of the vocabulary, docstring aside."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "gen_protocol", os.path.join(REPO, "scripts", "gen_protocol.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    here = os.path.join(REPO, "presto_tpu_torch", "server")
    with open(os.path.join(here, "protocol_vocab.json")) as f:
        vocab = json.load(f)
    with open(os.path.join(REPO, "presto_tpu", "server",
                           "protocol_vocab.json")) as f:
        assert vocab == json.load(f)
    want = gen.generate_py(vocab)
    with open(os.path.join(here, "protocol_structs.py")) as f:
        got = f.read()

    def body(text):
        return text[text.index('"""', 3) + 3:]
    assert body(got) == body(want)


def test_task_info_and_status_documents_equal_the_reference():
    assert PP.task_status_json("t", "RUNNING", "u") == \
        RP.task_status_json("t", "RUNNING", "u")
    assert PP.task_info_json("q.1.2.3", "FINISHED", "http://w", "node-1",
                             123, rows=7) == \
        RP.task_info_json("q.1.2.3", "FINISHED", "http://w", "node-1", 123,
                          rows=7)


# -- a port worker takes a Presto coordinator's request -------------------

@pytest.fixture(scope="module")
def workers():
    torch.set_num_threads(2)
    port = TpuWorkerServer(sf=SF, device="cpu").start()
    ref = RefWorker(sf=SF).start()
    yield port, ref
    port.stop()
    ref.stop()


def _pages(url, task_id):
    c = WorkerClient(url, 60.0)
    info = c.wait(task_id, 60.0)
    assert info["state"] == "FINISHED", info
    out, token = [], 0
    while True:
        data, headers = c._request(
            "GET", f"/v1/task/{task_id}/results/0/{token}")
        if data:
            out.append(data)
            token = int(headers["X-Presto-Page-Next-Token"])
        elif headers["X-Presto-Buffer-Complete"] == "true":
            return out
        else:
            time.sleep(0.02)


def test_q3_request_pages_equal_the_reference_worker(workers):
    port, ref = workers
    doc = load("TaskUpdateRequestQ3.json")
    for w in workers:
        WorkerClient(w.url, 60.0).submit_body("q3-proto", doc)
    got, want = _pages(port.url, "q3-proto"), _pages(ref.url, "q3-proto")
    assert got == want and len(got) == 1
    assert int.from_bytes(got[0][:4], "little") == 10


def test_masked_request_runs_on_a_port_worker(workers):
    """AggMaskedDistinct.json as the fragment of a TaskUpdateRequest:
    the mask crosses the worker's plan JSON."""
    port, _ = workers
    j = load("AggMaskedDistinct.json")
    fragment = {"id": "1", "root": j, "tableScanSchedulingOrder": []}
    doc = {"extraCredentials": {}, "session": {"queryId": "m",
                                               "systemProperties": {}},
           "fragment": base64.b64encode(
               json.dumps(fragment).encode()).decode(),
           "sources": [], "outputIds": {"type": "PARTITIONED",
                                        "buffers": {"0": 0},
                                        "noMoreBufferIds": True}}
    c = WorkerClient(port.url, 60.0)
    c.submit_body("masked", doc)
    assert c.wait("masked", 60)["state"] == "FINISHED"
    from presto_tpu_torch import types as T
    (custs, _), (n, _), _s = c.fetch_results(
        "masked", [T.BIGINT, T.BIGINT, T.decimal(38, 2)])
    od = tpch.generate_columns("orders", SF, ["custkey"])
    assert int(custs[0]) == len(set(od["custkey"].tolist()))
    assert int(n[0]) == len(od["custkey"])


def test_refused_request_answers_400(workers):
    port, _ = workers
    import urllib.error
    with pytest.raises(urllib.error.HTTPError) as ei:
        WorkerClient(port.url).submit_body("hive",
                                           load("TaskUpdateRequest.1"))
    assert ei.value.code == 400
    assert "hive" in json.loads(ei.value.read())["error"]


def test_spec_task_status_and_info(workers):
    port, _ = workers
    import urllib.request
    doc = load("TaskUpdateRequestQ3.json")
    WorkerClient(port.url, 60.0).submit_body("q3-spec", doc)
    WorkerClient(port.url, 60.0).wait("q3-spec", 60)
    with urllib.request.urlopen(f"{port.url}/v1/task/q3-spec/status") as r:
        st = json.loads(r.read())
    assert st["state"] == "FINISHED" and "memoryReservationInBytes" in st
    with urllib.request.urlopen(
            f"{port.url}/v1/task/q3-spec?format=spec") as r:
        ti = json.loads(r.read())
    for key in ("taskId", "taskStatus", "lastHeartbeatInMillis",
                "outputBuffers", "noMoreSplits", "stats", "needsPlan",
                "nodeId"):
        assert key in ti
    assert ti["stats"]["outputPositions"] == 10
    assert ti["outputBuffers"] == RP.task_info_json(
        "x", "FINISHED", "u", "n", 0, rows=10)["outputBuffers"]
