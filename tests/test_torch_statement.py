"""The port's statement tier on the CPU: POST /v1/statement, nextUri
polling and paged results (presto_tpu_torch/server/statement.py), the
session and transaction statements, the CLI and the DB-API over the
wire, held against presto_tpu.

The cases of tests/test_statement_protocol.py run against the port's
StatementServer(device="cpu") with the port's client, their rows held
to the reference's `sql()`. Across packages, the reference's client
reads the port's server and the port's client the reference's server:
both servers must give equal documents, apart from ids, URIs, timings
and the stats fed by the observability ledgers (processed rows and
bytes, progress), which depend on when a poll lands. EXPLAIN and the
ledger routes answer as the reference's do. Every server binds port
0.
"""

import datetime
import decimal
import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

import presto_tpu  # noqa: F401  (jax x64 before any array is made)
from presto_tpu import client as ref_client
from presto_tpu.server.statement import StatementServer as RefServer
from presto_tpu.server.statement import render_value as ref_render
from presto_tpu.sql import sql as ref_sql

from presto_tpu_torch import failpoints
from presto_tpu_torch import types as PT
from presto_tpu_torch.client import QueryError, StatementClient, execute
from presto_tpu_torch.server.dispatcher import Dispatcher, ResourceGroup
from presto_tpu_torch.server.statement import StatementServer, render_value

SF = 0.01


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def server():
    with StatementServer(sf=SF, page_rows=3, device="cpu") as s:
        yield s


@pytest.fixture(scope="module")
def ref_server():
    with RefServer(sf=SF, page_rows=3) as s:
        yield s


def _get(url):
    with urllib.request.urlopen(url) as r:
        return json.loads(r.read())


def test_server_runs_on_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        StatementServer(sf=SF)


def test_lifecycle_and_paging(server):
    text = ("SELECT custkey, count(*) AS n FROM orders "
            "GROUP BY custkey ORDER BY custkey LIMIT 10")
    want = ref_sql(text, sf=SF)
    client = StatementClient(server.url, text, session={"sf": str(SF)})
    assert client.query_id
    hops = 0
    while client.advance():
        hops += 1
        assert hops < 100
    assert client.columns == [{"name": "custkey", "type": "bigint"},
                              {"name": "n", "type": "bigint"}]
    # 10 rows, 3 a page: 4 pages, the last on the final advance()
    assert hops >= 3
    assert client.data == [[int(k), int(n)] for k, n in want.rows()]
    assert client.stats["state"] == "FINISHED"


def test_rendering_decimals_and_dates(server):
    text = "SELECT totalprice, orderdate FROM orders ORDER BY orderkey LIMIT 4"
    client = execute(server.url, text, session={"sf": str(SF)})
    (price, od) = client.data[0]
    assert isinstance(price, str) and "." in price
    assert len(od) == 10 and od[4] == "-"
    want = ref_sql(text, sf=SF)
    assert client.data == [
        [ref_render(v, False, t) for v, t in zip(r, want.types)]
        for r in want.rows()]


@pytest.mark.parametrize("ty,value", [
    ("decimal(12,2)", 12345), ("decimal(12,2)", -5), ("decimal(5,0)", 7),
    ("date", 9131), ("timestamp", 1_700_000_000_123_456), ("double", 2.5),
    ("boolean", True), ("bigint", -3), ("varchar(8)", "abc"),
    ("array(bigint)", [1, None, 3])])
def test_render_value_equals_the_reference(ty, value):
    from presto_tpu import types as RT
    assert render_value(value, False, PT.parse_type(ty)) == \
        ref_render(value, False, RT.parse_type(ty))
    assert render_value(value, True, PT.parse_type(ty)) is None


def test_error_model_syntax(server):
    with pytest.raises(QueryError) as ei:
        execute(server.url, "SELEC nonsense FROM nowhere",
                session={"sf": str(SF)})
    assert ei.value.error["errorCode"] >= 1
    assert ei.value.error["failureInfo"]["message"]


def test_info_and_admin_endpoints(server):
    info = _get(f"{server.url}/v1/info")
    assert info["coordinator"] is True
    client = execute(server.url, "SELECT count(*) AS one FROM region",
                     session={"sf": str(SF)})
    admin = _get(f"{server.url}/v1/query/{client.query_id}")
    assert admin["state"] == "FINISHED"
    assert admin["query"] == "SELECT count(*) AS one FROM region"
    assert "QUEUED" in admin["timings"]
    assert any(d["queryId"] == client.query_id
               for d in _get(f"{server.url}/v1/query"))


def test_session_and_transaction_statements(server):
    c = execute(server.url, "SET SESSION sf = 0.01")
    assert c.update_type == "SET SESSION"
    assert c.set_session == {"sf": "0.01"}
    c = execute(server.url, "START TRANSACTION")
    assert c.update_type == "START TRANSACTION"
    tid = c.started_transaction_id
    assert tid
    c2 = execute(server.url, "SELECT count(*) AS n FROM region",
                 transaction_id=tid, session={"sf": str(SF)})
    assert c2.data == [[5]]
    c3 = execute(server.url, "COMMIT", transaction_id=tid)
    assert c3.clear_transaction
    with pytest.raises(QueryError):
        execute(server.url, "COMMIT", transaction_id=tid)


def test_read_only_transaction_refuses_a_write(server):
    tid = execute(server.url,
                  "START TRANSACTION READ ONLY").started_transaction_id
    with pytest.raises(QueryError, match="read-only"):
        execute(server.url, "INSERT INTO memory.ro SELECT 1 AS x",
                transaction_id=tid)
    execute(server.url, "ROLLBACK", transaction_id=tid)


def test_write_statements_report_their_update_type(server):
    from presto_tpu_torch.connectors import memory
    try:
        c = execute(server.url, "CREATE TABLE memory.st_t AS SELECT "
                    "nationkey FROM nation WHERE nationkey < 4")
        assert c.update_type == "CREATE TABLE AS" and c.data == [[4]]
        c = execute(server.url, "INSERT INTO memory.st_t SELECT 9 AS x")
        assert c.update_type == "INSERT" and c.data == [[1]]
        c = execute(server.url, "DELETE FROM memory.st_t WHERE nationkey > 2")
        assert c.update_type == "DELETE" and c.data == [[2]]
        c = execute(server.url, "DROP TABLE memory.st_t")
        assert c.update_type == "DROP TABLE"
    finally:
        memory.reset()


def test_queue_full_rejection():
    # one running and one queued; the third is rejected (every admission
    # passes the queue counter, so max_queued covers the admitted query)
    d = Dispatcher([ResourceGroup("global", hard_concurrency_limit=1,
                                  max_queued=1)])
    with StatementServer(sf=SF, dispatcher=d, device="cpu") as s:
        release = threading.Event()
        finish = threading.Event()

        def slow_exec(text, sess, qid, tid):
            release.set()
            finish.wait(60)
            from presto_tpu_torch import sql
            return sql("SELECT count(*) AS n FROM region", sf=SF,
                       device="cpu")

        s._executor = slow_exec
        slow = StatementClient(s.url, "SELECT count(*) AS n FROM region")
        assert release.wait(30)
        queued = StatementClient(s.url, "SELECT count(*) AS n FROM region")
        group = d.groups["global"]
        for _ in range(3000):
            if group.stats()["queued"] == 1:
                break
            time.sleep(0.01)
        assert group.stats()["queued"] == 1
        with pytest.raises(QueryError) as ei:
            execute(s.url, "SELECT count(*) AS n FROM nation")
        assert ei.value.error_name == "QUERY_QUEUE_FULL"
        finish.set()
        assert slow.drain().data == [[5]]
        assert queued.drain().data == [[5]]


def test_dbapi_over_the_wire(server):
    import presto_tpu_torch.dbapi as db
    conn = db.connect(server=server.url, user="tester")
    cur = conn.cursor()
    cur.execute("SELECT totalprice, orderdate, custkey FROM orders "
                "ORDER BY orderkey LIMIT 2")
    rows = cur.fetchall()
    assert cur.rowcount == 2
    assert isinstance(rows[0][0], decimal.Decimal)
    assert isinstance(rows[0][1], datetime.date)
    assert isinstance(rows[0][2], int)
    assert [d[0] for d in cur.description] == ["totalprice", "orderdate",
                                               "custkey"]
    want = ref_sql("SELECT totalprice, orderdate, custkey FROM orders "
                   "ORDER BY orderkey LIMIT 2", sf=SF)
    assert [[str(p), d.isoformat(), c] for p, d, c in rows] == \
        [[ref_render(v, False, t) for v, t in zip(r, want.types)]
         for r in want.rows()]
    assert conn._txn_id is not None  # begun implicitly, on the wire
    conn.commit()
    assert conn._txn_id is None
    conn.close()


def test_cli_over_the_wire(server, capsys):
    from presto_tpu_torch.cli import main
    rc = main(["--server", server.url, "--sf", str(SF),
               "SELECT count(*) AS n FROM nation"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "25" in out and "rows in" in out
    rc = main(["--server", server.url, "SELEC 1"])
    assert rc == 1
    assert "error [" in capsys.readouterr().err


def test_cancel(server):
    client = StatementClient(server.url, "SELECT count(*) FROM lineitem",
                             session={"sf": str(SF)})
    client.cancel()
    admin = _get(f"{server.url}/v1/query/{client.query_id}")
    assert admin["state"] in ("CANCELED", "FINISHED", "RUNNING",
                              "PLANNING", "FINISHING")


def test_remote_explain_equals_the_reference(server):
    """The remote EXPLAIN is the plan as execution shapes it, one line
    a row, as the reference's explain(..., regions=False) renders the
    reference's shaped plan."""
    from presto_tpu.exec.runner import prepare_plan as ref_prepare
    from presto_tpu.plan import explain as ref_explain
    from presto_tpu.sql import plan_sql as ref_plan_sql
    text = "SELECT count(*) AS n FROM nation WHERE regionkey < 3"
    c = execute(server.url, f"EXPLAIN {text}", session={"sf": str(SF)})
    assert c.columns == [{"name": "Query Plan", "type": "varchar"}]
    want = ref_explain(ref_prepare(ref_plan_sql(text), sf=SF),
                       regions=False, sf=SF)
    assert [r[0] for r in c.data] == want.splitlines()
    c = execute(server.url, f"EXPLAIN ANALYZE {text}",
                session={"sf": str(SF)})
    lines = [r[0] for r in c.data]
    assert lines[0].startswith("- Output") and "rows=1" in lines[0]
    for section in ("-- stages --", "-- datapath --", "-- accuracy --",
                    "-- timeline --"):
        assert section in lines


def _get_doc(url: str):
    with urllib.request.urlopen(url) as r:
        body = r.read()
        return r.status, r.headers.get("Content-Type", ""), body


@pytest.mark.parametrize("route", ["cluster", "metrics", "profile",
                                   "history", "datapath", "accuracy",
                                   "timeline", "trace/abc"])
def test_ledger_routes_answer_in_the_reference_shape(server, ref_server,
                                                      route):
    """Each route answers as the reference's: the same top-level keys
    (/v1/trace of an unknown id: 404 in both), and /v1/metrics every
    family of the reference's but the four whose sources are not
    ported (plan cache and batching: item 12.4; kernel audit and
    donation: item 16)."""
    from presto_tpu.server.metrics import parse_prometheus
    execute(server.url, "SELECT count(*) FROM region",
            session={"sf": str(SF)})
    if route.startswith("trace/"):
        for base in (server.url, ref_server.url):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(f"{base}/v1/{route}")
            assert ei.value.code == 404
        return
    status, ctype, body = _get_doc(f"{server.url}/v1/{route}")
    _, ref_ctype, ref_body = _get_doc(f"{ref_server.url}/v1/{route}")
    assert status == 200 and ctype == ref_ctype
    if route == "metrics":
        left_out = ("presto_tpu_plan_cache_", "presto_tpu_batch",
                    "presto_tpu_kernel_audit_", "presto_tpu_donat",
                    "presto_tpu_donation")
        got = set(parse_prometheus(body.decode()))
        want = {f for f in parse_prometheus(ref_body.decode())
                if not f.startswith(left_out)}
        assert want <= got
        return
    doc, ref_doc = json.loads(body), json.loads(ref_body)
    assert set(doc) == set(ref_doc)


def test_web_ui_pages(server):
    client = execute(server.url, "SELECT count(*) AS n FROM region",
                     session={"sf": str(SF)})
    with urllib.request.urlopen(f"{server.url}/ui") as r:
        page = r.read().decode()
    assert "presto-tpu coordinator" in page
    assert client.query_id in page
    with urllib.request.urlopen(
            f"{server.url}/ui/query/{client.query_id}") as r:
        detail = r.read().decode()
    assert "FINISHED" in detail and "region" in detail


def test_failpoint_sites_of_the_statement_tier(server):
    """statement.execute fails the query before planning;
    dispatcher.admit fails it before it holds a slot."""
    for site in ("statement.execute", "dispatcher.admit"):
        failpoints.arm(site, "error")
        try:
            with pytest.raises(QueryError, match="failpoint"):
                execute(server.url, "SELECT count(*) FROM region")
        finally:
            failpoints.disarm(site)
        assert server.dispatcher.groups["global"].stats()["running"] == 0
    assert execute(server.url, "SELECT count(*) FROM region").data == [[5]]


def test_session_property_manager_defaults(server):
    from presto_tpu_torch.server.session_properties import \
        set_session_property_manager
    set_session_property_manager([{"user": "dash.*",
                                   "properties": {"sf": "0.001"}}])
    try:
        c = execute(server.url, "SELECT count(*) FROM orders",
                    user="dashboard")
        assert c.data == [[int(ref_sql("SELECT count(*) FROM orders",
                                       sf=0.001).rows()[0][0])]]
        admin = _get(f"{server.url}/v1/query/{c.query_id}")
        assert admin["sessionProperties"]["sf"] == "0.001"
    finally:
        set_session_property_manager(None)


# ---- across packages ------------------------------------------------------

CROSS = [
    ("SELECT custkey, count(*) AS n FROM orders GROUP BY custkey "
     "ORDER BY custkey LIMIT 7", {"sf": str(SF)}),
    ("SELECT totalprice, orderdate, orderpriority FROM orders "
     "ORDER BY orderkey LIMIT 4", {"sf": str(SF)}),
    ("SET SESSION join_capacity = 4096", {}),
]


def _summary(client) -> dict:
    """What both servers must agree on: ids and timings left out, and
    the stats fed by the ledgers (processed rows and bytes, progress),
    which depend on when a poll lands."""
    return {"columns": client.columns, "data": client.data,
            "updateType": client.update_type,
            "setSession": client.set_session,
            "state": client.stats.get("state"),
            "queued": client.stats.get("queued"),
            "scheduled": client.stats.get("scheduled")}


@pytest.mark.parametrize("i", range(len(CROSS)))
def test_each_client_reads_the_other_servers_documents(server, ref_server,
                                                       i):
    text, session = CROSS[i]
    ref_on_port = ref_client.execute(server.url, text, session=session)
    port_on_ref = execute(ref_server.url, text, session=session)
    port_on_port = execute(server.url, text, session=session)
    want = _summary(port_on_ref)
    assert _summary(ref_on_port) == want
    assert _summary(port_on_port) == want


def test_each_client_reads_the_other_servers_errors(server, ref_server):
    text = "SELECT nope FROM nation"
    with pytest.raises(ref_client.QueryError) as on_port:
        ref_client.execute(server.url, text)
    with pytest.raises(QueryError) as on_ref:
        execute(ref_server.url, text)
    assert on_port.value.error_name == on_ref.value.error_name
    assert on_port.value.error["errorCode"] == on_ref.value.error["errorCode"]


def test_cli_prints_the_same_table_from_either_server(server, ref_server,
                                                       capsys):
    from presto_tpu_torch.cli import main
    text = ("SELECT regionkey, count(*) AS n, sum(nationkey) AS s "
            "FROM nation GROUP BY regionkey ORDER BY regionkey")
    tables = []
    for url in (server.url, ref_server.url):
        assert main(["--server", url, "--sf", str(SF), text]) == 0
        out = capsys.readouterr().out.rstrip("\n").split("\n")
        assert out[-1].startswith("(5 rows in ")
        tables.append(out[:-1])
    assert tables[0] == tables[1]
