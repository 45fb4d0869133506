"""The port's front tier on the CPU, against presto_tpu: the DB-API and
its implicit transactions (presto_tpu_torch/dbapi.py), the
TransactionManager (transaction.py), the system connector
(connectors/system.py), access control (server/access.py), the
resource groups and dispatcher (server/dispatcher.py) and the event
listeners (server/events.py).

The cases of tests/test_dbapi.py, test_transaction.py,
test_system_tables.py, test_access_resource_groups.py and
test_dispatcher_events_metrics.py, through the port. Where a case runs
SQL, the reference runs the same statement and the rows must be equal.
The system tables fed by the observability ledgers answer with the
reference's columns; `plan_cache` refuses, naming ROADMAP queue 1 item
12.4 (the compiled-plan cache).
"""

import threading
import time

import pytest
import torch

import presto_tpu  # noqa: F401  (jax x64 before any array is made)
from presto_tpu.server.access import set_access_control as ref_set_acl
from presto_tpu.sql import sql as ref_sql

import presto_tpu_torch.dbapi as db
from presto_tpu_torch import sql
from presto_tpu_torch.server.access import (AccessControlManager,
                                            AccessDeniedException,
                                            set_access_control)
from presto_tpu_torch.server.dispatcher import (Dispatcher, QueryRejected,
                                                ResourceGroup,
                                                latency_class_groups,
                                                latency_class_selector)
from presto_tpu_torch.server.events import event_listeners
from presto_tpu_torch.transaction import (NotInTransaction,
                                          TransactionManager)

SF = 0.01


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port(text, **kw):
    return sql(text, sf=SF, device="cpu", **kw)


# ---- DB-API (tests/test_dbapi.py) -----------------------------------------

def cpu_connect(**kw):
    return db.connect(device="cpu", **kw)


def test_basic_cursor_flow():
    with cpu_connect(sf=SF) as conn:
        cur = conn.cursor()
        cur.execute("SELECT nationkey, name FROM nation ORDER BY nationkey")
        assert cur.rowcount == 25
        assert cur.description[0][0] == "nationkey"
        first = cur.fetchone()
        assert first[0] == 0 and first[1] == "ALGERIA"
        some = cur.fetchmany(3)
        assert [r[0] for r in some] == [1, 2, 3]
        rest = cur.fetchall()
        assert len(rest) == 21
        assert cur.fetchone() is None
        want = ref_sql("SELECT nationkey, name FROM nation "
                       "ORDER BY nationkey", sf=SF).rows()
        assert [first] + some + rest == [tuple(r) for r in want]


def test_parameters_bind():
    cur = cpu_connect(sf=SF).cursor()
    cur.execute("SELECT count(*) FROM nation WHERE regionkey = ? "
                "AND name <> ?", (3, "x'y"))
    assert cur.fetchone()[0] == 5


def test_question_mark_inside_literal():
    cur = cpu_connect(sf=SF).cursor()
    cur.execute("SELECT count(*) FROM nation WHERE name <> 'A?' "
                "AND regionkey = ?", (1,))
    assert cur.fetchone()[0] == 5
    with pytest.raises(db.ProgrammingError):
        cur.execute("SELECT ? FROM nation", ())


def test_iteration_and_errors():
    conn = cpu_connect(sf=SF)
    cur = conn.cursor()
    with pytest.raises(db.ProgrammingError):
        cur.fetchall()
    with pytest.raises(db.ProgrammingError):
        cur.execute("SELECT nope FROM nation")
    cur.execute("SELECT regionkey FROM region")
    assert sorted(r[0] for r in cur) == [0, 1, 2, 3, 4]
    conn.close()
    with pytest.raises(db.ProgrammingError):
        conn.cursor()


def test_bind_equals_the_reference():
    from presto_tpu.dbapi import _bind as ref_bind
    from presto_tpu_torch.dbapi import _bind
    text = "SELECT ? , '?' , ? , ? , ? FROM t WHERE s = 'it''s ?'"
    params = (None, True, 2.5, "a'b")
    assert _bind(text, params) == ref_bind(text, params)


# ---- transactions (tests/test_transaction.py) -----------------------------

def test_begin_commit_rollback_lifecycle():
    tm = TransactionManager()
    tid = tm.begin(read_only=True)
    assert tm.get(tid).read_only
    tm.commit(tid)
    with pytest.raises(NotInTransaction):
        tm.get(tid)
    tid2 = tm.begin()
    tm.rollback(tid2)
    with pytest.raises(NotInTransaction):
        tm.commit(tid2)


def test_connector_handles_created_lazily_and_cached():
    tm = TransactionManager()
    tid = tm.begin()
    h1 = tm.connector_handle(tid, "tpch")
    h2 = tm.connector_handle(tid, "tpch")
    assert h1 is h2 and h1["connector"] == "tpch"
    assert sorted(tm.get(tid).connector_handles) == ["tpch"]
    assert tm.active()[0]["catalogs"] == ["tpch"]


def test_transaction_documents_equal_the_reference():
    from presto_tpu.transaction import TransactionManager as RefManager
    docs = []
    for tm in (TransactionManager(), RefManager()):
        tid = tm.begin(isolation="SERIALIZABLE", read_only=True)
        tm.connector_handle(tid, "memory")
        doc = tm.active()[0]
        assert doc.pop("transactionId") == tid
        docs.append((doc, {k: v for k, v in
                           tm.connector_handle(tid, "memory").items()
                           if k != "transactionId"}))
    assert docs[0] == docs[1]


def test_read_only_rejects_writes_and_isolation_validated():
    tm = TransactionManager()
    tid = tm.begin(read_only=True)
    with pytest.raises(RuntimeError, match="read-only"):
        tm.access_check_write(tid, "tpch")
    with pytest.raises(ValueError):
        tm.begin(isolation="CHAOS")


def test_autocommit_context_commits_and_rolls_back():
    tm = TransactionManager()
    out = tm.run_autocommit(lambda tid: (tm.get(tid).auto_commit, 42))
    assert out == (True, 42)
    assert tm.active() == []
    with pytest.raises(RuntimeError, match="boom"):
        tm.run_autocommit(lambda tid: (_ for _ in ()).throw(
            RuntimeError("boom")))
    assert tm.active() == []


def test_idle_transactions_reaped():
    tm = TransactionManager(idle_timeout_s=0.01)
    tid = tm.begin()
    time.sleep(0.05)
    tm.begin()  # the reap runs on begin
    with pytest.raises(NotInTransaction):
        tm.get(tid)


def test_dbapi_implicit_transaction():
    conn = cpu_connect(sf=0.001)
    cur = conn.cursor()
    cur.execute("SELECT count(*) FROM region")
    assert conn._txn_id is not None
    conn.commit()
    assert conn._txn_id is None
    cur.execute("SELECT count(*) FROM region")
    conn.rollback()
    assert conn._txn_id is None
    conn.close()


def test_dbapi_closed_connection_rejects_txn_ops():
    conn = cpu_connect(sf=0.001)
    conn.close()
    for op in (conn.commit, conn.rollback):
        with pytest.raises(db.ProgrammingError):
            op()


def test_dbapi_writable_connection_mode():
    conn = cpu_connect(sf=0.001, read_only=False)
    cur = conn.cursor()
    cur.execute("SELECT count(*) FROM region")
    assert not conn._txn_manager.get(conn._txn_id).read_only
    conn.commit()
    conn.close()


# ---- the system connector (tests/test_system_tables.py) -------------------

def _same(text):
    got, want = port(text), ref_sql(text, sf=SF)
    assert list(got.names) == list(want.names)
    assert [tuple(r) for r in got.rows()] == [tuple(r) for r in want.rows()]
    return got


@pytest.mark.parametrize("text", [
    "SELECT catalog_name FROM system.catalogs ORDER BY catalog_name",
    "SELECT catalog_name, connector_id FROM system.catalogs "
    "ORDER BY catalog_name",
    "SELECT count(*) AS n FROM system.tables WHERE catalog_name = 'tpch'",
    "SELECT catalog_name, table_name, column_count FROM system.tables "
    "WHERE catalog_name <> 'memory' "
    "ORDER BY catalog_name, table_name",
    "SELECT name, default_value, type FROM system.session_properties "
    "ORDER BY name",
    "SELECT kind, count(*) FROM system.functions GROUP BY kind "
    "ORDER BY kind",
    "SHOW CATALOGS", "SHOW SESSION", "SHOW FUNCTIONS",
    "SHOW TABLES FROM system"])
def test_system_rows_equal_the_reference(text):
    _same(text)


def test_catalogs_and_tables():
    names = [r[0] for r in port("SELECT catalog_name FROM system.catalogs "
                                "ORDER BY catalog_name").rows()]
    assert "tpch" in names and "memory" in names and "system" in names
    assert port("SELECT count(*) AS n FROM system.tables "
                "WHERE catalog_name = 'tpch'").rows()[0][0] == 8


def test_queries_table_sees_statement_server():
    from presto_tpu_torch.client import execute
    from presto_tpu_torch.server.statement import StatementServer
    with StatementServer(sf=SF, device="cpu") as s:
        execute(s.url, "SELECT count(*) AS n FROM region",
                session={"sf": str(SF)})
        res = port("SELECT query_id, state, query, resource_group "
                   "FROM system.queries")
        rows = [r for r in res.rows()
                if r[2] == "SELECT count(*) AS n FROM region"]
        assert rows and rows[-1][1] == "FINISHED"
        assert rows[-1][3] == "global"


def test_tasks_table_sees_worker():
    from presto_tpu_torch.server import TpuWorkerServer, WorkerClient
    from presto_tpu_torch.sql import plan_sql
    w = TpuWorkerServer(sf=SF, device="cpu").start()
    try:
        c = WorkerClient(f"http://127.0.0.1:{w.port}")
        c.submit("sys-t1", plan_sql("SELECT count(*) AS n FROM region"),
                 sf=SF)
        c.wait("sys-t1", 60)
        mine = [r for r in port("SELECT task_id, state, rows "
                                "FROM system.tasks").rows()
                if r[0] == "sys-t1"]
        assert mine and mine[0][1] == "FINISHED" and mine[0][2] == 1
    finally:
        w.stop()


def test_live_tasks_lists_queries_that_have_not_ended():
    from presto_tpu_torch.client import StatementClient
    from presto_tpu_torch.server.statement import StatementServer
    with StatementServer(sf=SF, device="cpu") as s:
        gate = threading.Event()

        def held(text, sess, qid, tid):
            # live_tasks lists the progress registry's in-flight
            # entries: this stand-in registers the query as the
            # engine's run_query does, and holds it there
            from presto_tpu_torch.exec import progress
            entry = progress.begin(qid)
            try:
                gate.wait(60)
                return port("SELECT 1 AS x")
            finally:
                entry.release(state="FINISHED")

        s._executor = held
        c = StatementClient(s.url, "SELECT 1 AS x")
        try:
            rows = port("SELECT task_id, kind, state FROM "
                        "system.live_tasks").rows()
            assert (c.query_id, "query", "RUNNING") in \
                [tuple(r) for r in rows]
        finally:
            gate.set()
        c.drain()
        assert c.query_id not in [r[0] for r in port(
            "SELECT task_id FROM system.live_tasks").rows()]


@pytest.mark.parametrize("table", ["plan_cache", "kernels", "datapath",
                                   "cardinality", "occupancy",
                                   "query_history"])
def test_ledger_tables_answer_in_the_reference_columns(table):
    """The five ledger tables have the reference's columns and answer
    a scan (after a query has fed the ledgers); plan_cache refuses,
    naming ROADMAP queue 1 item 12.4."""
    from presto_tpu.connectors.system import SCHEMA as REF_SCHEMA

    from presto_tpu_torch.connectors.system import SCHEMA
    if table == "plan_cache":
        with pytest.raises(NotImplementedError, match="item 12.4"):
            port(f"SELECT * FROM system.{table}")
        return
    assert [(k, str(v)) for k, v in SCHEMA[table].items()] == \
        [(k, str(v)) for k, v in REF_SCHEMA[table].items()]
    from presto_tpu_torch.server.history import get_history_archive
    from presto_tpu_torch.server.statement import StatementServer
    with StatementServer(sf=SF, device="cpu") as s:
        from presto_tpu_torch.client import execute
        execute(s.url, "SELECT count(*) FROM nation")
    assert get_history_archive().size() > 0
    cols = ", ".join(SCHEMA[table])
    res = port(f"SELECT {cols} FROM system.{table}")
    assert res.names == list(SCHEMA[table])
    assert res.row_count > 0


# ---- access control (tests/test_access_resource_groups.py) ----------------

RULES = [
    {"user": "bob", "catalog": "tpch", "table": "region|nation",
     "privileges": ["SELECT"]},
    {"user": "bob", "privileges": []},
    {"user": "eve", "catalog": "tpch", "table": "lineitem",
     "columns": ["orderkey", "quantity"], "privileges": ["SELECT"]},
    {"user": ".*", "privileges": ["SELECT", "INSERT", "DELETE", "UPDATE",
                                  "CREATE", "DROP"]},
]


@pytest.fixture
def clear_acl():
    yield
    set_access_control(None)
    ref_set_acl(None)


def test_first_match_wins_and_denies():
    m = AccessControlManager(RULES)
    m.check_can_select_from_columns("bob", "tpch", "region", ["name"])
    with pytest.raises(AccessDeniedException):
        m.check_can_select_from_columns("bob", "tpch", "lineitem", ["tax"])
    with pytest.raises(AccessDeniedException):
        m.check_can_insert_into_table("bob", "memory", "t")
    m.check_can_insert_into_table("alice", "memory", "t")


def test_column_level_rules():
    m = AccessControlManager(RULES)
    m.check_can_select_from_columns("eve", "tpch", "lineitem",
                                    ["orderkey", "quantity"])
    with pytest.raises(AccessDeniedException, match="column"):
        m.check_can_select_from_columns("eve", "tpch", "lineitem",
                                        ["orderkey", "extendedprice"])


def test_no_rules_allows_everything():
    AccessControlManager().check_can_drop_table("anyone", "any", "thing")


ACL_CASES = [
    ("bob", "SELECT * FROM region"),
    ("bob", "SELECT count(*) FROM lineitem"),
    ("bob", "SELECT count(*) FROM region r JOIN lineitem l "
            "ON l.orderkey = r.regionkey"),
    ("eve", "SELECT sum(quantity) FROM lineitem WHERE orderkey < 100"),
    ("eve", "SELECT sum(tax) FROM lineitem"),
    ("alice", "SELECT count(*) FROM lineitem"),
]


@pytest.mark.parametrize("user,text", ACL_CASES)
def test_enforced_through_the_sql_front_door(clear_acl, user, text):
    """Each package denies what the other denies, before execution, and
    answers the same rows where it allows."""
    set_access_control(RULES)
    ref_set_acl(RULES)
    outcomes = []
    for run in (lambda: port(text, session={"user": user}),
                lambda: ref_sql(text, sf=SF, session={"user": user})):
        try:
            outcomes.append(sorted(map(tuple, run().rows())))
        except PermissionError as e:
            outcomes.append(("denied", str(e)))
    assert outcomes[0] == outcomes[1]


def test_write_checks_enforced(clear_acl):
    from presto_tpu_torch.connectors import memory
    set_access_control([
        {"user": "reader", "privileges": ["SELECT"]},
        {"user": ".*", "privileges": ["SELECT", "INSERT", "CREATE",
                                      "DELETE", "UPDATE", "DROP"]},
    ])
    try:
        port("CREATE TABLE memory.acl_t AS SELECT 1 AS x",
             session={"user": "writer"})
        with pytest.raises(AccessDeniedException):
            port("INSERT INTO memory.acl_t VALUES (2)",
                 session={"user": "reader"})
        with pytest.raises(AccessDeniedException):
            port("DELETE FROM memory.acl_t WHERE x = 1",
                 session={"user": "reader"})
        with pytest.raises(AccessDeniedException):
            port("DROP TABLE memory.acl_t", session={"user": "reader"})
        assert port("SELECT x FROM memory.acl_t",
                    session={"user": "reader"}).rows() == [(1,)]
        port("DROP TABLE memory.acl_t", session={"user": "writer"})
    finally:
        memory.reset()


def test_statement_server_enforces_user_acl(clear_acl):
    from presto_tpu_torch.client import QueryError, execute
    from presto_tpu_torch.server.statement import StatementServer
    set_access_control(RULES)
    with StatementServer(sf=SF, device="cpu") as srv:
        assert execute(srv.url, "SELECT count(*) FROM region",
                       user="bob").data == [[5]]
        with pytest.raises(QueryError, match="Access Denied"):
            execute(srv.url, "SELECT count(*) FROM lineitem", user="bob")
        execute(srv.url, "SELECT count(*) FROM lineitem", user="alice")


# ---- resource groups ------------------------------------------------------

def test_parent_limit_caps_children():
    root = ResourceGroup("root", hard_concurrency_limit=2, max_queued=10)
    a = root.add_child(ResourceGroup("a", hard_concurrency_limit=2))
    b = root.add_child(ResourceGroup("b", hard_concurrency_limit=2))
    a.acquire(mem=0)
    b.acquire(mem=0)
    with pytest.raises(QueryRejected):
        a.acquire(timeout=0.05)
    b.release()
    a.acquire(timeout=1.0)
    assert root.stats()["running"] == 2
    a.release()
    a.release()
    assert root.stats()["running"] == 0


def test_memory_cap_blocks_admission():
    g = ResourceGroup("m", hard_concurrency_limit=8,
                      soft_memory_limit_bytes=1000)
    g.acquire(mem=800)
    with pytest.raises(QueryRejected):
        g.acquire(timeout=0.05, mem=300)
    with pytest.raises(QueryRejected, match="exceeds group"):
        g.acquire(mem=2000)
    g.release(mem=800)
    g.acquire(mem=900)
    g.release(mem=900)


def test_weighted_fair_prefers_underweighted_leaf():
    root = ResourceGroup("root", hard_concurrency_limit=2, max_queued=10)
    heavy = root.add_child(ResourceGroup("heavy", hard_concurrency_limit=8,
                                         scheduling_weight=4))
    light = root.add_child(ResourceGroup("light", hard_concurrency_limit=8,
                                         scheduling_weight=1))
    heavy.acquire()
    heavy.acquire()
    order = []

    def wait_on(g, tag):
        g.acquire()
        order.append(tag)
        g.release()

    # after one release heavy has 1 running / weight 4 = 0.25, light
    # 0 / 1 = 0: light goes first though it queued second
    t1 = threading.Thread(target=wait_on, args=(heavy, "heavy"))
    t2 = threading.Thread(target=wait_on, args=(light, "light"))
    t1.start()
    _wait_for(lambda: root.stats()["queued"] == 1)
    t2.start()
    _wait_for(lambda: root.stats()["queued"] == 2)
    heavy.release()
    _join([t2])
    heavy.release()
    _join([t1])
    assert order == ["light", "heavy"]


def _wait_for(cond, limit_s=60.0):
    deadline = time.time() + limit_s
    while not cond() and time.time() < deadline:
        time.sleep(0.005)
    assert cond()


def _join(threads, limit_s=120.0):
    """Join with a generous limit, then require that each has ended."""
    for t in threads:
        t.join(limit_s)
        assert not t.is_alive()


def test_priority_goes_before_weight():
    """The latency-class tree: an interactive waiter is admitted before
    a dashboard one queued earlier."""
    root = latency_class_groups(root_concurrency=1, root_queued=8)
    d = Dispatcher([root], selector=latency_class_selector)
    assert d.select_group({"latency_class": "batch"}) == "global.batch"
    assert d.select_group({}) == "global"
    dash, inter = d.groups["global.dashboard"], d.groups["global.interactive"]
    dash.acquire()
    order = []

    def wait_on(g, tag):
        g.acquire()
        order.append(tag)
        g.release()

    t1 = threading.Thread(target=wait_on, args=(dash, "dashboard"))
    t2 = threading.Thread(target=wait_on, args=(inter, "interactive"))
    t1.start()
    _wait_for(lambda: root.stats()["queued"] == 1)
    t2.start()
    _wait_for(lambda: root.stats()["queued"] == 2)
    dash.release()
    _join([t1, t2])
    assert order == ["interactive", "dashboard"]


def test_dispatcher_resolves_dotted_groups_and_queue_caps():
    root = ResourceGroup("root", hard_concurrency_limit=1, max_queued=1)
    root.add_child(ResourceGroup("etl", hard_concurrency_limit=1,
                                 max_queued=1))
    d = Dispatcher([root], selector=lambda s: s.get("group", "root.etl"))
    assert d.groups["root.etl"].name == "etl"
    assert d.submit(lambda qid: "ok", session={"group": "root.etl"}) == "ok"
    assert d.group_stats()["root.etl"]["running"] == 0
    assert root.find("root.etl") is d.groups["root.etl"]
    with pytest.raises(QueryRejected, match="no resource group"):
        d.submit(lambda qid: "ok", session={"group": "root.none"})


def test_dispatcher_refuses_a_resource_manager_naming_item_14e():
    """Cluster-wide admission is ported now (tests/test_torch_cluster_
    ops.py): a resource manager that cannot be reached no longer
    refuses the dispatcher, it leaves admission local."""
    d = Dispatcher(resource_manager_url="http://127.0.0.1:1",
                   cluster_limits={"global": 1})
    assert d.resource_manager_url == "http://127.0.0.1:1"
    assert d.submit(lambda qid: "ok", queue_timeout=2.0) == "ok"


def test_group_admission_stress_no_lost_wakeups():
    """Sixty threads over a small hierarchy, with timeouts and memory
    asks: limits never exceeded, every thread finishes, the counters
    return to zero. A start gate makes them all contend at once; each
    join waits up to 300 s (every acquire gives up after 10 s), so a
    loaded host slows the test and does not fail it."""
    root = ResourceGroup("root", hard_concurrency_limit=3, max_queued=64,
                         soft_memory_limit_bytes=1000)
    a = root.add_child(ResourceGroup("a", hard_concurrency_limit=2,
                                     max_queued=64, scheduling_weight=2))
    b = root.add_child(ResourceGroup("b", hard_concurrency_limit=2,
                                     max_queued=64))
    peak = {"root": 0}
    peak_lock = threading.Lock()
    errors = []
    done = []
    gate = threading.Event()

    def worker(i):
        g = a if i % 2 else b
        mem = (i % 3) * 100
        gate.wait(120)
        try:
            g.acquire(timeout=10.0, mem=mem)
        except QueryRejected:
            done.append(i)
            return
        try:
            with peak_lock:
                st = root.stats()
                peak["root"] = max(peak["root"], st["running"])
                if st["running"] > 3:
                    errors.append(f"root over limit: {st['running']}")
                if st["memoryUsedBytes"] > 1000:
                    errors.append("memory over limit")
                for leaf in (a, b):
                    if leaf.stats()["running"] > 2:
                        errors.append(f"{leaf.name} over limit")
            time.sleep(0.002)
        finally:
            g.release(mem=mem)
            done.append(i)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(60)]
    for t in threads:
        t.start()
    gate.set()
    _join(threads, 300.0)
    assert not errors, errors[:3]
    assert sorted(done) == list(range(60))
    assert peak["root"] >= 2
    for g in (root, a, b):
        st = g.stats()
        assert st["running"] == 0 and st["queued"] == 0
        assert st["memoryUsedBytes"] == 0


# ---- dispatcher and events (tests/test_dispatcher_events_metrics.py) ------

def test_dispatcher_concurrency_and_queue():
    g = ResourceGroup("etl", hard_concurrency_limit=2, max_queued=1)
    d = Dispatcher([g], selector=lambda s: "etl")
    running = []
    release = threading.Event()

    def slow(query_id):
        running.append(query_id)
        release.wait(120)
        return None

    threads = [threading.Thread(target=lambda: d.submit(slow), daemon=True)
               for _ in range(2)]
    for t in threads:
        t.start()
    _wait_for(lambda: len(running) == 2)
    assert g.stats()["running"] == 2
    q3 = threading.Thread(target=lambda: d.submit(slow), daemon=True)
    q3.start()
    _wait_for(lambda: g.stats()["queued"] == 1)
    with pytest.raises(QueryRejected, match="queue is full"):
        d.submit(slow)
    release.set()
    _join(threads + [q3])
    assert g.stats()["running"] == 0


def test_dispatcher_fires_lifecycle_events():
    seen = []
    unregister = event_listeners().register(
        lambda name, payload: seen.append((name, payload)))
    try:
        d = Dispatcher()

        class R:
            row_count = 7
        d.submit(lambda qid: R(), query_text="SELECT 7")
        with pytest.raises(RuntimeError):
            d.submit(lambda qid: (_ for _ in ()).throw(RuntimeError("x")))
    finally:
        unregister()
    names = [n for n, _ in seen]
    assert names.count("QueryCreated") == 2
    completed = [p for n, p in seen if n == "QueryCompleted"]
    assert {c["state"] for c in completed} == {"FINISHED", "FAILED"}
    ok = next(c for c in completed if c["state"] == "FINISHED")
    assert ok["outputRows"] == 7


def test_listener_errors_do_not_fail_queries():
    before = event_listeners().listener_errors
    unregister = event_listeners().register(lambda name, payload: 1 / 0)
    try:
        assert Dispatcher().submit(lambda qid: "ok") == "ok"
    finally:
        unregister()
    assert event_listeners().listener_errors == before + 2


def test_worker_fires_task_events():
    """The task events of test_worker_prometheus_metrics_and_task_events
    (its metrics page: tests/test_torch_telemetry.py)."""
    from presto_tpu_torch.connectors import tpch
    from presto_tpu_torch.plan import nodes as N
    from presto_tpu_torch.server import TpuWorkerServer, WorkerClient
    events = []
    unregister = event_listeners().register(
        lambda name, p: events.append((name, p)))
    w = TpuWorkerServer(sf=SF, device="cpu").start()
    try:
        scan = N.TableScanNode("tpch", "region", ["regionkey", "name"],
                               [tpch.column_type("region", c)
                                for c in ("regionkey", "name")])
        c = WorkerClient(f"http://127.0.0.1:{w.port}", 60.0)
        c.submit_body("m.t0", {"plan": N.to_json(N.OutputNode(scan,
                                                              ["k", "n"])),
                               "sf": SF})
        assert c.wait("m.t0", 60.0)["state"] == "FINISHED"
    finally:
        unregister()
        w.stop()
    assert any(n == "TaskCompleted" and p["taskId"] == "m.t0"
               and p["state"] == "FINISHED" and p["outputRows"] == 5
               for n, p in events)
