"""`presto_tpu_torch.sql` against `presto_tpu.sql.sql`, on the CPU: the
22 statements of the reference's DEFAULT_CORPUS, the meta statements
(PREPARE, EXECUTE, DEALLOCATE, SHOW, DESCRIBE), SQL-invoked functions,
the writes over the memory catalog (after each, the two stores hold the
same tables), the CLI's table, and the errors.

Each package plans and runs the text itself; nothing crosses between
them but the text."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from _torch_sql_common import exact, same_rows  # noqa: E402

from presto_tpu.cli import _format_table as ref_format_table  # noqa: E402
from presto_tpu.connectors import memory as rmemory  # noqa: E402
from presto_tpu.sql import sql as ref_sql  # noqa: E402
from presto_tpu.sql.udf import reset_functions as ref_reset  # noqa: E402
from presto_tpu.verifier import DEFAULT_CORPUS  # noqa: E402

from presto_tpu_torch import sql  # noqa: E402
from presto_tpu_torch.connectors import memory as pmemory  # noqa: E402
from presto_tpu_torch.sql.udf import reset_functions  # noqa: E402

SF = 0.01
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while the module runs: several threads a worker
    only oversubscribe the cores under the parallel test run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def clean_state():
    for reset in (rmemory.reset, pmemory.reset, ref_reset, reset_functions):
        reset()
    yield
    for reset in (rmemory.reset, pmemory.reset, ref_reset, reset_functions):
        reset()


def port(text, **kw):
    return sql(text, sf=SF, device="cpu", **kw)


@pytest.mark.parametrize("i", range(len(DEFAULT_CORPUS)),
                         ids=lambda i: f"entry{i}")
def test_verifier_statement_rows_equal_the_reference(i):
    same_rows(DEFAULT_CORPUS[i])


def test_prepare_execute_deallocate():
    """q6's date and discount as parameters, as chip_smoke.py runs it."""
    text = ("PREPARE q6 FROM SELECT sum(extendedprice * discount) AS "
            "revenue FROM lineitem WHERE shipdate >= ? AND shipdate < "
            "date '1995-01-01' AND discount BETWEEN ? - 0.01 AND ? + 0.01 "
            "AND quantity < 24")
    for run in (port, lambda t: ref_sql(t, sf=SF)):
        ack = run(text)
        assert ack.names == ["PREPARE"] and ack.row_count == 0
    execute = "EXECUTE q6 USING date '1994-01-01', 0.06, 0.06"
    got = same_rows(execute)
    direct = same_rows("SELECT sum(extendedprice * discount) AS revenue "
                       "FROM lineitem WHERE shipdate >= date '1994-01-01' "
                       "AND shipdate < date '1995-01-01' AND discount "
                       "BETWEEN 0.05 AND 0.07 AND quantity < 24")
    assert exact(got) == exact(direct)
    assert port("DEALLOCATE PREPARE q6").names == ["DEALLOCATE"]
    ref_sql("DEALLOCATE PREPARE q6", sf=SF)
    with pytest.raises(KeyError, match="not found"):
        port(execute)


def test_execute_with_a_count_parameter():
    for run in (port, lambda t: ref_sql(t, sf=SF)):
        run("PREPARE pq FROM SELECT count(*) FROM lineitem WHERE "
            "quantity < ?")
    n10 = same_rows("EXECUTE pq USING 10").rows()[0][0]
    n50 = same_rows("EXECUTE pq USING 50").rows()[0][0]
    assert 0 < n10 < n50
    port("DEALLOCATE PREPARE pq")
    ref_sql("DEALLOCATE PREPARE pq", sf=SF)


@pytest.mark.parametrize("text", [
    "SHOW TABLES FROM tpch", "SHOW TABLES FROM tpch LIKE 'p%'",
    "SHOW TABLES FROM tpcds LIKE 'store%'", "SHOW COLUMNS FROM region",
    "SHOW COLUMNS FROM tpch.lineitem", "DESCRIBE tpch.nation",
    "SHOW SCHEMAS FROM tpch",
    "SELECT count(*) FROM information_schema.columns "
    "WHERE table_catalog = 'tpch'"])
def test_meta_statement_rows_equal_the_reference(text):
    same_rows(text)


def test_show_columns_lists_the_schema():
    from presto_tpu_torch.connectors.tpch import TPCH_SCHEMA
    got = port("SHOW COLUMNS FROM lineitem").rows()
    assert [(r[0], r[1]) for r in got] == \
        [(c, str(t)) for c, t in TPCH_SCHEMA["lineitem"]]
    assert port("SELECT count(*) FROM information_schema.columns "
                "WHERE table_catalog = 'tpch'").rows() == [(61,)]


def test_show_catalogs_lists_the_ports_catalogs():
    """SHOW CATALOGS, SHOW SESSION and SHOW FUNCTIONS read the system
    connector's tables in both packages, and give the same rows: the
    whole registry of catalogs, the session properties and the
    functions."""
    got = [r[0] for r in port("SHOW CATALOGS").rows()]
    assert "system" in got and "localfile" in got
    for text in ("SHOW CATALOGS", "SHOW SESSION", "SHOW FUNCTIONS"):
        same_rows(text)
    with pytest.raises(ValueError, match="SHOW clause tail"):
        port("SHOW TABLES WHERE x")


def test_sql_invoked_functions():
    """tests/test_sql_functions.py's cycle through both packages, each
    with its own function namespace."""
    for run in (port, lambda t: ref_sql(t, sf=SF)):
        assert run("CREATE FUNCTION double_it(x bigint) RETURNS bigint "
                   "RETURN x * 2").names == ["CREATE FUNCTION"]
        run("CREATE FUNCTION my.math.hyp(a double, b double) RETURNS "
            "double RETURN sqrt(a * a + b * b)")
        run("CREATE FUNCTION halve(x bigint) RETURNS double RETURN x / 2")
        run("CREATE FUNCTION abs(x bigint) RETURNS bigint RETURN x * 100")
    got = same_rows("SELECT double_it(nationkey) FROM nation "
                    "WHERE nationkey < 3 ORDER BY 1")
    assert [r[0] for r in got.rows()] == [0, 2, 4]
    assert same_rows("SELECT double_it(double_it(5))").rows() == [(20,)]
    assert same_rows("SELECT my.math.hyp(3.0, 4.0)").rows() == [(5.0,)]
    assert same_rows("SELECT halve(5)").rows() == [(2.0,)]
    assert same_rows("SELECT abs(-3)").rows() == [(3,)]
    with pytest.raises(KeyError, match="already exists"):
        port("CREATE FUNCTION halve(x bigint) RETURNS bigint RETURN x")
    port("CREATE OR REPLACE FUNCTION halve(x bigint) RETURNS bigint "
         "RETURN x + 10")
    assert port("SELECT halve(1)").rows() == [(11,)]
    with pytest.raises(ValueError, match="argument"):
        port("SELECT halve(1, 2)")
    assert port("DROP FUNCTION double_it").names == ["DROP FUNCTION"]
    with pytest.raises(NotImplementedError):
        port("SELECT double_it(1)")
    port("DROP FUNCTION IF EXISTS double_it")


def _stores_equal():
    assert pmemory.table_names() == rmemory.table_names()
    for name in pmemory.table_names():
        p, r = pmemory._tables[name], rmemory._tables[name]
        assert p.columns == r.columns
        assert [str(t) for t in p.types] == [str(t) for t in r.types]
        for pv, pn, rv, rn in zip(p.values, p.nulls, r.values, r.nulls):
            assert pn.tolist() == np.asarray(rn).tolist()
            assert [v for v, n in zip(pv.tolist(), pn) if not n] == \
                [v for v, n in zip(np.asarray(rv).tolist(), rn) if not n]


def test_writes_over_the_memory_catalog():
    """CTAS, INSERT, DELETE, UPDATE and DROP as SQL text, each through
    both packages, the two stores equal after every statement."""
    steps = [
        "CREATE TABLE memory.l AS SELECT orderkey, linenumber, quantity, "
        "shipdate, returnflag FROM lineitem WHERE orderkey < 400",
        "INSERT INTO memory.l SELECT orderkey, linenumber, quantity, "
        "shipdate, returnflag FROM lineitem WHERE orderkey BETWEEN 400 "
        "AND 600",
        "DELETE FROM memory.l WHERE quantity > 45.00",
        "UPDATE memory.l SET quantity = quantity + 1.00 WHERE "
        "returnflag = 'R'",
    ]
    for text in steps:
        same_rows(text)
        _stores_equal()
    got = same_rows("SELECT returnflag, count(*), sum(quantity) FROM l "
                    "GROUP BY returnflag ORDER BY returnflag",
                    catalog="memory")
    assert got.row_count == 3
    assert same_rows("DROP TABLE memory.l").rows() == [(True,)]
    _stores_equal()
    assert "l" not in pmemory.SCHEMA


def test_cli_prints_the_reference_table():
    text = ("SELECT returnflag, linestatus, sum(quantity) AS q, "
            "count(*) AS n FROM lineitem GROUP BY returnflag, linestatus "
            "ORDER BY returnflag, linestatus")
    out = subprocess.run(
        [sys.executable, "-m", "presto_tpu_torch.cli", text, "--sf",
         str(SF), "--device", "cpu"], capture_output=True, text=True,
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO}, check=True).stdout
    want = ref_sql(text, sf=SF)
    lines = out.rstrip("\n").split("\n")
    assert "\n".join(lines[:-1]) == ref_format_table(
        want.names, want.rows(), want.types)
    assert lines[-1].startswith(f"({want.row_count} rows in ")


def test_cli_explain_and_trace_answer(capsys):
    """EXPLAIN prints the reference's plan lines, and --trace renders
    the query's trace as a waterfall."""
    from presto_tpu.plan import explain as ref_explain
    from presto_tpu.sql import plan_sql as ref_plan_sql

    from presto_tpu_torch import cli
    from presto_tpu_torch.server.tracing import get_tracer, set_tracer
    assert cli.main(["EXPLAIN SELECT 1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    want = ref_explain(ref_plan_sql("SELECT 1"), regions=False, sf=0.01)
    assert out.rstrip("\n").split("\n") == want.split("\n")
    before = get_tracer()
    try:
        assert cli.main(["SELECT count(*) FROM region", "--trace",
                         "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "stage.execute" in out and "critical path" in out
    finally:
        set_tracer(before)
    # --server now speaks the client protocol: with nothing listening,
    # the connection is refused
    with pytest.raises(OSError):
        cli.main(["SELECT 1", "--server", "http://127.0.0.1:1"])


def test_unknown_table_raises_key_error_in_both():
    for run in (port, lambda t: ref_sql(t, sf=SF)):
        with pytest.raises(KeyError):
            run("SELECT x FROM no_such_table")
        with pytest.raises(KeyError):
            run("SELECT x FROM nowhere.t")


def test_sql_runs_on_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sql("SELECT count(*) FROM region", sf=SF)
