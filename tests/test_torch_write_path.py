"""The port's memory connector and write roots (CTAS, INSERT, DELETE,
UPDATE, DROP), on the CPU, against presto_tpu.

Each statement is planned once by the reference (plan_sql over its
memory store, which holds what the port's holds). A write root's
inner SELECT is prepared by the reference's prepare_plan, as its
run_query does when the writer re-enters it, and the root is rebuilt
over it; the plan crosses to the port as plan-fragment JSON. Both
packages run it, each against its own store, and after every
statement the two stores must hold the same tables, types, values and
NULLs, and the statements the same results. The two SQL cases of
tests/test_map_row.py over catalog "memory" run the same way.
"""

import dataclasses

import numpy as np
import pytest
import torch

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
from presto_tpu import types as RT
from presto_tpu.connectors import memory as rmemory
from presto_tpu.connectors import tpch as rtpch
from presto_tpu.exec.runner import prepare_plan
from presto_tpu.exec.runner import run_query as ref_run_query
from presto_tpu.plan import nodes as RN
from presto_tpu.sql import plan_sql

from presto_tpu_torch import types as PT
from presto_tpu_torch.connectors import memory as pmemory
from presto_tpu_torch.exec import run_query
from presto_tpu_torch.plan import from_json
from presto_tpu_torch.plan import nodes as PN
from presto_tpu_torch.queries import exact_rows

SF = 0.01


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while the module runs: the port's CPU plans are
    many small ops, which several threads a worker only oversubscribe
    under the parallel test run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def clean_stores():
    rmemory.reset()
    pmemory.reset()
    yield
    rmemory.reset()
    pmemory.reset()


def _wire(plan, sf):
    """The plan as the port reads it: a write root's inner SELECT
    prepared by the reference (its writer prepares it on re-entering
    run_query), any other plan prepared whole."""
    inner = plan.source if isinstance(plan, RN.OutputNode) else plan
    if isinstance(inner, RN.DdlNode):
        return RN.to_json(plan)
    if not isinstance(inner, (RN.TableFinishNode, RN.TableWriterNode,
                              RN.TableRewriteNode)):
        return RN.to_json(prepare_plan(plan, sf=sf))
    chain, node = [], inner
    while not isinstance(node, (RN.TableWriterNode, RN.TableRewriteNode)):
        chain.append(node)  # TableFinish and the exchange below it
        node = node.source
    names = node.column_names if isinstance(node, RN.TableWriterNode) \
        else []
    select = prepare_plan(RN.OutputNode(node.source, names), sf=sf)
    node = dataclasses.replace(node, source=select.source)
    for above in reversed(chain):
        node = dataclasses.replace(above, source=node)
    if isinstance(plan, RN.OutputNode):
        node = dataclasses.replace(plan, source=node)
    return RN.to_json(node)


def _exact(res):
    types = [PT.parse_type(str(t)) for t in res.types]
    return [list(map(str, r)) for r in exact_rows(
        res.columns, res.nulls, types, res.row_count)]


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


def both(text, sf=SF, catalog=None, max_groups=1 << 16, session=None,
         **kw):
    """Run one statement through both packages; the port's result,
    after checking it and the stores against the reference's."""
    plan = plan_sql(text, max_groups=max_groups, catalog=catalog)
    wire = _wire(plan, sf)
    want = ref_run_query(plan, sf=sf, session=session, **kw)
    got = run_query(from_json(wire), sf=sf, device="cpu", prepared=True,
                    session=session,
                    **kw)
    assert got.names == list(want.names)
    assert _exact(got) == _exact(want)
    _stores_equal()
    return got


def test_write_roots_read_back_from_json():
    plan = plan_sql("CREATE TABLE memory.t AS SELECT custkey FROM orders")
    back = from_json(_wire(plan, SF))
    assert isinstance(back.source, PN.TableFinishNode)
    assert isinstance(back.source.source, PN.TableWriterNode)
    assert PN.to_json(back) == _wire(plan, SF)


def test_ctas_and_read_back():
    n = rtpch.table_row_count("orders", SF)
    assert both("CREATE TABLE memory.t AS "
                "SELECT custkey, totalprice FROM orders").rows() == [(n,)]
    assert pmemory.table_row_count("t") == n
    back = both("SELECT custkey, sum(totalprice) AS s FROM t "
                "GROUP BY custkey ORDER BY custkey", catalog="memory",
                max_groups=1 << 11)
    want = both("SELECT custkey, sum(totalprice) AS s FROM orders "
                "GROUP BY custkey ORDER BY custkey", max_groups=1 << 11)
    assert back.rows() == want.rows()


def test_insert_select_appends():
    both("CREATE TABLE memory.t AS SELECT orderkey, custkey FROM orders")
    n = rtpch.table_row_count("orders", SF)
    assert both("INSERT INTO memory.t SELECT orderkey, custkey "
                "FROM orders").rows() == [(n,)]
    assert pmemory.table_row_count("t") == 2 * n
    assert both("SELECT count(*) AS c FROM t",
                catalog="memory").rows() == [(2 * n,)]


def test_insert_values_with_coercions_and_defaults():
    for mod, T in ((rmemory, RT), (pmemory, PT)):
        mod.create_table("v", ["id", "price", "note"],
                         [T.BIGINT, T.decimal(10, 2), T.varchar(8)])
    assert both("INSERT INTO memory.v (id, price) VALUES "
                "(1, 3.5), (2, 4), (3, NULL)").rows() == [(3,)]
    rows = both("SELECT id, price, note FROM v ORDER BY id",
                catalog="memory").rows()
    # 3.5 -> 350 cents, 4 -> 400 cents; note defaulted to NULL
    assert rows == [(1, 350, None), (2, 400, None), (3, None, None)]


def test_join_written_table_against_generator():
    both("CREATE TABLE memory.custs AS SELECT custkey, acctbal FROM customer")
    got = both("SELECT count(*) AS c FROM orders o "
               "JOIN memory.custs c ON o.custkey = c.custkey",
               default_join_capacity=1 << 16)
    assert got.rows() == [(rtpch.table_row_count("orders", SF),)]


def test_drop_table():
    for mod, T in ((rmemory, RT), (pmemory, PT)):
        mod.create_table("d", ["x"], [T.BIGINT])
    assert both("DROP TABLE memory.d").rows() == [(True,)]
    assert "d" not in pmemory.SCHEMA
    with pytest.raises(KeyError):
        run_query(from_json(_wire(plan_sql("DROP TABLE memory.d"), SF)),
                  device="cpu")
    assert both("DROP TABLE IF EXISTS memory.d").rows() == [(True,)]


def test_failed_ctas_rolls_back():
    """A group table of 2 slots over ~1000 custkeys with the adaptive
    rerun off: the overflow raises after the insert began, and the
    half-created table must not stay."""
    plan = plan_sql("CREATE TABLE memory.bad AS SELECT custkey, "
                    "count(*) AS c FROM orders GROUP BY custkey",
                    max_groups=2)
    session = {"adaptive_capacity": False}
    with pytest.raises(RuntimeError):
        ref_run_query(plan, sf=SF, session=session)
    with pytest.raises(RuntimeError, match="overflowed"):
        run_query(from_json(_wire(plan, SF)), sf=SF, device="cpu",
                  session=session)
    assert "bad" not in pmemory.SCHEMA and "bad" not in rmemory.SCHEMA
    _stores_equal()


def test_delete_where():
    for mod, T in ((rmemory, RT), (pmemory, PT)):
        mod.create_table("dl", ["x", "y"], [T.BIGINT, T.varchar(4)])
    both("INSERT INTO memory.dl VALUES (1,'a'), (2,'b'), (3,'c'), (4,'d')")
    assert both("DELETE FROM memory.dl WHERE x > 2").rows() == [(2,)]
    assert both("SELECT x, y FROM dl ORDER BY x", catalog="memory"
                ).rows() == [(1, "a"), (2, "b")]
    # a NULL predicate deletes nothing (WHERE semantics)
    both("INSERT INTO memory.dl (x) VALUES (9)")
    assert both("DELETE FROM memory.dl WHERE y = 'a'").rows() == [(1,)]
    assert both("SELECT count(*) AS n FROM dl",
                catalog="memory").rows() == [(2,)]


def test_delete_all_and_update():
    for mod, T in ((rmemory, RT), (pmemory, PT)):
        mod.create_table("up", ["k", "v"], [T.BIGINT, T.BIGINT])
    both("INSERT INTO memory.up VALUES (1,10), (2,20), (3,30)")
    assert both("UPDATE memory.up SET v = v + 100 WHERE k >= 2"
                ).rows() == [(2,)]
    assert both("SELECT k, v FROM up ORDER BY k", catalog="memory"
                ).rows() == [(1, 10), (2, 120), (3, 130)]
    assert both("UPDATE memory.up SET v = 0").rows() == [(3,)]
    assert both("DELETE FROM memory.up").rows() == [(3,)]
    assert pmemory.table_row_count("up") == 0


def _fill(name, columns, rtypes, ptypes, values, nulls):
    for mod, types in ((rmemory, rtypes), (pmemory, ptypes)):
        mod.create_table(name, columns, types)
        h = mod.begin_insert(name)
        mod.append(h, values, nulls)
        mod.finish_insert(h)


def test_map_functions_over_the_memory_connector():
    """tests/test_map_row.py's map case: cardinality, element_at,
    map_values and map_keys of a stored map column with a NULL map."""
    _fill("mt", ["id", "m"], [RT.BIGINT, RT.map_of(RT.BIGINT, RT.BIGINT)],
          [PT.BIGINT, PT.map_of(PT.BIGINT, PT.BIGINT)],
          [np.array([1, 2, 3], dtype=np.int64),
           np.array([{10: 100, 20: 200}, {10: 7}, None], dtype=object)],
          [np.zeros(3, bool), np.array([False, False, True])])
    _stores_equal()
    assert both("SELECT id, cardinality(m) AS c, element_at(m, 10) AS v "
                "FROM mt ORDER BY id", catalog="memory").rows() == \
        [(1, 2, 100), (2, 1, 7), (3, None, None)]
    rows = both("SELECT id, element_at(map_values(m), 1) AS first_v, "
                "element_at(map_keys(m), -1) AS last_k "
                "FROM mt ORDER BY id", catalog="memory").rows()
    assert rows[0] == (1, 100, 20) and rows[1] == (2, 7, 10)


def test_row_type_query_over_the_memory_connector():
    """tests/test_map_row.py's row case: a stored ROW column with a
    NULL row, staged and fetched back."""
    _fill("rt", ["id", "r"], [RT.BIGINT, RT.row_of(RT.BIGINT, RT.varchar(4))],
          [PT.BIGINT, PT.row_of(PT.BIGINT, PT.varchar(4))],
          [np.array([1, 2, 3], dtype=np.int64),
           np.array([(10, "aa"), (20, "bb"), None], dtype=object)],
          [np.zeros(3, bool), np.array([False, False, True])])
    assert both("SELECT id, r FROM rt ORDER BY id", catalog="memory"
                ).rows() == [(1, (10, "aa")), (2, (20, "bb")), (3, None)]
