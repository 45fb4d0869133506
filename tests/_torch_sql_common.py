"""Shared by the tests that hold the port's SQL front door against the
reference's: the statement texts, planning through both packages, and
the comparison of two prepared plans.

Two plans are compared as their plan-fragment JSON with every node id
replaced by the index of its first appearance in one fixed walk, so a
wrong sharing of a node shows while the ids' spelling does not. The
reference's side is read through the port's `from_json` first, so both
carry repeated ids (`id.k`) the same way. Constants must match exactly,
except that a folded double may differ from the reference's fold by at
most one ulp: the reference folds under XLA, whose transcendentals are
not all correctly rounded (`cbrt(27.0)` is 3.0000000000000004 there).
"""

from __future__ import annotations

import math
import time
from contextlib import contextmanager
from typing import List, Optional

import presto_tpu  # noqa: F401  (jax x64 before any array is made)
from presto_tpu.exec.runner import prepare_plan as ref_prepare_plan
from presto_tpu.plan import nodes as RN
from presto_tpu.sql import plan_sql as ref_plan_sql
from presto_tpu.sql import statements as ref_statements

from presto_tpu_torch.exec.runner import prepare_plan
from presto_tpu_torch.plan import nodes as PN
from presto_tpu_torch.sql import plan_sql
from presto_tpu_torch.sql import statements

# the instant both packages' statement clocks read in these tests
PINNED_NS = 1_700_000_000_123_456_789


@contextmanager
def pinned_clock():
    """Pin time.time_ns, which both planners read for a statement's
    now() and current_date."""
    real = time.time_ns
    time.time_ns = lambda: PINNED_NS
    try:
        yield
    finally:
        time.time_ns = real


def _t(name, *parts, **kw):
    return (name, "".join(parts), kw)


# The statements of the reference's SQL tests (tests/test_sql.py,
# test_sql_correlated.py, test_sql_derived.py, test_sql_setops_subquery.py,
# test_sql_window.py, test_meta_statements.py), copied with the
# max_groups and join_capacity each passes: (test, text, planning
# keywords). Whitespace outside string literals is folded to one space.
STATEMENT_TEXTS = [
    _t('test_sql::test_simple_select_where',
     'SELECT orderkey, quantity FROM lineitem WHERE quantity > 45.00 '
     'LIMIT 20'),
    _t('test_sql::test_projection_arithmetic',
     'SELECT orderkey, extendedprice * (1 - discount) AS rev FROM '
     'lineitem LIMIT 5'),
    _t('test_sql::test_tpch_q1_sql',
     'SELECT returnflag, linestatus, sum(quantity) AS sum_qty, '
     'sum(extendedprice) AS sum_base_price, sum(extendedprice * (1 - '
     'discount)) AS sum_disc_price, count(*) AS count_order FROM '
     "lineitem WHERE shipdate <= date '1998-12-01' - interval '90' day "
     'GROUP BY returnflag, linestatus ORDER BY returnflag, linestatus',
     max_groups=16),
    _t('test_sql::test_tpch_q6_sql',
     'SELECT sum(extendedprice * discount) AS revenue FROM lineitem '
     "WHERE shipdate >= date '1994-01-01' AND shipdate < date "
     "'1995-01-01' AND discount BETWEEN 0.05 AND 0.07 AND quantity < "
     '24', max_groups=4),
    _t('test_sql::test_tpch_q3_sql',
     'SELECT l.orderkey, sum(l.extendedprice * (1 - l.discount)) AS '
     'revenue, o.orderdate, o.shippriority FROM customer c JOIN orders '
     'o ON c.custkey = o.custkey JOIN lineitem l ON l.orderkey = '
     "o.orderkey WHERE c.mktsegment = 'BUILDING' AND o.orderdate < "
     "date '1995-03-15' AND l.shipdate > date '1995-03-15' GROUP BY "
     'l.orderkey, o.orderdate, o.shippriority ORDER BY revenue DESC, '
     'o.orderdate LIMIT 10', max_groups=16384),
    _t('test_sql::test_group_by_having',
     'SELECT custkey, count(*) AS c FROM orders GROUP BY custkey '
     'HAVING count(*) >= 30 ORDER BY c DESC', max_groups=4096),
    _t('test_sql::test_distinct_and_in',
     "SELECT DISTINCT shipmode FROM lineitem WHERE shipmode IN ('AIR', "
     "'MAIL', 'SHIP')", max_groups=64),
    _t('test_sql::test_case_and_like',
     "SELECT sum(CASE WHEN type LIKE 'PROMO%' THEN retailprice ELSE 0 "
     'END), count(*) FROM part', max_groups=4),
    _t('test_sql::test_coalesce_nullif_if_functions',
     'SELECT coalesce(nullif(regionkey, 0), 99), if(regionkey > 2, 1, '
     '0) FROM region ORDER BY 1'),
    _t('test_sql::test_self_join',
     'SELECT n1.name, count(*) AS same_region FROM nation n1 JOIN '
     'nation n2 ON n1.regionkey = n2.regionkey GROUP BY n1.name ORDER '
     'BY n1.name LIMIT 5', max_groups=64),
    _t('test_sql::test_explain_sql_plan',
     'SELECT custkey, count(*) FROM orders GROUP BY custkey'),
    _t('test_sql_correlated::test_tpch_q4_exists',
     'SELECT o.orderpriority, count(*) AS order_count FROM orders o '
     "WHERE o.orderdate >= date '1993-07-01' AND o.orderdate < date "
     "'1993-10-01' AND EXISTS (SELECT l.orderkey FROM lineitem l WHERE "
     'l.orderkey = o.orderkey AND l.commitdate < l.receiptdate) GROUP '
     'BY o.orderpriority ORDER BY o.orderpriority',
     max_groups=16, join_capacity=131072),
    _t('test_sql_correlated::test_not_exists_anti_join',
     'SELECT count(*) FROM customer c WHERE NOT EXISTS (SELECT '
     'o.custkey FROM orders o WHERE o.custkey = c.custkey)',
     max_groups=4, join_capacity=32768),
    _t('test_sql_correlated::test_tpch_q17_correlated_scalar_avg',
     'SELECT sum(l.extendedprice) AS total FROM lineitem l JOIN part p '
     "ON p.partkey = l.partkey WHERE p.brand = 'Brand#23' AND "
     "p.container = 'MED BOX' AND l.quantity < (SELECT 0.2 * "
     'avg(l2.quantity) FROM lineitem l2 WHERE l2.partkey = l.partkey)',
     max_groups=8192, join_capacity=131072),
    _t('test_sql_correlated::test_tpch_q20_nested_correlated',
     'SELECT count(*) FROM supplier s WHERE s.suppkey IN (SELECT '
     'ps.suppkey FROM partsupp ps WHERE ps.availqty > (SELECT 0.5 * '
     'sum(l.quantity) FROM lineitem l WHERE l.partkey = ps.partkey AND '
     'l.suppkey = ps.suppkey))', max_groups=131072, join_capacity=131072),
    _t('test_sql_correlated::test_tpch_q2_correlated_min_with_joins',
     'SELECT s.acctbal, s.name, p.partkey FROM part p JOIN partsupp ps '
     'ON p.partkey = ps.partkey JOIN supplier s ON s.suppkey = '
     'ps.suppkey JOIN nation n ON s.nationkey = n.nationkey WHERE '
     'p.size = 15 AND n.regionkey = 3 AND ps.supplycost = (SELECT '
     'min(ps2.supplycost) FROM partsupp ps2 JOIN supplier s2 ON '
     's2.suppkey = ps2.suppkey JOIN nation n2 ON s2.nationkey = '
     'n2.nationkey WHERE ps2.partkey = p.partkey AND n2.regionkey = 3) '
     'ORDER BY s.acctbal DESC, p.partkey LIMIT 10',
     max_groups=8192, join_capacity=131072),
    _t('test_sql_correlated::test_tpch_q21_correlated_inequality_exists',
     'SELECT s.name, count(*) AS numwait FROM supplier s JOIN lineitem '
     'l1 ON s.suppkey = l1.suppkey JOIN orders o ON o.orderkey = '
     "l1.orderkey WHERE o.orderstatus = 'F' AND l1.receiptdate > "
     'l1.commitdate AND EXISTS (SELECT l2.orderkey FROM lineitem l2 '
     'WHERE l2.orderkey = l1.orderkey AND l2.suppkey <> l1.suppkey) '
     'AND NOT EXISTS (SELECT l3.orderkey FROM lineitem l3 WHERE '
     'l3.orderkey = l1.orderkey AND l3.suppkey <> l1.suppkey AND '
     'l3.receiptdate > l3.commitdate) GROUP BY s.name ORDER BY numwait '
     'DESC, s.name LIMIT 10', max_groups=8192, join_capacity=262144),
    _t('test_sql_correlated::test_unqualified_names_bind_innermost',
     'SELECT count(*) FROM orders o WHERE EXISTS (SELECT l.orderkey '
     'FROM lineitem l WHERE l.orderkey = o.orderkey AND commitdate > '
     'receiptdate)', max_groups=4, join_capacity=131072),
    _t('test_sql_correlated::test_limit_inside_exists_is_per_row',
     'SELECT count(*) FROM part p WHERE EXISTS (SELECT ps.partkey FROM '
     'partsupp ps WHERE ps.partkey = p.partkey LIMIT 1)',
     max_groups=4, join_capacity=32768),
    _t('test_sql_correlated::test_correlated_count_star_zero_matches',
     'SELECT count(*) FROM customer c WHERE (SELECT count(*) FROM '
     'orders o WHERE o.custkey = c.custkey) < 5',
     max_groups=4096, join_capacity=32768),
    _t('test_sql_correlated::test_exists_with_residual_inner_filter',
     'SELECT count(*) FROM part p WHERE EXISTS (SELECT ps.partkey FROM '
     'partsupp ps WHERE ps.partkey = p.partkey AND ps.availqty < 100)',
     max_groups=4, join_capacity=32768),
    _t('test_sql_derived::test_from_subquery_basic',
     'SELECT big.custkey FROM (SELECT custkey, totalprice FROM orders '
     'WHERE totalprice > 400000.00) big ORDER BY big.custkey LIMIT 5'),
    _t('test_sql_derived::test_tpch_q13_agg_over_agg',
     'SELECT c_count, count(*) AS custdist FROM (SELECT custkey, '
     'count(*) AS c_count FROM orders GROUP BY custkey) c_orders GROUP '
     'BY c_count ORDER BY custdist DESC, c_count DESC', max_groups=8192),
    _t('test_sql_derived::test_tpch_q15_cte_revenue_view',
     'WITH revenue AS ( SELECT suppkey AS supplier_no, '
     'sum(extendedprice * (1 - discount)) AS total_revenue FROM '
     "lineitem WHERE shipdate >= date '1996-01-01' AND shipdate < date "
     "'1996-04-01' GROUP BY suppkey) SELECT s.suppkey, r.total_revenue "
     'FROM supplier s JOIN revenue r ON s.suppkey = r.supplier_no '
     'WHERE r.total_revenue > (SELECT max(total_revenue) * 0.999 FROM '
     'revenue) ORDER BY s.suppkey', max_groups=8192, join_capacity=32768),
    _t('test_sql_derived::test_cte_referencing_earlier_cte',
     'WITH big AS (SELECT custkey, totalprice FROM orders WHERE '
     'totalprice > 300000.00), cnts AS (SELECT custkey, count(*) AS c '
     'FROM big GROUP BY custkey) SELECT max(c) FROM cnts', max_groups=8192),
    _t('test_sql_derived::test_rollup_grouping_sets',
     'SELECT returnflag, linestatus, sum(quantity) AS q FROM lineitem '
     'GROUP BY ROLLUP(returnflag, linestatus) ORDER BY q DESC', max_groups=64),
    _t('test_sql_setops_subquery::test_union_all_and_distinct',
     'SELECT nationkey FROM nation WHERE nationkey < 3 UNION ALL '
     'SELECT nationkey FROM nation WHERE nationkey < 2'),
    _t('test_sql_setops_subquery::test_union_all_and_distinct#1',
     'SELECT nationkey FROM nation WHERE nationkey < 3 UNION SELECT '
     'nationkey FROM nation WHERE nationkey < 2'),
    _t('test_sql_setops_subquery::test_intersect_and_except',
     'SELECT regionkey FROM nation INTERSECT SELECT regionkey FROM '
     'region WHERE regionkey >= 3'),
    _t('test_sql_setops_subquery::test_intersect_and_except#1',
     'SELECT regionkey FROM region EXCEPT SELECT regionkey FROM nation '
     'WHERE regionkey < 2'),
    _t('test_sql_setops_subquery::test_intersect_except_all_bag_semantics',
     'SELECT regionkey FROM nation WHERE nationkey < 12 INTERSECT ALL '
     'SELECT regionkey FROM nation'),
    _t('test_sql_setops_subquery::test_intersect_except_all_bag_semantics#1',
     'SELECT regionkey FROM nation EXCEPT ALL SELECT regionkey FROM '
     'nation WHERE nationkey < 12'),
    _t('test_sql_setops_subquery::test_in_subquery_semijoin',
     'SELECT orderkey FROM orders WHERE custkey IN (SELECT custkey '
     "FROM customer WHERE mktsegment = 'AUTOMOBILE') LIMIT 500"),
    _t('test_sql_setops_subquery::test_not_in_subquery',
     'SELECT nationkey FROM nation WHERE regionkey NOT IN (SELECT '
     'regionkey FROM region WHERE regionkey <= 2)'),
    _t('test_sql_setops_subquery::test_scalar_subquery_comparison',
     'SELECT count(*) FROM customer WHERE acctbal > (SELECT '
     'avg(acctbal) FROM customer WHERE acctbal > 0.00)', max_groups=4),
    _t('test_sql_setops_subquery::test_in_subquery_with_aggregation_outer',
     'SELECT count(*) FROM lineitem WHERE orderkey IN (SELECT orderkey '
     'FROM orders WHERE totalprice > 400000.00)', max_groups=4),
    _t('test_sql_setops_subquery::select_position_scalar_subquery',
     'SELECT n.name, (SELECT max(r.name) FROM region r WHERE '
     'r.regionkey = 0) x, (SELECT r.name FROM region r WHERE '
     'r.regionkey = 99) empty FROM nation n WHERE n.nationkey < 3 '
     'ORDER BY n.name', max_groups=8),
    _t('test_sql_setops_subquery::select_position_scalar_subquery#1',
     'SELECT n.name, (SELECT r.name FROM region r) several FROM nation '
     'n WHERE n.nationkey < 2 ORDER BY n.name', max_groups=8),
    _t('test_sql_window::test_row_number_over_partition',
     'SELECT custkey, orderkey, totalprice, row_number() OVER '
     '(PARTITION BY custkey ORDER BY totalprice DESC) AS rn FROM '
     'orders WHERE custkey <= 50'),
    _t('test_sql_window::test_running_sum_and_rank_over',
     'SELECT orderkey, linenumber, sum(quantity) OVER (PARTITION BY '
     'orderkey ORDER BY linenumber) AS running, rank() OVER (PARTITION '
     'BY orderkey ORDER BY linenumber) AS rk FROM lineitem WHERE '
     'orderkey <= 40'),
    _t('test_sql_window::test_lag_lead',
     'SELECT orderkey, linenumber, lag(quantity) OVER (PARTITION BY '
     'orderkey ORDER BY linenumber) AS prev, lead(quantity, 2) OVER '
     '(PARTITION BY orderkey ORDER BY linenumber) AS nxt2 FROM '
     'lineitem WHERE orderkey <= 20'),
    _t('test_sql_window::test_window_json_roundtrip',
     'SELECT custkey, row_number() OVER (PARTITION BY custkey ORDER BY '
     'totalprice) AS rn FROM orders'),
    _t('test_meta_statements::test_show_catalogs_lists_registry',
     'SHOW CATALOGS'),
    _t('test_meta_statements::test_show_tables_and_columns',
     'SHOW COLUMNS FROM region'),
    _t('test_meta_statements::test_show_tables_and_columns#1',
     'SHOW TABLES FROM tpch'),
    _t('test_meta_statements::test_describe_matches_show_columns',
     'DESCRIBE tpch.nation'),
    _t('test_meta_statements::test_describe_matches_show_columns#1',
     'SHOW COLUMNS FROM tpch.nation'),
    _t('test_meta_statements::test_information_schema_directly_queryable',
     'SELECT count(*) FROM information_schema.columns WHERE '
     "table_catalog = 'tpch'"),
    _t('test_meta_statements::test_show_session_and_functions',
     'SHOW SESSION'),
    _t('test_meta_statements::test_show_session_and_functions#1',
     'SHOW FUNCTIONS'),
    _t('test_meta_statements::test_prepare_execute_end_to_end',
     'PREPARE pq FROM SELECT count(*) FROM lineitem WHERE quantity < ?'),
    _t('test_meta_statements::test_prepare_execute_end_to_end#1',
     'DEALLOCATE PREPARE pq'),
    _t('test_meta_statements::test_prepare_execute_end_to_end#2',
     'EXECUTE pq USING 10'),
    _t('test_meta_statements::test_prepare_execute_end_to_end#3',
     'EXECUTE pq USING 50'),
    _t('test_meta_statements::test_show_tables_like_filters',
     'SHOW TABLES WHERE x'),
    _t('test_meta_statements::test_show_tables_like_filters#1',
     "SHOW TABLES FROM tpch LIKE 'p%'"),
]


def canonical(j):
    """Plan JSON with each node id replaced by the index of its first
    appearance (depth first, keys in order)."""
    ids = {}

    def walk(v):
        if isinstance(v, dict):
            return {k: ids.setdefault(x, len(ids)) if k == "id" else walk(x)
                    for k, x in v.items()}
        if isinstance(v, list):
            return [walk(x) for x in v]
        return v
    return walk(j)


def plan_differences(got, want, path="", ulps: Optional[List] = None):
    """The first place two canonical plans differ, or None. A double
    that differs by one ulp is not a difference; it is appended to
    `ulps` as (path, got, want)."""
    if isinstance(got, bool) or isinstance(want, bool) or \
            type(got) is not type(want):
        if got == want and type(got) is type(want):
            return None
        return f"{path}: {got!r} != {want!r}"
    if isinstance(got, dict):
        if set(got) != set(want):
            return f"{path}: keys {sorted(got)} != {sorted(want)}"
        for k in got:
            d = plan_differences(got[k], want[k], f"{path}.{k}", ulps)
            if d:
                return d
        return None
    if isinstance(got, list):
        if len(got) != len(want):
            return f"{path}: {len(got)} items != {len(want)}"
        for i, (a, b) in enumerate(zip(got, want)):
            d = plan_differences(a, b, f"{path}[{i}]", ulps)
            if d:
                return d
        return None
    if isinstance(got, float) and got != want:
        if math.isfinite(got) and abs(got - want) <= math.ulp(want):
            if ulps is not None:
                ulps.append((path, got, want))
            return None
    return None if got == want else f"{path}: {got!r} != {want!r}"


def port_json(plan) -> dict:
    return canonical(PN.to_json(plan))


def ref_json(plan) -> dict:
    """The reference's plan as the port reads its JSON."""
    return canonical(PN.to_json(PN.from_json(RN.to_json(plan))))


def port_prepared(text: str, sf: float, max_groups: int = 1 << 16,
                  join_capacity=None, catalog=None, session=None):
    """The port's prepare_plan(plan_sql(text)) after its meta-statement
    rewrite."""
    text = statements.preprocess(text, catalog=catalog or "tpch").text
    return prepare_plan(plan_sql(text, max_groups=max_groups,
                                 join_capacity=join_capacity,
                                 catalog=catalog), sf=sf, session=session)


def ref_prepared(text: str, sf: float, max_groups: int = 1 << 16,
                 join_capacity=None, catalog=None, session=None):
    """The reference's prepare_plan(plan_sql(text)), likewise."""
    text = ref_statements.preprocess(text, catalog=catalog or "tpch").text
    return ref_prepare_plan(ref_plan_sql(text, max_groups=max_groups,
                                         join_capacity=join_capacity,
                                         catalog=catalog),
                            sf=sf, session=session)


def assert_same_plan(text: str, sf: float, ulps: Optional[List] = None,
                     **kw) -> None:
    """The port's prepared plan of `text` equals the reference's."""
    with pinned_clock():
        got = port_json(port_prepared(text, sf, **kw))
        want = ref_json(ref_prepared(text, sf, **kw))
    d = plan_differences(got, want, ulps=ulps)
    assert d is None, d


# ---- rows through both packages' sql() ----------------------------------

def exact(res):
    """A result's rows in the corpora's exact form (doubles as
    float.hex)."""
    from presto_tpu_torch import types as PT
    from presto_tpu_torch.queries import exact_rows
    types = [PT.parse_type(str(t)) for t in res.types]
    return exact_rows(res.columns, res.nulls, types, res.row_count)


def same_rows(text: str, sf: float = 0.01, **kw):
    """Run `text` through the reference's sql() and the port's on the
    CPU; the results' names and rows must be equal (in order where the
    statement orders them). Returns the port's result."""
    from presto_tpu.sql import sql as ref_sql
    from presto_tpu_torch.sql import sql
    want = ref_sql(text, sf=sf, **kw)
    got = sql(text, sf=sf, device="cpu", **kw)
    assert list(got.names) == list(want.names)
    g, w = exact(got), exact(want)
    if "order by" in text.lower():
        assert g == w
    else:
        assert sorted(map(str, g)) == sorted(map(str, w))
    return got


def tpch_rows_case(n: int) -> None:
    """TPC-H query `n` at sf 0.01 through both sql() front doors."""
    from presto_tpu.queries.tpch_sql import TPCH_QUERIES
    q = TPCH_QUERIES[n]
    same_rows(q.text, max_groups=q.max_groups, join_capacity=q.join_capacity)


# ---- the plans in which the reference's passes leave one id on several
# nodes (a changed copy keeps its id): planned and prepared at SF1 and
# at the suite scale factors, every one of these has two or more
# distinct node objects under one id before prepare_plan's relabelling
SHARED_ID_TPCDS = ["q1", "q2", "q4", "q11", "q14", "q16", "q23", "q24",
                   "q30", "q31", "q39", "q47", "q57", "q59", "q64", "q74",
                   "q75", "q81", "q94", "q95"]
SHARED_ID_TPCH = ["q15", "q21"]
# TPC-DS queries whose doubles the port holds within rel 1e-9 of the
# reference's (tests/test_torch_tpcds_corpus.py::DOUBLES_WITHIN_RTOL)
TPCDS_DOUBLES_WITHIN_RTOL = {"q2", "q12", "q20", "q31", "q36", "q58",
                             "q59", "q61", "q66", "q83", "q98"}


def ids_on_several_nodes(root) -> List[str]:
    """The node ids that more than one distinct node object carries."""
    objects = {}
    seen = set()

    def walk(n):
        if id(n) in seen:
            return
        seen.add(id(n))
        objects.setdefault(n.id, set()).add(id(n))
        for s in n.sources:
            walk(s)
    walk(root)
    return sorted(k for k, v in objects.items() if len(v) > 1)


def _close(got, want, rel=1e-9):
    """Rows in exact form equal, doubles (float.hex) within `rel`."""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if len(g) != len(w):
            return False
        for a, b in zip(g, w):
            if isinstance(a, str) and isinstance(b, str) and \
                    b.startswith(("0x", "-0x")) and a != b:
                x, y = float.fromhex(a), float.fromhex(b)
                if abs(x - y) > rel * abs(y):
                    return False
            elif a != b:
                return False
    return True


def shared_id_rows_case(name: str) -> None:
    """One of the shared-id plans planned by the port from its text and
    run on the CPU: TPC-H at sf 0.01 against the reference's sql(),
    TPC-DS at its suite scale factor against the committed rows of
    the reference (doubles within rel 1e-9 where the corpus test holds
    them so)."""
    from presto_tpu_torch.queries import load_tpcds_corpus
    from presto_tpu_torch.sql import sql
    if name.startswith("tpch_"):
        return tpch_rows_case(int(name[len("tpch_q"):]))
    q = name[len("tpcds_"):]
    e = load_tpcds_corpus()[q]
    session = {"join_reordering_strategy": "NONE"} if q == "q24" else None
    res = sql(e["sql"], sf=e["sf"], device="cpu", catalog="tpcds",
              max_groups=e["max_groups"], join_capacity=e["join_capacity"],
              session=session)
    assert list(res.names) == e["names"]
    got = exact(res)
    if q in TPCDS_DOUBLES_WITHIN_RTOL:
        assert _close(got, e["rows"])
    else:
        assert got == e["rows"]
