"""Dynamic filtering through the port, on the CPU, against presto_tpu.

The reference plans each query (plan_sql, prepare_plan) and ships it as
plan-fragment JSON; both packages' collect_dynamic_filters run on the
plan that JSON describes (each package's from_json) and must find the
same filters: the same scan ids, columns, lo/hi and value sets.

Where a plan pass of the reference copied a subtree (TPC-H q21: four
copies of the lineitem-supplier-orders join under AssignUniqueId, all
with the same node ids), the JSON carries every copy. The reference's
from_json reads them as separate nodes, and its collection finds the
same domain once per copy; the port's from_json reads them as one
shared node (plan/nodes.py), which finds it once. Applying a domain
twice prunes what applying it once does, so the reference's repeated
entries count once. (The reference's in-memory plan of q21 keeps one
lineitem scan object under the four copies, and there its collection
finds nothing for that scan; on the wire that sharing is not visible.)

Then the port's run_query must return the same
rows with filtering on (its default) and off, and prune as many rows as
the reference's run_query does. A LEFT join's probe and a scan that a
second branch of the plan DAG reads are never filtered.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
from presto_tpu.exec.dynfilter import \
    collect_dynamic_filters as ref_collect
from presto_tpu.exec.runner import prepare_plan
from presto_tpu.exec.runner import run_query as ref_run_query
from presto_tpu.plan import nodes as RN
from presto_tpu.sql import plan_sql

from presto_tpu_torch import types as PT
from presto_tpu_torch.connectors import tpch
from presto_tpu_torch.exec import run_query
from presto_tpu_torch.exec.dynfilter import collect_dynamic_filters
from presto_tpu_torch.expr import ir as PE
from presto_tpu_torch.plan import from_json
from presto_tpu_torch.plan import nodes as PN
from presto_tpu_torch.plan.widths import annotate_widths
from presto_tpu_torch.queries import exact_rows, load_tpcds_corpus

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from make_tpch_corpus import prepared_entry  # noqa: E402

SF = 0.01
Q_STAR = ("SELECT n.name, count(*) AS c, sum(s.acctbal) AS b "
          "FROM supplier s JOIN nation n ON s.nationkey = n.nationkey "
          "WHERE n.regionkey = 1 GROUP BY n.name")
TPCDS = ("q3", "q42", "q52", "q55")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while the module runs: the port's CPU plans are
    many small ops, which several threads a worker only oversubscribe
    under the parallel test run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _plain(filters):
    """{scan id: [(column, lo, hi, values or None)]} with numbers as
    Python ints or floats, comparable across the packages."""
    def num(x):
        return float(x) if isinstance(x, (float, np.floating)) else int(x)
    return {sid: [(col, num(lo), num(hi),
                   None if vals is None else [num(v) for v in vals])
                  for col, (lo, hi, vals) in doms]
            for sid, doms in filters.items()}


def _once(filters):
    """Each scan's entries with repeats left out, in first-seen order."""
    out = {}
    for sid, doms in filters.items():
        out[sid] = []
        for d in doms:
            if d not in out[sid]:
                out[sid].append(d)
    return out


def _both(ref_plan, sf):
    """(reference's filters, port's filters) on the plan-fragment JSON
    of one prepared plan, each package reading it with its from_json."""
    j = RN.to_json(ref_plan)
    want = _once(_plain(ref_collect(RN.from_json(j), sf)))
    port = annotate_widths(from_json(j), sf)
    return want, _plain(collect_dynamic_filters(port, sf, "cpu"))


@pytest.mark.parametrize("n", range(1, 23), ids=lambda n: f"q{n}")
def test_tpch_filters_equal_the_reference(n):
    want, got = _both(prepared_entry(f"q{n}", SF), SF)
    assert got == want


def test_q_star_filters_equal_the_reference():
    want, got = _both(prepare_plan(plan_sql(Q_STAR), sf=SF), SF)
    assert got == want
    (doms,) = got.values()
    ((_col, lo, hi, values),) = doms
    assert values is not None and 0 < len(values) < 25  # region 1's
    assert 0 <= lo and hi <= 24


@pytest.fixture(scope="module")
def tpcds():
    return load_tpcds_corpus()


@pytest.mark.parametrize("name", TPCDS)
def test_tpcds_filters_equal_the_reference(tpcds, name):
    e = tpcds[name]
    want, got = _both(RN.from_json(e["plan"]), e["sf"])
    assert got == want
    assert got, f"{name}'s dimensions must prune its fact scan"


def _exact(res):
    types = [PT.parse_type(str(t)) for t in res.types]
    return sorted(map(str, exact_rows(res.columns, res.nulls, types,
                                      res.row_count)))


def _on_off(plan_json, sf):
    on = run_query(from_json(plan_json), sf=sf, device="cpu", prepared=True)
    off = run_query(from_json(plan_json), sf=sf, device="cpu", prepared=True,
                    session={"dynamic_filtering": False})
    assert _exact(on) == _exact(off)
    assert "dynamic_filters" not in off.stats
    return on


def test_q_star_rows_and_pruned_rows_equal_the_reference():
    plan = prepare_plan(plan_sql(Q_STAR), sf=SF)
    want = ref_run_query(plan, sf=SF, prepared=True)
    got = _on_off(RN.to_json(plan), SF)
    assert _exact(got) == _exact(want)
    pruned = got.stats["dynamic_filter_rows_pruned"]
    staged = got.stats["dynamic_filter_rows_staged"]
    assert pruned == want.stats["dynamic_filter_rows_pruned"]["total"]
    assert staged == want.stats["dynamic_filter_rows_staged"]["total"]
    assert got.stats["dynamic_filters"] == \
        want.stats["dynamic_filters"]["total"]
    # one region of five: about a fifth of the suppliers survive
    assert 0 < staged < 0.45 * (pruned + staged)


@pytest.mark.parametrize("name", TPCDS)
def test_tpcds_rows_and_pruned_rows_equal_the_reference(tpcds, name):
    e = tpcds[name]
    got = _on_off(e["plan"], e["sf"])
    want_rows = sorted(map(str, e["rows"]))
    assert _exact(got) == want_rows
    want = ref_run_query(RN.from_json(e["plan"]), sf=e["sf"], prepared=True)
    assert got.stats["dynamic_filter_rows_pruned"] == \
        want.stats["dynamic_filter_rows_pruned"]["total"] > 0


@pytest.mark.parametrize("n", [3, 5, 10, 17], ids=lambda n: f"q{n}")
def test_tpch_rows_equal_with_filtering_on_and_off(n):
    got = _on_off(RN.to_json(prepared_entry(f"q{n}", SF)), SF)
    assert got.stats["dynamic_filter_rows_pruned"] > 0


def test_left_join_probe_is_not_filtered():
    plan = prepare_plan(plan_sql(
        "SELECT c.custkey, o.orderkey FROM customer c "
        "LEFT JOIN orders o ON c.custkey = o.custkey"), sf=SF)
    want, got = _both(plan, SF)
    assert got == want == {}


def _scan(table, cols):
    return PN.TableScanNode("tpch", table, cols,
                            [tpch.column_type(table, c) for c in cols])


def _shared_scan_plan():
    """supplier joined to the nations of region 1, UNION ALL the whole
    supplier scan: one scan node under two parents."""
    supplier = _scan("supplier", ["suppkey", "nationkey"])
    nation = _scan("nation", ["nationkey", "regionkey"])
    region1 = PN.FilterNode(nation, PE.call(
        "eq", PT.BOOLEAN, PE.input_ref(1, PT.BIGINT),
        PE.const(1, PT.BIGINT)))
    join = PN.JoinNode(supplier, region1, [1], [0], "inner",
                       right_output_channels=[], out_capacity=1 << 10)
    return PN.OutputNode(PN.UnionNode([join, supplier]), ["s", "n"])


def test_scan_read_by_two_branches_is_not_filtered():
    root = _shared_scan_plan()
    assert collect_dynamic_filters(annotate_widths(root, SF), SF, "cpu") == {}
    # the same DAG through JSON: the repeated scan id reads as one node
    again = from_json(PN.to_json(root))
    assert collect_dynamic_filters(again, SF, "cpu") == {}
    res = run_query(again, sf=SF, device="cpu")
    assert "dynamic_filters" not in res.stats
    n = tpch.table_row_count("supplier", SF)
    nk = tpch.generate_columns("supplier", SF, ["nationkey"])["nationkey"]
    region1 = {k for k, r in zip(*tpch.generate_columns(
        "nation", SF, ["nationkey", "regionkey"]).values()) if r == 1}
    assert res.row_count == n + sum(int(k) in region1 for k in nk)
    # the same join without the second reader is filtered
    alone = PN.OutputNode(root.source.inputs[0], ["s", "n"])
    assert collect_dynamic_filters(annotate_widths(alone, SF), SF, "cpu")


def test_self_join_over_one_scan_is_not_filtered():
    """supplier joined to itself on suppkey = nationkey, both sides one
    scan node: pruning that scan by the build's nationkeys would also
    cut the build. The port counts the join's two edges and finds no
    filter; its rows equal the reference's with filtering off (the
    reference, which counts parents, prunes here and returns 24 of the
    96 rows at sf 0.01; ROADMAP queue 3)."""
    scan = _scan("supplier", ["suppkey", "nationkey"])
    root = PN.OutputNode(PN.JoinNode(scan, scan, [0], [1], "inner",
                                     out_capacity=4096),
                         ["a", "b", "c", "d"])
    assert collect_dynamic_filters(annotate_widths(root, SF), SF, "cpu") == {}
    got = _on_off(PN.to_json(root), SF)
    want = ref_run_query(RN.from_json(PN.to_json(root)), sf=SF,
                         prepared=True, session={"dynamic_filtering": False})
    assert _exact(got) == _exact(want)
    cols = tpch.generate_columns("supplier", SF, ["suppkey", "nationkey"])
    assert got.row_count == int(np.sum(cols["suppkey"][:, None]
                                       == cols["nationkey"][None, :]))
