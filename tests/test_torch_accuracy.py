"""The estimate-vs-actual ledger of the port (presto_tpu_torch/exec/
accuracy.py) held against the reference's.

The reference's own cases (tests/test_accuracy.py) run over the port's
modules, less bench.py's artifact and the corpus sweep, which reads
the reference's TPC-H texts and so runs here through `port_sql`. Then:
the two packages' /v1/accuracy slices merge by either package's merge
to the same view, and the port stamps every prepared TPC-H plan with
the reference's estimates.
"""

import presto_tpu  # noqa: F401  (jax x64 before any array is made)
import pytest

from _torch_ledger_common import (all_test_names, fresh_ledgers,  # noqa: F401
                                  port_sql, reference_cases)

_LEFT_OUT = {"test_bench_accuracy_detail",
             "test_tpch_queries_yield_records_and_verdicts"}

globals().update(reference_cases(
    "test_accuracy.py",
    [n for n in all_test_names("test_accuracy.py") if n not in _LEFT_OUT]))


@pytest.mark.parametrize("qnum", [1, 3, 6, 12, 19])
def test_tpch_queries_yield_records_and_verdicts_in_the_port(qnum):
    """The reference's corpus sweep through the port: at least one
    complete record and a named verdict for each."""
    from presto_tpu.queries.tpch_sql import tpch_query

    from presto_tpu_torch.exec.accuracy import (UNITS, misestimate_verdict,
                                                q_error)
    q = tpch_query(qnum)
    kw = dict(max_groups=q.max_groups)
    if q.join_capacity:
        kw["join_capacity"] = q.join_capacity
    acc = port_sql(q.text, **kw).query_stats.accuracy
    assert acc and any(q_error(r.est, r.actual) is not None
                       for r in acc.values())
    v = misestimate_verdict(acc)
    assert v is not None and v["message"] and v["qError"] >= 1.0
    assert all(k and r.unit in UNITS for k, r in acc.items())


@pytest.mark.parametrize("merger", ["reference", "port"])
def test_slices_of_both_packages_merge_either_way(merger, fresh_ledgers):
    import presto_tpu.exec.accuracy as R
    import presto_tpu_torch.exec.accuracy as P
    R.clear_accuracy()
    R.finalize_query("q.x", {"scan[0]:TableScan[tpch.lineitem]":
                             R.NodeAccuracy("scan[0]:TableScan[tpch.lineitem]",
                                            "TableScan[tpch.lineitem]",
                                            "rows", 600.0, 300.0, 1)})
    P.finalize_query("q.x", {"scan[0]:TableScan[tpch.lineitem]":
                             P.NodeAccuracy("scan[0]:TableScan[tpch.lineitem]",
                                            "TableScan[tpch.lineitem]",
                                            "rows", 600.0, 200.0, 1)})
    docs = [R.accuracy_doc(), P.accuracy_doc()]
    got = (R if merger == "reference" else P).merge_accuracy_docs(docs)
    rec = got["queries"]["q.x"]["nodes"]["scan[0]:TableScan[tpch.lineitem]"]
    # estimates max, row actuals add, tasks add: the workers' stitch
    assert (rec["est"], rec["actual"], rec["tasks"]) == (600.0, 500.0, 2)
    other = (P if merger == "reference" else R).merge_accuracy_docs
    assert other(list(reversed(docs))) == got
    R.clear_accuracy()


@pytest.mark.parametrize("num", range(1, 23))
def test_prepared_tpch_plans_carry_the_reference_estimates(num):
    """stamp_estimates runs after prepare_plan's relabelling, so every
    node of the prepared tree carries the estimate the reference's
    prepared tree carries, node for node in one preorder walk."""
    from presto_tpu.exec.runner import prepare_plan as ref_prepare
    from presto_tpu.queries.tpch_sql import TPCH_QUERIES
    from presto_tpu.sql import plan_sql as ref_plan_sql

    from presto_tpu_torch.exec.runner import prepare_plan
    from presto_tpu_torch.sql import plan_sql
    q = TPCH_QUERIES[num]
    kw = dict(max_groups=q.max_groups)
    if q.join_capacity:
        kw["join_capacity"] = q.join_capacity

    def ests(root):
        out = [(type(root).__name__, getattr(root, "est_rows", "missing"))]
        for s in root.sources:
            out += ests(s)
        return out
    want = ests(ref_prepare(ref_plan_sql(q.text, **kw), sf=0.01))
    got = ests(prepare_plan(plan_sql(q.text, **kw), sf=0.01))
    assert got == want
