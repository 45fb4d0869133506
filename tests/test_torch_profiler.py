"""The continuous profiler of the port (presto_tpu_torch/exec/
profiler.py) and its plan fingerprint (exec/plan_cache.py) held against
the reference's.

The reference's own cases (tests/test_kernel_profiler.py) run over the
port's modules, less the kernel-audit footprint case (the audit is
ROADMAP queue 1 item 16) and the case that clears the reference's
compiled-plan cache, which runs here in the port's terms. Then:
`plan_fingerprint` gives the reference's hash on every plan of the
TPC-H corpus (read from the same JSON by each package), and the two
packages' /v1/profile slices fold by either merge to the same table.
"""

import presto_tpu  # noqa: F401  (jax x64 before any array is made)
import pytest

from _torch_ledger_common import (all_test_names, fresh_ledgers,  # noqa: F401
                                  port_sql, reference_cases)
from presto_tpu_torch.queries import load_corpus

_LEFT_OUT = {"test_footprint_estimate_rides_profile_rows",
             "test_profiler_records_and_matches_query_stats"}

globals().update(reference_cases(
    "test_kernel_profiler.py",
    [n for n in all_test_names("test_kernel_profiler.py")
     if n not in _LEFT_OUT]))

_CORPUS = load_corpus()


@pytest.mark.parametrize("name", sorted(_CORPUS))
def test_plan_fingerprint_equals_the_reference(name):
    from presto_tpu.exec.plan_cache import plan_fingerprint as ref_fp
    from presto_tpu.plan import nodes as RN

    from presto_tpu_torch.exec.plan_cache import plan_fingerprint
    from presto_tpu_torch.plan import nodes as PN
    plan = _CORPUS[name]["plan"]
    assert plan_fingerprint(PN.from_json(plan)) == ref_fp(RN.from_json(plan))


def test_profiler_records_and_matches_query_stats_in_the_port(
        fresh_ledgers):
    """q1's row in the profiler: its device time is the execute stage's
    dispatch (on the CPU the dispatch's host wall) less the compile,
    within the stage; a repeat adds a call and, with no kernel built on
    the CPU, no retrace."""
    from presto_tpu.queries.tpch_sql import tpch_query

    from presto_tpu_torch.exec.plan_cache import plan_fingerprint
    from presto_tpu_torch.exec.profiler import profile_snapshot
    q1 = tpch_query(1)
    res = port_sql(q1.text, max_groups=q1.max_groups)
    top = profile_snapshot()[0]
    qs = res.query_stats
    exec_us = qs.stages["execute"].wall_us
    assert 0 < top["device_us"] <= exec_us
    assert top["calls"] == 1 and top["retraces"] == 0
    assert top["rows_out"] == res.row_count
    assert top["rows_in"] == qs.stages["staging"].rows > 0
    assert top["bytes_in"] == qs.stages["staging"].bytes
    assert "TableScan[tpch.lineitem]" in top["label"]
    assert "tpch.lineitem" in top["tables"]
    port_sql(q1.text, max_groups=q1.max_groups)
    again = [p for p in profile_snapshot()
             if p["fingerprint"] == top["fingerprint"]][0]
    assert again["calls"] == 2 and again["retraces"] == 0
    from presto_tpu_torch.exec.runner import prepare_plan
    from presto_tpu_torch.sql import plan_sql
    assert top["fingerprint"] == plan_fingerprint(prepare_plan(
        plan_sql(q1.text, max_groups=q1.max_groups), 0.01))


@pytest.mark.parametrize("merger", ["reference", "port"])
def test_profile_slices_fold_either_way(merger):
    import presto_tpu.exec.profiler as R
    import presto_tpu_torch.exec.profiler as P
    R.clear_profiler()
    P.clear_profiler()
    R.record_call("fp1", label="a", device_us=100, rows_out=3)
    P.record_call("fp1", label="a", device_us=40, rows_out=3)
    P.record_call("fp2", label="b", device_us=500)
    docs = [R.profile_doc(), P.profile_doc()]
    rows = (R if merger == "reference" else P).merge_kernel_rows(docs)
    assert [r["fingerprint"] for r in rows] == ["fp2", "fp1"]
    fp1 = rows[1]
    assert (fp1["calls"], fp1["device_us"], fp1["rows_out"]) == (2, 140, 6)
    other = (P if merger == "reference" else R).merge_kernel_rows
    assert other(list(reversed(docs))) == rows
    R.clear_profiler()
    P.clear_profiler()
