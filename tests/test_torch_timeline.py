"""The execution timeline of the port (presto_tpu_torch/exec/timeline.py)
held against the reference's.

The reference's own cases (tests/test_timeline.py) run over the port's
modules, less the one of bench.py's artifact. Then: a slice and a
/v1/timeline document of either package merge into the other's, with
the same occupancy; and q1 on the CPU puts its dispatch on the device
lane and its staging on the host lane.
"""

import presto_tpu  # noqa: F401  (jax x64 before any array is made)
import pytest

from _torch_ledger_common import (all_test_names, fresh_ledgers,  # noqa: F401
                                  port_sql, reference_cases)

# bench.py's timeline smoke: the port has no benchmark yet
_LEFT_OUT = {"test_bench_timeline_smoke_and_perfgate_spec"}

globals().update(reference_cases(
    "test_timeline.py",
    [n for n in all_test_names("test_timeline.py") if n not in _LEFT_OUT]))


def _slices():
    import presto_tpu.exec.timeline as R
    import presto_tpu_torch.exec.timeline as P
    ref = R.TimelineSlice([R.Interval("host", "connector_read", 0, 0, 40,
                                      100),
                           R.Interval("device", "kernel", -1, 50, 90, 100)],
                          0, {"kernel": {"busyUs": 40, "bytes": 100,
                                         "count": 1}})
    port = P.TimelineSlice([P.Interval("host", "device_put", 0, 10, 45,
                                       64)],
                           1, {"device_put": {"busyUs": 35, "bytes": 64,
                                              "count": 1}})
    return R, P, ref, port


@pytest.mark.parametrize("merger", ["reference", "port"])
def test_slice_json_of_one_package_merges_into_the_other(merger):
    R, P, ref, port = _slices()
    now = 1_000_000
    a = R.TimelineSlice.from_json(port.to_json(now), now) \
        if merger == "reference" else P.TimelineSlice.from_json(
            ref.to_json(now), now)
    mine = ref if merger == "reference" else port
    merged = mine.merge(a)
    assert len(merged.intervals) == 3 and merged.dropped == 1
    assert set(merged.totals) == {"kernel", "device_put"}
    # both occupancy engines read the merged rows the same
    rows = [[iv.lane, iv.hop, iv.split_id, iv.t0_us, iv.t1_us, iv.bytes]
            for iv in merged.intervals]
    assert R.occupancy(rows) == P.occupancy(rows)
    assert R.bubble_verdict(rows) == P.bubble_verdict(rows)


def test_documents_merge_the_same_in_both_packages(fresh_ledgers):
    import presto_tpu.exec.timeline as R
    import presto_tpu_torch.exec.timeline as P
    R.clear_timeline()
    _, _, ref, port = _slices()
    R.note_query("q.shared", ref, trace_id="t1")
    P.note_query("q.shared", port, trace_id="t1")
    docs = [R.timeline_doc(), P.timeline_doc()]
    now = 5_000_000
    got_r = R.merge_timeline_docs(docs, now=now)
    got_p = P.merge_timeline_docs(docs, now=now)
    assert got_r == got_p
    entry = got_p["queries"]["q.shared"]
    assert len(entry["slice"]["intervals"]) == 3
    assert entry["traceId"] == "t1"
    R.clear_timeline()


def test_q1_lanes(fresh_ledgers):
    res = port_sql("SELECT returnflag, sum(quantity) FROM lineitem "
                   "GROUP BY returnflag")
    ivs = res.query_stats.timeline.intervals
    lanes = {(iv.lane, iv.hop) for iv in ivs}
    assert ("device", "kernel") in lanes
    assert ("host", "device_put") in lanes
    assert ("host", "connector_read") in lanes
    # staging precedes the dispatch on one clock (serial today)
    put = max(iv.t1_us for iv in ivs if iv.hop == "device_put")
    kern = min(iv.t0_us for iv in ivs if iv.hop == "kernel")
    assert put <= kern
    from presto_tpu_torch.exec.timeline import bubble_verdict
    assert bubble_verdict(ivs)["message"].startswith("device idle")
