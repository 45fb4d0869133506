"""The query history, its perf sentinel and the flight recorder of the
port (presto_tpu_torch/server/history.py, exec/perfgate.py,
server/flight_recorder.py) held against the reference's.

The reference's own cases (tests/test_query_history.py and
tests/test_flight_recorder.py) run over the port's modules. The
sentinel's cases feed perfgate fixed durations, as the reference's do,
so no wall clock decides them. Then: the two packages' /v1/history
slices merge into one newest-first list by either merge, and the port
writes a flight dump only under a directory its caller names.
"""

import presto_tpu  # noqa: F401  (jax x64 before any array is made)
import pytest

from _torch_ledger_common import all_test_names, reference_cases

globals().update(reference_cases("test_query_history.py",
                                 all_test_names("test_query_history.py")))
globals().update(reference_cases("test_flight_recorder.py",
                                 all_test_names("test_flight_recorder.py")))


def _record(qid, ts):
    return {"queryId": qid, "state": "FINISHED", "tsUs": ts,
            "fingerprint": "f", "stats": {"wall_us": 1}}


@pytest.mark.parametrize("merger", ["reference", "port"])
def test_history_slices_of_both_packages_merge_either_way(merger):
    import presto_tpu.server.history as R
    import presto_tpu_torch.server.history as P
    ref = R.QueryHistoryArchive(history_dir="", sentinel=False)
    port = P.QueryHistoryArchive(history_dir="", sentinel=False)
    ref.add(_record("q1", 10))
    ref.add(_record("q2", 30))
    port.add(_record("q2", 30))   # seen by both: counted once
    port.add(_record("q3", 20))
    docs = [ref.history_doc(), port.history_doc()]
    got = (R if merger == "reference" else P).merge_history_docs(docs)
    assert [r["queryId"] for r in got] == ["q2", "q3", "q1"]
    other = (P if merger == "reference" else R).merge_history_docs
    assert other(list(reversed(docs))) == got


def test_a_dump_needs_a_directory(tmp_path, monkeypatch):
    from presto_tpu_torch.server.flight_recorder import (
        FlightRecorder, flight_recorder_totals)
    monkeypatch.delenv("PRESTO_TPU_FLIGHT_DIR", raising=False)
    before = flight_recorder_totals()["dumps"].get("failed", 0)
    rec = FlightRecorder()
    rec.record("query_state", query_id="qa", to="FAILED")
    assert rec.dump_dir is None
    assert rec.maybe_dump("qa", "failed") is None
    assert rec.maybe_dump("qa", "failed") is None  # once per key
    assert flight_recorder_totals()["dumps"]["failed"] == before + 1
    rec = FlightRecorder(dump_dir=str(tmp_path))
    rec.record("query_state", query_id="qb", to="FAILED")
    path = rec.maybe_dump("qb", "failed")
    assert path is not None and path.startswith(str(tmp_path))
