"""The datapath ledger of the port (presto_tpu_torch/exec/datapath.py)
held against the reference's.

The reference's own cases (tests/test_datapath.py) run over the port's
modules. Then: the two packages' /v1/datapath slices merge into
one view by either package's merge, with the same result; q1 at sf 0.01
on the CPU attributes its staged bytes to the device_put hop and one
kernel hop to its one dispatch; a CPU device hop records at once
while a CUDA one waits for the run's fetch; and a ceilings probe that
fails leaves its ceiling out, counted, so no utilization rests on it.
"""

import presto_tpu  # noqa: F401  (jax x64 before any array is made)
import pytest

from _torch_ledger_common import (all_test_names, fresh_ledgers,  # noqa: F401
                                 port_sql, reference_cases)

globals().update(reference_cases("test_datapath.py",
                                 all_test_names("test_datapath.py")))

Q1 = ("SELECT returnflag, linestatus, sum(quantity) AS sum_qty, "
      "sum(extendedprice * (1 - discount)) AS sum_disc_price, "
      "count(*) AS count_order FROM lineitem "
      "WHERE shipdate <= date '1998-09-02' "
      "GROUP BY returnflag, linestatus ORDER BY returnflag, linestatus")


def _ref_and_port_docs():
    import presto_tpu.exec.datapath as R
    import presto_tpu_torch.exec.datapath as P
    R.clear_datapath()
    P.clear_datapath()
    R.record_hop("device_put", 4096, 0.002)
    R.record_hop("kernel", 4096, 0.001)
    P.record_hop("device_put", 1024, 0.001)
    P.record_hop("exchange_fetch", 777, 0.003)
    return R, P, R.datapath_doc(), P.datapath_doc()


@pytest.mark.parametrize("merger", ["reference", "port"])
def test_slices_of_both_packages_merge_either_way(merger):
    R, P, ref_doc, port_doc = _ref_and_port_docs()
    merge = (R if merger == "reference" else P).merge_datapath_docs
    got = merge([ref_doc, port_doc])
    assert got["hops"]["device_put"]["bytes"] == 4096 + 1024
    assert got["hops"]["device_put"]["invocations"] == 2
    assert got["hops"]["exchange_fetch"]["bytes"] == 777
    assert got["hops"]["kernel"]["bytes"] == 4096
    # the same function of the same slices, whichever package merges
    other = (P if merger == "reference" else R).merge_datapath_docs
    assert other([port_doc, ref_doc]) == got
    assert set(got["hops"]) == set(R.HOPS) == set(P.HOPS)


def test_port_slice_has_the_reference_shape():
    R, P, ref_doc, port_doc = _ref_and_port_docs()
    assert set(port_doc) == set(ref_doc)
    assert set(port_doc["ceilings"]) == set(ref_doc["ceilings"])
    for hop in R.HOPS:
        assert set(port_doc["hops"][hop]) == set(ref_doc["hops"][hop])
    assert P.HOP_CEILING == R.HOP_CEILING


def test_q1_staged_bytes_are_the_device_put_hop(fresh_ledgers):
    res = port_sql(Q1)
    qs = res.query_stats
    staging = qs.stages["staging"]
    assert qs.datapath["device_put"].bytes == staging.bytes == \
        res.stats["staged_bytes"]
    # one dispatch (no rerun): one kernel hop over the staged bytes
    assert qs.datapath["kernel"].invocations == 1
    assert qs.datapath["kernel"].bytes == staging.bytes
    assert qs.datapath["connector_read"].bytes > 0
    # the q1 lanes that narrow re-prove themselves on the host
    assert qs.datapath["narrow_cast"].invocations >= 1
    # the hop walls and the timeline's intervals are one clock
    for hop, h in qs.datapath.items():
        busy = qs.timeline.totals[hop]["busyUs"]
        assert busy == h.wall_us, hop


def test_cpu_device_hop_records_at_once_cuda_waits_for_the_fetch():
    import torch

    from presto_tpu_torch.exec.datapath import (DatapathLedger,
                                                device_hop, recording,
                                                resolve_device_hops)
    ledger = DatapathLedger()
    with recording(ledger):
        with device_hop("kernel", 100, torch.device("cpu")) as hop:
            pass
    assert not hop.cuda and ledger.snapshot_hops()["kernel"].bytes == 100
    assert ledger.pending == []
    # nothing pending: resolving reads no event and adds nothing
    assert resolve_device_hops(ledger)["hops"] == 0
    assert device_hop("kernel", 1, torch.device("cuda", 0)).cuda


def test_a_failed_probe_leaves_its_ceiling_out(monkeypatch):
    import presto_tpu_torch.exec.datapath as P
    from presto_tpu_torch.server.metrics import suppressed_error_totals

    def broken():
        raise RuntimeError("no device")

    before = suppressed_error_totals().get(("datapath",
                                            "probe_device_put"), 0)
    monkeypatch.setattr(P, "_probe_device_put", broken)
    try:
        ceilings = P.probe_ceilings(refresh=True)
        assert "device_put" not in ceilings
        assert {"host_memcpy", "page_serde", "loopback_http"} <= \
            set(ceilings)
        assert suppressed_error_totals()[("datapath",
                                          "probe_device_put")] == \
            before + 1
        P.record_hop("device_put", 1 << 20, 0.001)
        row = P.datapath_doc()["hops"]["device_put"]
        assert row["ceilingBPerS"] == 0.0 and row["utilization"] == 0.0
    finally:
        monkeypatch.undo()
        P.clear_datapath()
        assert "device_put" in P.probe_ceilings(refresh=True)
