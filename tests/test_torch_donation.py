"""Buffer donation of the port (presto_tpu_torch/exec/donation.py): a
dead region-boundary intermediate's last reference handed to the region
that consumes it, held against the reference's donation, on the CPU at
sf 0.01.

The reference's tests/test_donation.py runs TPC-H q1 and q6 with fusion
off, donation on and off; so do these. Its proof cases over a jaxpr
(`prepare_donation` aliasing an input into an output) and its pool-peak
and scrape-script cases have no counterpart: the port's donation
aliases nothing, it frees. What is held here: the eligibility law and
the gates equal the reference's; the rows with donation on equal the
rows with it off and the reference's; a donated intermediate's columns
that the region does not pass through are freed before the region
returns (without donation, none is); the `donation.apply` failpoint
falls back to the undonated dispatch with the same rows and one
counted fallback; the totals reach QueryStats and /v1/metrics.
"""

import weakref

import presto_tpu  # noqa: F401  (jax x64 before any array is made)
import pytest
import torch

SF = 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_donation_state():
    from presto_tpu_torch import failpoints
    from presto_tpu_torch.exec.donation import clear_donation_state
    clear_donation_state()
    yield
    clear_donation_state()
    failpoints.disarm_all()


def _query(n):
    from presto_tpu_torch.audit.cli import corpus_queries
    return corpus_queries()[n]


def _port(n, session, **kw):
    from presto_tpu_torch import sql
    text, max_groups, join_capacity = _query(n)
    return sql(text, sf=SF, device="cpu", max_groups=max_groups,
               join_capacity=join_capacity, session=session, **kw)


def test_overflow_incapable_whitelist_equals_the_reference():
    from presto_tpu.exec.donation import overflow_incapable as ref_oi
    from presto_tpu.sql import plan_sql as ref_plan

    from presto_tpu_torch.exec.donation import overflow_incapable
    from presto_tpu_torch.plan import nodes as N
    from presto_tpu_torch.sql import plan_sql
    for text in ("SELECT extendedprice FROM lineitem WHERE quantity < 5",
                 "SELECT sum(quantity) FROM lineitem",
                 "SELECT * FROM nation ORDER BY name LIMIT 3",
                 "SELECT n.name FROM nation n JOIN region r "
                 "ON n.regionkey = r.regionkey"):
        mine = overflow_incapable(plan_sql(text))
        assert mine == ref_oi(ref_plan(text)), text
    assert overflow_incapable(N.RemoteSourceNode(types=[]))


@pytest.mark.parametrize("qnum", [1, 6])
def test_donated_rows_equal_undonated_and_the_reference(qnum):
    """The acceptance pin: donation ON returns exactly the OFF rows and
    the reference's, and the handed-over bytes are counted on
    QueryStats and the process totals."""
    from presto_tpu.sql import sql as ref_sql

    from presto_tpu_torch.exec.donation import donation_totals
    text, max_groups, join_capacity = _query(qnum)
    off = _port(qnum, {"fusion": False})
    on = _port(qnum, {"fusion": False, "buffer_donation": True})
    ref = ref_sql(text, sf=SF, max_groups=max_groups,
                  join_capacity=join_capacity,
                  session={"fusion": False, "buffer_donation": True})
    assert on.rows() == off.rows()
    assert on.canonical_rows() == ref.canonical_rows()
    counters = on.query_stats.counters
    assert counters["donations"] >= 1 and counters["donated_bytes"] > 0
    assert on.stats["donations"] == counters["donations"]
    t = donation_totals()
    assert t["donations"] == counters["donations"]
    assert t["donated_bytes"] == counters["donated_bytes"]
    assert "donations" not in off.query_stats.counters


def _spy_ladder(monkeypatch):
    """Wrap the runner's ladder: for each dispatch, how many tensors of
    its region-kind inputs (handed over or not) died before it
    returned."""
    from presto_tpu_torch.audit.core import tensors_of
    from presto_tpu_torch.exec import runner
    from presto_tpu_torch.exec.donation import Handoff
    real = runner._dispatch_ladder
    seen = []

    def watch(batches, dead):
        n = 0
        for b in batches:
            src = b._batch if isinstance(b, Handoff) else b
            for t in tensors_of(src):
                weakref.finalize(t, dead.append, 1)
                n += 1
        return n

    def spy(root, batches, *a, **kw):
        from presto_tpu_torch.plan import nodes as N
        if not any(isinstance(s, N.RemoteSourceNode)
                   for s in _leaves(root)):
            return real(root, batches, *a, **kw)
        dead = []
        n = watch([b for b in batches if isinstance(b, Handoff)], dead)
        res = real(root, batches, *a, **kw)
        seen.append((n, len(dead)))
        return res

    monkeypatch.setattr(runner, "_dispatch_ladder", spy)
    return seen


def _leaves(n):
    if not n.sources:
        yield n
    for s in n.sources:
        yield from _leaves(s)


def test_a_donated_intermediate_is_freed_before_its_region_returns(
        monkeypatch):
    """q9 with fusion off: the project over a join's output is handed the
    join's batch, whose gathered columns the project does not keep die
    inside the dispatch; without donation nothing is handed over. (A
    filter's output shares its columns with the scan it masks, which
    stays staged, so handing it over frees nothing: q1's case.)"""
    seen = _spy_ladder(monkeypatch)
    on = _port(9, {"fusion": False, "buffer_donation": True})
    donated = [(n, dead) for n, dead in seen if n]
    assert donated and all(dead > 0 for _n, dead in donated), donated
    seen.clear()
    off = _port(9, {"fusion": False})
    assert not any(n for n, _dead in seen)
    assert on.rows() == off.rows()


def test_donation_apply_failpoint_falls_back_with_the_same_rows():
    from presto_tpu_torch import failpoints
    from presto_tpu_torch.exec.donation import donation_totals
    from presto_tpu_torch.server.flight_recorder import get_flight_recorder
    oracle = _port(6, {"fusion": False})
    failpoints.arm("donation.apply", "error:once")
    try:
        res = _port(6, {"fusion": False, "buffer_donation": True},
                    query_id="port-don-fp-q6")
    finally:
        failpoints.disarm_all()
    assert res.rows() == oracle.rows()
    assert donation_totals()["fallbacks"] == 1
    assert res.query_stats.counters["donation_fallbacks"] == 1
    assert res.stats["donation_fallbacks"] == 1
    assert any(e.get("kind") == "donation_fallback"
               and e.get("queryId") == "port-don-fp-q6"
               for e in get_flight_recorder().events())


def test_donation_off_by_default_and_with_fusion_on():
    from presto_tpu_torch.exec.donation import donation_totals
    _port(6, {"fusion": False})
    _port(6, {"buffer_donation": True})   # one region: nothing to hand
    assert donation_totals()["donations"] == 0


def test_donation_families_render_on_metrics():
    from presto_tpu_torch.server.metrics import (donation_families,
                                                 parse_prometheus,
                                                 render_prometheus)
    _port(6, {"fusion": False, "buffer_donation": True})
    parsed = parse_prometheus(
        render_prometheus(donation_families()).decode())
    assert parsed["presto_tpu_donations_total"][""] >= 1
    assert parsed["presto_tpu_donated_bytes_total"][""] > 0
    assert parsed["presto_tpu_donation_fallbacks_total"][""] == 0


def test_prepare_donation_proves_and_hands_over():
    from presto_tpu_torch import types as T
    from presto_tpu_torch.block import Batch, Column
    from presto_tpu_torch.exec.donation import Handoff, prepare_donation
    from presto_tpu_torch.exec.memory import batch_bytes
    b = Batch((Column(torch.arange(8), torch.zeros(8, dtype=torch.bool),
                      T.BIGINT),), torch.ones(8, dtype=torch.bool))
    from presto_tpu_torch.plan import nodes as N
    leaf = N.RemoteSourceNode(types=[])
    agg = N.AggregationNode(source=leaf, group_channels=[], aggregates=[],
                            step="SINGLE", max_groups=1)
    assert prepare_donation("rfp", leaf, [b], []) is None
    assert prepare_donation("rfp-agg", agg, [b], [0]) is None
    a = prepare_donation("rfp", leaf, [b, b], [1])
    assert a.donate_idx == (1,) and a.donated_bytes == batch_bytes(b)
    handed = a.handoff([b, b])
    assert handed[0] is b and isinstance(handed[1], Handoff)
    assert handed[1].take() is b
    with pytest.raises(RuntimeError, match="read twice"):
        handed[1].take()


def test_kernel_audit_k006_on_a_donated_region():
    """With the audit and donation both on, each donated region is
    audited with its handoff: K006 reports the storages the region
    passed through into its output."""
    res = _port(6, {"fusion": False, "buffer_donation": True,
                    "kernel_audit": True})
    c = res.query_stats.counters
    assert c["kernel_audit_kernels"] == res.stats["fusion_regions"]
    assert c.get("kernel_audit.K006", 0) >= 1
