"""Pipeline regions of the port (presto_tpu_torch/exec/regions.py, the
runner's region executor, EXPLAIN's region tags and tail) held against
the reference's (presto_tpu/exec/regions.py), on the CPU at sf 0.01.

The partition-law cases of tests/test_fusion_regions.py that read no
jaxpr audit run here in the port's terms, under their own names (that
module imports the reference's TPC-H texts under a path the port does
not have, so it cannot run through tests/_torch_ledger_common.py): the
fused default is one region keeping the plan's fingerprint, the
partition covers every operator once, fusion off cuts every operator,
a mesh plan is one region, the streaming and spill executors stay
outside regions, the env gate, the budget refusal, the measured
footprint's refusal, the demotion comparator, a demoted span, the
runner's samples, the `fusion.demote` failpoint, the plan cache under
regions, and the provenance surfaces.

Across the packages, on the 22 prepared TPC-H plans with fusion on and
off: the region count, each region's root fingerprint, operators,
reason and cut node types equal the reference's, and EXPLAIN with
regions is the reference's text. Two plans, q15 and q21, hold subtrees
that the reference's memory keeps as several objects where the port's
plan (plan/nodes.py::from_json) shares one node: there the reference's
partition carves each copy (16 and 34 regions with fusion off, against
the port's 15 and 25), and hashes its fused root by back-reference; for
those two the distinct regions are compared, each by its root's
fingerprint as its JSON reads, its operators as from_json reads them,
its reason and its cut node types, and EXPLAIN's tree lines. Rows with
fusion off equal the port's fused rows on all 22, exactly (doubles as
float.hex, bit for bit, within the reference's own tolerance), which
tests/test_torch_tpch_corpus.py holds equal to the reference's on all
22; q6's also equal the reference's here.
"""

import re

import presto_tpu  # noqa: F401  (jax x64 before any array is made)
import pytest
import torch

SF = 0.01

Q1 = """SELECT returnflag, linestatus, sum(quantity) q, count(*) c
FROM lineitem WHERE shipdate <= date '1998-09-02'
GROUP BY returnflag, linestatus ORDER BY returnflag, linestatus"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: six xdist workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_fusion_memory():
    from presto_tpu_torch import failpoints
    from presto_tpu_torch.exec.regions import fusion_memory
    fusion_memory().clear()
    yield
    fusion_memory().clear()
    failpoints.disarm_all()


def _prepared(text=Q1, **kw):
    from presto_tpu_torch.exec.runner import prepare_plan
    from presto_tpu_torch.sql import plan_sql
    return prepare_plan(plan_sql(text, **kw), sf=SF)


def _run(root, **kw):
    from presto_tpu_torch.exec.runner import run_query
    return run_query(root, sf=SF, device="cpu", prepared=True, **kw)


def _canon(res):
    return res.canonical_rows()


def _ops(root):
    from presto_tpu_torch.plan import nodes as N
    out = []

    def walk(n):
        if not isinstance(n, (N.TableScanNode, N.ValuesNode,
                              N.RemoteSourceNode)):
            out.append(n)
        for s in n.sources:
            walk(s)

    walk(root)
    return out


# -- the partition law ------------------------------------------------------

def test_fused_default_is_one_region_keeping_the_plan_fingerprint():
    from presto_tpu_torch.exec.plan_cache import plan_fingerprint
    from presto_tpu_torch.exec.regions import partition_regions
    root = _prepared()
    rp = partition_regions(root, sf=SF)
    assert rp.fused and len(rp.regions) == 1
    assert rp.regions[0].root is root
    assert plan_fingerprint(rp.regions[0].root) == plan_fingerprint(root)


def test_partition_covers_every_operator_exactly_once():
    from presto_tpu_torch.exec.regions import partition_regions
    root = _prepared()
    ops = _ops(root)
    for session in (None, {"fusion": False}):
        rp = partition_regions(root, sf=SF, session=session)
        assert set(rp.node_region) == {id(n) for n in ops}
        assert sum(r.ops for r in rp.regions) == len(ops)
        for reg in rp.regions:
            for inp in reg.inputs:
                if inp.kind == "region":
                    assert inp.region < reg.index
        assert rp.node_region[id(root)] == rp.regions[-1].index


def test_per_op_mode_materializes_each_operator():
    from presto_tpu_torch.exec.regions import partition_regions
    from presto_tpu_torch.plan import nodes as N
    rp = partition_regions(_prepared(), sf=SF, session={"fusion": False})
    assert not rp.fused and len(rp.regions) > 1
    for reg in rp.regions:
        standalone = [n for n in [reg.root]
                      if not isinstance(n, (N.OutputNode, N.ExchangeNode))]
        assert reg.ops <= 2 or not standalone


def test_mesh_plans_are_always_one_region():
    from presto_tpu_torch.exec.regions import partition_regions
    from presto_tpu_torch.exec.runner import prepare_plan
    from presto_tpu_torch.parallel import make_mesh
    from presto_tpu_torch.sql import plan_sql
    mesh = make_mesh(1, devices=("cpu",))
    root = prepare_plan(plan_sql(Q1), sf=SF, mesh=mesh)
    for session in (None, {"fusion": False}):
        rp = partition_regions(root, sf=SF, session=session, mesh=mesh)
        assert len(rp.regions) == 1 and rp.regions[0].reason == "mesh"


def test_streaming_and_spill_seams_stay_outside_regions():
    streamable = """SELECT returnflag, sum(quantity) q, count(*) c
    FROM lineitem WHERE shipdate <= date '1998-09-02'
    GROUP BY returnflag"""
    root = _prepared(streamable, max_groups=16)
    full = _run(root)
    streamed = _run(root, split_rows=8192, session={"fusion": False})
    assert _canon(full) == _canon(streamed)
    assert "fusion_regions" not in streamed.stats


def test_fusion_env_gate(monkeypatch):
    from presto_tpu_torch.exec.regions import fusion_enabled
    monkeypatch.setenv("PRESTO_TPU_FUSION", "0")
    assert not fusion_enabled(None)
    assert fusion_enabled({"fusion": True})
    monkeypatch.setenv("PRESTO_TPU_FUSION", "1")
    assert fusion_enabled(None)
    assert not fusion_enabled({"fusion": False})


def test_tight_budget_refuses_fusion():
    from presto_tpu_torch.exec.regions import partition_regions
    root = _prepared()
    session = {"kernel_audit_budget_bytes": 1}
    rp = partition_regions(root, sf=SF, session=session)
    assert len(rp.regions) > 1
    assert any("budget" in r.reason for r in rp.regions)
    assert _canon(_run(root, session=session)) == _canon(_run(root))


def test_budget_wide_enough_keeps_fusion():
    from presto_tpu_torch.exec.regions import partition_regions
    rp = partition_regions(_prepared(), sf=SF,
                           session={"kernel_audit_budget_bytes": 1 << 34})
    assert len(rp.regions) == 1


def test_k005_feedback_overrides_static_estimate():
    """A measured footprint over the budget, noted under the span's
    fingerprint, refuses a fusion the static estimate admits (the port
    has no kernel audit to note one yet, ROADMAP item 16)."""
    from presto_tpu_torch.exec.plan_cache import plan_fingerprint
    from presto_tpu_torch.exec.regions import (estimate_node_bytes,
                                               fusion_memory,
                                               partition_regions)
    root = _prepared()
    static = sum(estimate_node_bytes(n, SF) for n in _ops(root))
    budget = max(static * 4, 1 << 24)
    session = {"kernel_audit_budget_bytes": budget}
    assert len(partition_regions(root, sf=SF, session=session).regions) == 1
    fusion_memory().note_footprint(plan_fingerprint(root), budget + 1)
    rp = partition_regions(root, sf=SF, session=session)
    assert len(rp.regions) > 1
    assert any("footprint" in r.reason for r in rp.regions)


# -- the profiler's demotion ------------------------------------------------

def test_demotion_comparator_uses_perfgate_bands():
    from presto_tpu_torch.exec.regions import FusionMemory
    mem = FusionMemory()
    fp = "f" * 12
    for v in (1000, 1020, 980):
        mem.note_unfused(fp, v)
    for v in (1040, 1060, 1010):
        mem.note_fused(fp, v)
    assert mem.maybe_demote(fp) is None and mem.demoted(fp) is None
    for v in (5000, 5200, 4100):
        mem.note_fused(fp, v)
    verdict = mem.maybe_demote(fp)
    assert verdict is not None and verdict["metric"] == "region_device_us"
    assert mem.demoted(fp)
    assert mem.maybe_demote(fp) is None


def test_demoted_span_partitions_materialized_and_still_matches():
    from presto_tpu_torch.exec.plan_cache import plan_fingerprint
    from presto_tpu_torch.exec.regions import fusion_memory, \
        partition_regions
    root = _prepared()
    baseline = _run(root)
    fusion_memory().demote(plan_fingerprint(root), "test")
    rp = partition_regions(root, sf=SF)
    assert len(rp.regions) > 1
    assert any("demoted" in r.reason for r in rp.regions)
    res = _run(root)
    assert "fusion_regions" in res.stats
    assert _canon(res) == _canon(baseline)


def test_runner_feeds_fused_and_unfused_samples():
    from presto_tpu_torch.exec.plan_cache import plan_fingerprint
    from presto_tpu_torch.exec.regions import fusion_memory
    root = _prepared()
    fp = plan_fingerprint(root)
    _run(root)
    assert fp in fusion_memory()._fused
    _run(root, session={"fusion": False})
    assert fp in fusion_memory()._unfused


def test_failpoint_forces_demotion_mid_query():
    from presto_tpu_torch import failpoints
    from presto_tpu_torch.exec.plan_cache import plan_fingerprint
    from presto_tpu_torch.exec.regions import fusion_memory
    root = _prepared()
    baseline = _run(root)
    failpoints.arm("fusion.demote", "error:once")
    try:
        res = _run(root)
    finally:
        failpoints.disarm_all()
    assert _canon(res) == _canon(baseline)
    assert "fusion_forced_demotions" in res.stats
    assert "fusion_regions" in res.stats
    assert fusion_memory().demoted(plan_fingerprint(root))
    assert "fusion_regions" in _run(root).stats  # it sticks
    fusion_memory().clear()
    assert "fusion_regions" not in _run(root).stats


# -- the plan cache ---------------------------------------------------------

def test_region_programs_hit_the_plan_cache_on_repeat():
    from presto_tpu_torch.exec.plan_cache import cache_stats, \
        clear_plan_cache
    clear_plan_cache()
    root = _prepared()
    _run(root, session={"fusion": False})
    s1 = cache_stats()
    assert s1["misses"] >= 2  # a lowering per region
    _run(root, session={"fusion": False})
    s2 = cache_stats()
    assert s2["misses"] == s1["misses"]
    assert s2["hits"] >= s1["hits"] + s1["misses"] - 1


def test_join_free_fingerprints_are_capacity_insensitive():
    from presto_tpu_torch.exec.plan_cache import (cache_stats,
                                                  cached_compile,
                                                  clear_plan_cache)
    from presto_tpu_torch.exec.runner import prepare_plan
    from presto_tpu_torch.sql import plan_sql
    clear_plan_cache()
    root = _prepared()
    cached_compile(root, None, 1 << 16)
    cached_compile(root, None, 1 << 20)
    assert cache_stats() == {"entries": 1, "hits": 1, "misses": 1}
    jroot = prepare_plan(plan_sql(
        "SELECT c.name FROM customer c JOIN orders o "
        "ON c.custkey = o.custkey"), sf=SF)
    clear_plan_cache()
    cached_compile(jroot, None, 1 << 16)
    cached_compile(jroot, None, 1 << 20)
    assert cache_stats()["misses"] == 2


def test_join_free_region_reruns_do_not_fragment_cache():
    from presto_tpu_torch.exec.plan_cache import cache_stats, \
        clear_plan_cache
    clear_plan_cache()
    root = _prepared()
    _run(root, default_join_capacity=1 << 16, session={"fusion": False})
    misses = cache_stats()["misses"]
    _run(root, default_join_capacity=1 << 18, session={"fusion": False})
    assert cache_stats()["misses"] == misses


# -- the provenance surfaces ------------------------------------------------

def test_profiler_rows_carry_region_provenance():
    from presto_tpu_torch.exec.profiler import profile_snapshot
    _run(_prepared(), session={"fusion": False}, query_id="fusion_prov_q")
    rows = [r for r in profile_snapshot() if "[region R" in r["label"]]
    assert rows, "no region-tagged profile rows"
    assert any(">" in r["label"] for r in rows)


def test_explain_renders_region_annotations():
    from presto_tpu_torch.plan import explain, explain_analyze
    from presto_tpu_torch.sql import plan_sql
    txt = explain(plan_sql(Q1), regions=True, sf=SF)
    assert "[region=R0]" in txt and "-- regions (1, fusion on) --" in txt
    txt2 = explain_analyze(plan_sql(Q1), sf=SF, device="cpu",
                           session={"fusion": False})
    assert "-- regions (" in txt2 and "fusion off" in txt2
    assert "region=R1" in txt2
    assert "reason=materialized" in txt2
    assert re.search(r"R0: .* device=\d+us", txt2)


# -- across the packages: the 22 TPC-H plans ------------------------------

def _tpch(n):
    from presto_tpu.queries.tpch_sql import TPCH_QUERIES
    q = TPCH_QUERIES[n]
    kw = dict(max_groups=q.max_groups)
    if q.join_capacity:
        kw["join_capacity"] = q.join_capacity
    return q.text, kw


def _port_summary(rp):
    from presto_tpu_torch.exec.plan_cache import plan_fingerprint
    return [(plan_fingerprint(r.root), r.ops, r.reason,
             [type(rp.regions[i.region].root).__name__
              if i.kind == "region" else "scan" for i in r.inputs])
            for r in rp.regions]


def _ref_summary(rp):
    """The reference's regions, each by its root's fingerprint as its
    JSON reads, its operators as plan/nodes.py::from_json reads the
    root's JSON, its reason and its inputs (a cut named by its
    producer's root type)."""
    from presto_tpu.exec.plan_cache import plan_fingerprint
    from presto_tpu.plan import nodes as RN

    from presto_tpu_torch.plan import nodes as PN

    def fp(root):
        return plan_fingerprint(RN.from_json(RN.to_json(root)))

    def op_ids(root):
        ops = {id(n): n for n in _ops(PN.from_json(RN.to_json(root)))}
        return len(ops)

    return [(fp(r.root), op_ids(r.root), r.reason,
             [type(rp.regions[i.region].root).__name__
              if i.kind == "region" else "scan" for i in r.inputs])
            for r in rp.regions]


@pytest.mark.parametrize("n", range(1, 23), ids=lambda n: f"q{n}")
def test_partitions_and_explain_equal_the_reference(n):
    from presto_tpu.exec.regions import partition_regions as ref_partition
    from presto_tpu.exec.runner import prepare_plan as ref_prepare
    from presto_tpu.plan import explain as ref_explain
    from presto_tpu.sql import plan_sql as ref_plan_sql

    from presto_tpu_torch.exec.regions import partition_regions
    from presto_tpu_torch.plan import explain
    from presto_tpu_torch.sql import plan_sql
    text, kw = _tpch(n)
    ref_root = ref_prepare(ref_plan_sql(text, **kw), sf=SF)
    root = _prepared(text, **kw)
    for session in (None, {"fusion": False}):
        got = _port_summary(partition_regions(root, sf=SF,
                                              session=session))
        want = _ref_summary(ref_partition(ref_root, sf=SF,
                                          session=session))
        if n in (15, 21):  # the copies the reference keeps (module doc)
            def distinct(regions):
                return {(fp, ops, reason, tuple(cuts))
                        for fp, ops, reason, cuts in regions}
            assert distinct(got) == distinct(want)
        else:
            assert got == want
    got = explain(plan_sql(text, **kw), regions=True, sf=SF)
    want = ref_explain(ref_plan_sql(text, **kw), regions=True, sf=SF)
    head, _, tail = got.partition("\n\n-- regions")
    ref_head, _, ref_tail = want.partition("\n\n-- regions")
    assert head.splitlines() == ref_head.splitlines()
    if n in (15, 21):  # the copies the reference keeps (module doc)
        rp = partition_regions(root, sf=SF)
        assert f"fingerprint={_port_summary(rp)[0][0][:12]}" in tail
        assert tail.splitlines()[0] == ref_tail.splitlines()[0]
    else:
        assert tail.splitlines() == ref_tail.splitlines()


def _exact(res):
    from presto_tpu_torch import types as PT
    from presto_tpu_torch.queries import exact_rows
    types = [PT.parse_type(str(t)) for t in res.types]
    return exact_rows(res.columns, res.nulls, types, res.row_count)


@pytest.mark.parametrize("n", range(1, 23), ids=lambda n: f"q{n}")
def test_fusion_off_rows_equal_the_fused_and_the_reference(n):
    from presto_tpu_torch.sql import sql
    text, kw = _tpch(n)
    off = sql(text, sf=SF, device="cpu", session={"fusion": False}, **kw)
    assert "fusion_regions" in off.stats, f"q{n} ran fused"
    on = sql(text, sf=SF, device="cpu", **kw)
    assert _exact(off) == _exact(on)
    if n == 6:
        from presto_tpu.sql import sql as ref_sql
        assert _exact(off) == _exact(ref_sql(text, sf=SF, **kw))
