"""The port's kernel audit (presto_tpu_torch/audit/, lint/core.py,
lint/baseline.py) held against the reference's, on the CPU.

The reference audits a traced jaxpr; the port records the op stream a
lowered closure dispatches when it runs (audit/core.py::KernelTrace).
What the two share is held equal here: the `Finding` fingerprint law
and its JSON, the baseline file and its ratchet (each package reads and
ratchets the other's file), the `--format github` line, the session and
env resolution of `kernel_audit`, `buffer_donation` and the K005
budget, and the three metric families. Each pass K001-K007 finds a
seeded bad closure written below, at this file's line and function,
and a `# kernaudit: disable=` comment on that line silences it. TPC-H
q1, q3, q6 and q9 pass the corpus gate at sf 0.01 against the port's
committed baseline, and a live query's audit lands in its QueryStats,
the flight recorder, the metrics, the memo and FusionMemory.

The reference's tests/test_kernaudit.py cases that trace with jax
(their jaxpr provenance) are not run over the port.
"""

import io
import json
from contextlib import redirect_stdout

import presto_tpu  # noqa: F401  (jax x64 before any array is made)
import pytest
import torch

from presto_tpu_torch.audit import KernelTrace, run_audit
from presto_tpu_torch.audit.cli import main as audit_main

SF = 0.01
HERE = "tests/test_torch_kernaudit.py"
ALL_CODES = ("K001", "K002", "K003", "K004", "K005", "K006", "K007")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: six xdist workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cli(args):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = audit_main(list(args))
    return rc, buf.getvalue()


def _line_of(fn, marker: str) -> int:
    """The line of `fn`'s source that holds `marker`."""
    import inspect
    lines, first = inspect.getsourcelines(fn)
    for k, text in enumerate(lines):
        if marker in text:
            return first + k
    raise AssertionError(marker)


# -- the seeded bad closures, one per pass --------------------------------

_HELD = []


def k001_bad(batches):
    return batches[0].to(torch.int64) + 1  # K001 site


def k001_quiet(batches):
    return batches[0].to(torch.int64) + 1  # kernaudit: disable=K001


def k002_bad(batches):
    return batches[0].sum().item()  # K002 site


def k002_quiet(batches):
    return batches[0].sum().item()  # kernaudit: disable=K002


def k003_bad(batches):
    wide = batches[0].to(torch.int64)  # K003 site
    return wide.to(torch.int32) * 2


def k003_quiet(batches):
    wide = batches[0].to(torch.int64)  # kernaudit: disable=K003
    return wide.to(torch.int32) * 2


def k004_bad(batches):
    return batches[0].to("meta")  # K004 site


def k004_quiet(batches):
    return batches[0].to("meta")  # kernaudit: disable=K004


def k005_bad(batches):
    big = torch.ones(1 << 16, dtype=torch.float64)  # K005 site
    return big.sum() + batches[0].sum()


def k005_quiet(batches):
    big = torch.ones(1 << 16, dtype=torch.float64)  # kernaudit: disable=K005
    return big.sum() + batches[0].sum()


def k006_bad(batches):  # K006 site
    batch = batches[0].take()
    return batch


def k006_held(batches):  # K006 site
    batch = batches[0].take()
    _HELD.append(batch)
    return batch.active.sum()


def k006_quiet(batches):  # kernaudit: disable=K006
    return batches[0].take()


def make_k007(quiet: bool = False):
    table = torch.zeros(1 << 18, dtype=torch.float32)  # 1 MiB

    def k007_bad(batches):  # K007 site
        return batches[0] + table[:16].sum()

    def k007_quiet(batches):  # kernaudit: disable=K007
        return batches[0] + table[:16].sum()
    return k007_quiet if quiet else k007_bad


def _batch(n=16):
    from presto_tpu_torch import types as T
    from presto_tpu_torch.block import Batch, Column
    vals = torch.arange(n, dtype=torch.int32)
    return Batch((Column(vals, torch.zeros(n, dtype=torch.bool), T.INTEGER),
                  Column(vals * 2, torch.zeros(n, dtype=torch.bool),
                         T.INTEGER)),
                 torch.ones(n, dtype=torch.bool))


def _seeded(code: str, quiet: bool):
    """(closure, batches, trace keyword arguments, the function whose
    line the finding names, its marker)."""
    x = [torch.arange(16, dtype=torch.int32)]
    if code == "K005":
        fn = k005_quiet if quiet else k005_bad
        return fn, x, {"footprint_budget_bytes": 1 << 12}, fn, "K005"
    if code == "K006":
        fn = k006_quiet if quiet else k006_bad
        return fn, [_batch()], {"donate": [0]}, fn, "K006"
    if code == "K007":
        fn = make_k007(quiet)
        return fn, x, {}, fn, "K007"
    fn = globals()[f"{code.lower()}_{'quiet' if quiet else 'bad'}"]
    return fn, x, {}, fn, code


@pytest.mark.parametrize("code", ALL_CODES)
def test_each_pass_finds_its_seeded_closure(code):
    fn, batches, kw, site_fn, marker = _seeded(code, quiet=False)
    k = KernelTrace.trace(fn, batches, f"seed/{code}", **kw)
    r = run_audit([k], codes=[code])
    assert r.findings, code
    f = r.findings[0]
    assert f.code == code and f.path == f"seed/{code}"
    assert f.src_path == HERE and HERE in f.message
    assert f.line == _line_of(site_fn, f"{marker} site"), (f.line, code)
    assert f.context.split(".")[-1] == site_fn.__name__
    # the same closure with the comment on that line: silenced
    fn, batches, kw, _, _ = _seeded(code, quiet=True)
    k = KernelTrace.trace(fn, batches, f"seed/{code}", **kw)
    r = run_audit([k], codes=[code])
    assert r.findings == [] and r.suppressed >= 1, code


def test_k006_names_a_storage_held_elsewhere():
    _HELD.clear()
    k = KernelTrace.trace(k006_held, [_batch()], "seed/K006h", donate=[0])
    r = run_audit([k], codes=["K006"])
    _HELD.clear()
    (f,) = r.findings
    assert "held elsewhere" in f.message
    plan = k.notes["donation_plan"]
    assert plan["held"][0]["reason"] == "held elsewhere"


def test_a_consumed_donation_is_clean_and_freed_inside_the_run():
    """A closure that reads its donated input and keeps nothing of it:
    no K006 finding, and the copy's storages died inside the run."""
    def consume(batches):
        batch = batches[0].take()
        return batch.columns[0].values.to(torch.int16)

    k = KernelTrace.trace(consume, [_batch()], "seed/consume", donate=[0])
    assert run_audit([k], codes=["K006"]).findings == []
    assert k.donated and not k.donated_alive


def test_index_outputs_of_torch_contract_are_not_escapes():
    """nonzero and a sort's indices are int64 by torch's contract;
    searchsorted is not exempt (it has out_int32)."""
    def fn(batches):
        x = batches[0]
        a = torch.nonzero(x)
        b = torch.sort(x).indices
        return a, b

    k = KernelTrace.trace(fn, [torch.arange(8, dtype=torch.int32)], "idx")
    assert run_audit([k], codes=["K001"]).findings == []

    def fn2(batches):
        x = batches[0]
        return torch.searchsorted(x, x)  # int64 from int32

    k = KernelTrace.trace(fn2, [torch.arange(8, dtype=torch.int32)], "ss")
    assert len(run_audit([k], codes=["K001"]).findings) == 1

    def fn3(batches):
        x = batches[0]
        return torch.searchsorted(x, x, out_int32=True)

    k = KernelTrace.trace(fn3, [torch.arange(8, dtype=torch.int32)], "s32")
    assert run_audit([k], codes=["K001"]).findings == []


def test_kernel_launches_are_records_and_the_hook_is_routed_by_thread():
    """A wrapper's hook call is a record of the trace of the thread that
    made it; another thread's launch records nothing; disarmed, the
    hook is None."""
    import threading

    from presto_tpu_torch.ops import kernels

    def fn(batches):
        x = batches[0]
        kernels.TRACE_HOOK("fused_limb_sums", (x,), (x * 2,))
        t = threading.Thread(target=lambda: kernels.TRACE_HOOK(
            "contains_bytes", (x,), (x,)))
        t.start()
        t.join()
        return x

    assert kernels.TRACE_HOOK is None
    k = KernelTrace.trace(fn, [torch.arange(8)], "hook")
    assert kernels.TRACE_HOOK is None
    ops = [r.op for r in k.records]
    assert "kernel.fused_limb_sums" in ops
    assert "kernel.contains_bytes" not in ops


# -- the finding model and the ratchet, across packages -----------------


def test_finding_fingerprint_and_json_equal_the_reference():
    from presto_tpu.lint.core import Finding as RefFinding

    from presto_tpu_torch.lint.core import Finding
    for args in [("K001", "tpch/q01", 12, 0, "run.lower_node", "m [at x]"),
                 ("W001", "presto_tpu/ops/a.py", 3, 4, "<module>", "ü")]:
        mine, ref = Finding(*args), RefFinding(*args)
        assert mine.fingerprint == ref.fingerprint
        assert mine.to_json() == ref.to_json()
        assert mine.render() == ref.render()
        moved = Finding(args[0], args[1], args[2] + 40, 9, *args[4:])
        assert moved.fingerprint == mine.fingerprint


def test_each_package_reads_and_ratchets_the_others_baseline(tmp_path):
    from presto_tpu.lint import baseline as ref_bl
    from presto_tpu.lint.core import Finding as RefFinding

    from presto_tpu_torch.lint import baseline as bl
    from presto_tpu_torch.lint.core import Finding
    fields = [("K001", "tpch/q01", 5, 0, "a.b", "one"),
              ("K001", "tpch/q01", 9, 0, "a.b", "one"),
              ("K002", "tpch/q03", 7, 0, "c", "two")]
    mine = [Finding(*f) for f in fields]
    ref = [RefFinding(*f) for f in fields]
    p_ref, p_mine = str(tmp_path / "ref.json"), str(tmp_path / "mine.json")
    ref_bl.save_baseline(ref_bl.build_baseline(ref, default_reason="r"),
                         p_ref)
    bl.save_baseline(bl.build_baseline(mine, default_reason="r"), p_mine)
    with open(p_ref) as a, open(p_mine) as b:
        assert a.read() == b.read()
    # each reads the other's file and applies it alike
    for load, apply_, fs, path in (
            (bl.load_baseline, bl.apply_baseline, mine, p_ref),
            (ref_bl.load_baseline, ref_bl.apply_baseline, ref, p_mine)):
        new, baselined, stale = apply_(fs[:2], load(path))
        assert (new, baselined) == ([], 2)
        assert [s["countExpected"] - s["countFound"] for s in stale] == [1]
    # ratchet: a scoped rewrite of the reference's file by the port
    new, baselined, stale = bl.run_scoped_baseline(
        mine[:2], p_ref, update=True, partial=True,
        in_scope=lambda e: e.get("code") == "K001")
    assert (new, baselined, stale) == ([], 2, [])
    entries = ref_bl.load_baseline(p_ref)
    assert sorted(e["code"] for e in entries.values()) == ["K001", "K002"]


def test_format_github_line_equals_the_reference():
    from presto_tpu.lint.cli import github_annotation as ref_line

    from presto_tpu_torch.lint.core import github_annotation
    for args in [("tests/a.py", 3, "kernaudit K001 [tpch/q01]", "x, y: z"),
                 ("p%q.py", 0, "t:1", "line\nbreak 100%")]:
        assert github_annotation(*args) == ref_line(*args)


def test_suppression_parser_equals_the_reference():
    from presto_tpu.lint.core import ModuleSource

    from presto_tpu_torch.lint.core import parse_suppressions
    text = ("x = 1  # tpulint: disable=H001\n"
            "y = 2  # tpulint: disable=H001, W001\n"
            "z = 3  # tpulint: disable=all\n"
            "w = 4  # kernaudit: disable=K001\n")
    ref = ModuleSource("x.py", text=text)._suppressions
    assert parse_suppressions(text.splitlines()) == ref
    assert parse_suppressions(text.splitlines(), "kernaudit") == \
        {4: {"K001"}}


@pytest.mark.parametrize("session,env", [
    (None, None), (None, "1"), (None, "0"), ({"kernel_audit": True}, None),
    ({"kernel_audit": "false"}, "1"), ({"buffer_donation": "true"}, None),
    ({"buffer_donation": False}, "1"),
    ({"kernel_audit_budget_bytes": "4096"}, None),
    ({"kernel_audit_budget_bytes": "junk"}, None)])
def test_gates_and_budget_resolve_as_the_reference(monkeypatch, session,
                                                   env):
    from presto_tpu.audit import staged as ref_staged
    from presto_tpu.exec import donation as ref_donation

    from presto_tpu_torch.audit import staged
    from presto_tpu_torch.exec import donation
    for name in ("PRESTO_TPU_KERNEL_AUDIT", "PRESTO_TPU_DONATION"):
        if env is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, env)
    assert staged.kernel_audit_enabled(session) == \
        ref_staged.kernel_audit_enabled(session)
    assert donation.donation_enabled(session) == \
        ref_donation.donation_enabled(session)
    assert staged._budget(session) == ref_staged._budget(session)


def test_metric_families_equal_the_reference():
    """Names, types, help and label sets of the kernel-audit, donation
    and lock-witness families."""
    from presto_tpu.server import metrics as ref

    from presto_tpu_torch.server import metrics as mine

    def shape(fams):
        return [(f.name, f.mtype, f.help,
                 sorted(tuple(sorted(lb)) for lb, _v in f.samples))
                for f in fams]
    for name in ("kernel_audit_families", "donation_families",
                 "lock_families"):
        assert shape(getattr(mine, name)()) == shape(getattr(ref, name)())
    text = mine.render_prometheus(mine.kernel_audit_families()).decode()
    fam = mine.parse_prometheus(text)[
        "presto_tpu_kernel_audit_findings_total"]
    for code in ALL_CODES:
        assert f'{{pass="{code}"}}' in fam


# -- the corpus gate ----------------------------------------------------


def test_corpus_gate_is_clean_on_q1_q3_q6_q9(tmp_path):
    """The four queries on all three tiers (local, mesh, and the batch
    tier's one program of two members) pass against the committed
    baseline; every committed entry carries a reason."""
    from presto_tpu_torch.audit.cli import DEFAULT_BASELINE
    from presto_tpu_torch.lint.baseline import load_baseline
    rc, out = _cli(["--device", "cpu", "--queries", "1,3,6,9", "--json"])
    assert rc == 0, out
    doc = json.loads(out)
    assert doc["filesScanned"] == 12 and doc["findings"] == []
    assert set(doc) == {"version", "passes", "filesScanned", "findings",
                        "baselined", "suppressed", "staleBaseline"}
    for e in load_baseline(DEFAULT_BASELINE).values():
        assert e.get("reason") and e["reason"] != "grandfathered", e


def test_cli_contract(tmp_path):
    """Exit 2 on an unknown pass or an empty selection; the ratchet
    writes, goes green and scopes staleness to what ran."""
    assert _cli(["--select", "K999"])[0] == 2
    assert _cli(["--device", "cpu", "--queries", "7-5"])[0] == 2
    rc, out = _cli(["--list-passes"])
    assert rc == 0 and all(c in out for c in ALL_CODES)
    bl = str(tmp_path / "b.json")
    with open(bl, "w") as f:
        json.dump({"version": 1, "entries": {"0123456789abcdef": {
            "code": "K002", "path": "tpch/q22", "context": "x",
            "message": "m", "count": 1, "reason": "r"}}}, f)
    # q6 alone does not judge q22's entry
    rc, out = _cli(["--device", "cpu", "--queries", "6", "--tier", "local",
                    "--baseline", bl, "--json"])
    assert rc == 0 and json.loads(out)["staleBaseline"] == []
    rc, out = _cli(["--device", "cpu", "--queries", "6", "--tier", "local",
                    "--baseline", bl, "--format", "github"])
    assert rc == 0 and out == ""


@pytest.mark.parametrize("tier,labels", [
    ("both", ["tpch/q06", "tpch/q06.mesh"]),
    ("batch", ["tpch/q06.batch"]),
    ("all", ["tpch/q06", "tpch/q06.mesh", "tpch/q06.batch"])])
def test_corpus_tiers_stage_their_closures(tier, labels):
    """`both` is the reference's local and mesh tiers, `batch` the
    template as one program, `all` the three; a tier no one knows is
    refused, not traced as nothing."""
    from presto_tpu_torch.audit.cli import (DEFAULT_FOOTPRINT_BUDGET,
                                            corpus_kernels)
    got = corpus_kernels([6], 0.01, tier, "cpu", DEFAULT_FOOTPRINT_BUDGET)
    assert [k.label for k in got] == labels
    with pytest.raises(ValueError, match="unknown corpus tier"):
        corpus_kernels([6], 0.01, tier + "x", "cpu",
                       DEFAULT_FOOTPRINT_BUDGET)


# -- the live query -----------------------------------------------------

Q1 = """SELECT returnflag, linestatus, sum(quantity) q, count(*) c
FROM lineitem WHERE shipdate <= date '1998-09-02'
GROUP BY returnflag, linestatus ORDER BY returnflag, linestatus"""


def _install_firing_pass():
    from presto_tpu_torch.audit import core as acore

    class _AlwaysFires(acore.AuditPass):
        code = "T901"
        name = "test-always-fires"

        def run(self, kernel):
            return [kernel.code_finding("T901", None, "seeded")]

    acore._REGISTRY["T901"] = _AlwaysFires()
    return lambda: acore._REGISTRY.pop("T901", None)


def test_live_q1_audit_counters_event_metrics_memo_and_rows():
    from presto_tpu.sql import sql as ref_sql

    from presto_tpu_torch import sql
    from presto_tpu_torch.audit.staged import (clear_audit_memo,
                                               kernel_audit_totals)
    from presto_tpu_torch.exec.memory import MemoryPool
    from presto_tpu_torch.server.flight_recorder import get_flight_recorder
    from presto_tpu_torch.server.metrics import (kernel_audit_families,
                                                 parse_prometheus,
                                                 render_prometheus)
    remove = _install_firing_pass()
    clear_audit_memo()
    pool = MemoryPool(1 << 34)
    try:
        before = kernel_audit_totals()
        res = sql(Q1, sf=SF, device="cpu", max_groups=16,
                  session={"kernel_audit": True}, memory_pool=pool,
                  query_id="port_audit_q1")
        qs = res.query_stats
        assert qs.counters["kernel_audit_kernels"] == 1
        assert qs.counters["kernel_audit.T901"] == 1
        assert "kernel_audit.K001" not in qs.counters
        est = qs.counters["kernel_audit_peak_bytes_estimate"]
        assert est > 0 and qs.peak_memory_bytes >= est
        assert res.stats["kernel_audit_s"] > 0
        assert qs.accuracy["footprint"].est == float(est)
        mid = kernel_audit_totals()
        assert mid["kernels"] == before["kernels"] + 1
        evs = [e for e in get_flight_recorder().events(kind="kernel_audit")
               if e.get("queryId") == "port_audit_q1"]
        assert len(evs) == 1 and evs[0]["memo_hit"] is False
        parsed = parse_prometheus(
            render_prometheus(kernel_audit_families()).decode())
        assert parsed["presto_tpu_kernel_audit_kernels_total"][""] >= 1
        assert parsed["presto_tpu_kernel_audit_findings_total"][
            '{pass="T901"}'] >= 1
        again = sql(Q1, sf=SF, device="cpu", max_groups=16,
                    session={"kernel_audit": True}, query_id="port_audit_q1b")
        assert kernel_audit_totals()["kernels"] == mid["kernels"]  # memo
        assert again.query_stats.counters["kernel_audit_kernels"] == 1
        assert any(e.get("memo_hit") for e in get_flight_recorder().events(
            kind="kernel_audit") if e.get("queryId") == "port_audit_q1b")
        ref = ref_sql(Q1, sf=SF, max_groups=16)
        assert res.canonical_rows() == ref.canonical_rows()
        assert again.rows() == res.rows()
    finally:
        remove()
        clear_audit_memo()


def test_audit_feeds_fusion_memory_and_refuses_an_over_budget_span():
    """A fused span's K005 estimate is FusionMemory's measured
    footprint; over the budget, the next submission runs the span
    materialised (reason `footprint`)."""
    from presto_tpu_torch import sql
    from presto_tpu_torch.audit.staged import clear_audit_memo
    from presto_tpu_torch.exec.plan_cache import plan_fingerprint
    from presto_tpu_torch.exec.regions import (fusion_memory,
                                               partition_regions)
    from presto_tpu_torch.exec.runner import prepare_plan
    from presto_tpu_torch.sql import plan_sql
    clear_audit_memo()
    fusion_memory().clear()
    try:
        root = prepare_plan(plan_sql(Q1, max_groups=16), sf=SF)
        sql(Q1, sf=SF, device="cpu", max_groups=16,
            session={"kernel_audit": True})
        fp = plan_fingerprint(root)
        est = fusion_memory().footprint(fp)
        assert est > 0
        budget = {"kernel_audit_budget_bytes": est - 1}
        rplan = partition_regions(root, session=budget, sf=SF)
        assert len(rplan.regions) > 1
        assert rplan.regions[-1].reason == "footprint"
        res = sql(Q1, sf=SF, device="cpu", max_groups=16,
                  session={"kernel_audit": True, **budget})
        assert res.stats["fusion_regions"] > 1
    finally:
        fusion_memory().clear()
        clear_audit_memo()


def test_audit_run_leaves_the_querys_books_alone():
    """The audited run adds no exchange counters to the query and puts
    HASH_STATS back; audit off, nothing of it appears."""
    from presto_tpu_torch import sql
    from presto_tpu_torch.audit.staged import clear_audit_memo, trace_closure
    from presto_tpu_torch.ops import aggregation
    clear_audit_memo()
    off = sql(Q1, sf=SF, device="cpu", max_groups=16)
    assert not any(k.startswith("kernel_audit")
                   for k in off.query_stats.counters)
    aggregation.HASH_STATS.update(rounds=7, exit_checks=3)

    def fn(batches):
        aggregation.HASH_STATS.update(rounds=1, exit_checks=1)
        return batches[0]
    trace_closure(fn, [torch.ones(4)], "books")
    assert aggregation.HASH_STATS == {"rounds": 7, "exit_checks": 3}


def test_a_closure_error_propagates_and_a_pass_error_is_suppressed():
    from presto_tpu_torch.audit import core as acore
    from presto_tpu_torch.audit.staged import audit_staged_query
    from presto_tpu_torch.exec.planner import CompiledPlan

    def boom(batches):
        raise RuntimeError("kernel refused")
    with pytest.raises(RuntimeError, match="kernel refused"):
        audit_staged_query(CompiledPlan(boom, [], []), [torch.ones(2)],
                           plan_fp="boom")

    class _Broken(acore.AuditPass):
        code = "T902"

        def run(self, kernel):
            raise ValueError("pass bug")
    acore._REGISTRY["T902"] = _Broken()
    try:
        rep = audit_staged_query(CompiledPlan(lambda b: b[0], [], []),
                                 [torch.ones(2)], plan_fp="broken")
        assert rep is None
    finally:
        acore._REGISTRY.pop("T902", None)
