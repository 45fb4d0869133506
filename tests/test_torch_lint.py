"""The port's static lint (presto_tpu_torch/lint/) held against the
reference's (presto_tpu/lint/), on the CPU.

  * The port is clean: ``python -m presto_tpu_torch.lint`` exits 0 over
    the empty ``presto_tpu_torch/lint/baseline.json``; the whole-tree
    run happens once, in a module fixture.
  * Parity: the reference's fixtures for C001-C004, S001, M001-M003 and
    R001 (tests/fixtures/tpulint/*_bad.py, read, never edited) give the
    same findings through both packages' passes -- code, line, context,
    message and fingerprint.
  * H001 and W001 speak torch here, so they get torch fixtures, written
    below into ``tmp_path``: a seeded bad section, a known-good section
    and one suppressed site each.
  * Cross-check: the reference's own passes over the port's files (its
    targets with ``presto_tpu/`` read as ``presto_tpu_torch/``) find
    nothing the port left unfixed or unsuppressed.
  * H001 within K002: every host round trip the kernel audit records in
    the CPU corpus gate's closures (q1, q3, q6, q9, both tiers) and in
    the hash-slot group-by's is an H001 site.
  * The framework mechanics of tests/test_tpulint.py: suppressions, the
    baseline ratchet, the CLI's exit codes, ``--json`` and ``--format
    github``.
"""

import hashlib
import io
import json
import os
import re
import subprocess
import sys
from contextlib import redirect_stdout

import presto_tpu  # noqa: F401  (jax x64 before any array is made)
import pytest
import torch

from presto_tpu_torch.lint import (apply_baseline, build_baseline,
                                   get_pass, run_passes)
from presto_tpu_torch.lint.baseline import (DEFAULT_BASELINE, load_baseline,
                                            save_baseline)
from presto_tpu_torch.lint.cli import main as lint_main
from presto_tpu_torch.lint.core import ModuleSource

pytestmark = pytest.mark.lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join("tests", "fixtures", "tpulint")
ALL_CODES = ("C001", "C002", "C003", "C004", "H001", "M001", "M002",
             "M003", "R001", "S001", "W001")
# the codes whose rules the port keeps word for word
SHARED_CODES = ("C001", "C002", "C003", "C004", "M001", "M002", "M003",
                "R001", "S001")

H001_SRC = '''\
import numpy as np
import torch


def kernel(x: torch.Tensor, mask: torch.Tensor):
    total = float(x.sum())          # BAD: float() of a tensor
    host = x.cpu()                  # BAD: a copy to host memory
    last = x.sum().item()           # BAD: .item()
    rows = x.tolist()               # BAD: .tolist() of a tensor
    if mask.any():                  # BAD: a tensor as an `if` test
        total += 1
    idx = torch.nonzero(mask)       # BAD: sizes its output by the data
    kept = x.masked_select(mask)    # BAD: sizes its output by the data
    arr = np.asarray(x)             # BAD: np.asarray of a tensor
    torch.cuda.synchronize()        # BAD: the host waits on the device
    return total, host, last, rows, idx, kept, arr


def known_good(x: torch.Tensor, rows):
    n = int(np.ceil(np.log2(max(len(rows), 2))))  # host math on numpy
    a = np.arange(4)
    k = int(a.sum())                # int() of numpy: host data
    lst = a.tolist()                # numpy's tolist: host data
    y = torch.where(x > 0, x, 0)    # three-argument where: no sync
    return n, k, lst, y, x.shape[0] + 1


def suppressed_site(x):
    return x.sum().item()  # tpulint: disable=H001
'''

W001_SRC = '''\
import torch


def make_ids(n, x):
    ids = torch.arange(n)                 # BAD: implicit dtype (int64)
    pad = torch.zeros(n)                  # BAD: implicit dtype
    lit = torch.tensor([1, 2, 3])         # BAD: implicit dtype (int64)
    wide = x.to(torch.int64)              # BAD: an int64 cast
    table = torch.full((n,), 0, dtype=torch.long)  # BAD: dtype=int64
    dbl = x.double()                      # BAD: float64 lanes
    return ids, pad, lit, wide, table, dbl


def known_good(n, x):
    a = torch.arange(n, dtype=torch.int32)
    b = torch.zeros(n, dtype=torch.float32)
    order = torch.argsort(x).to(torch.int64)  # int64 by torch's contract
    return a, b, order, torch.zeros_like(x)


def suppressed_site(n):
    return torch.arange(n)  # tpulint: disable=W001
'''

TORCH_FIXTURES = {"H001": H001_SRC, "W001": W001_SRC}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def whole_tree():
    """`python -m presto_tpu_torch.lint --json` as a user runs it, once,
    in a fresh interpreter: (exit code, its JSON document, the modules
    of jax or presto_tpu it imported)."""
    code = ("import json, runpy, sys\n"
            "sys.argv = ['presto_tpu_torch.lint', '--json']\n"
            "try:\n"
            "    runpy.run_module('presto_tpu_torch.lint',\n"
            "                     run_name='__main__', alter_sys=True)\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'presto_tpu')]\n"
            "print(json.dumps({'rc': rc, 'imported': bad}))\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr
    doc, _, tail = run.stdout.rpartition("\n{")
    tail = json.loads("{" + tail)
    return tail["rc"], json.loads(doc), tail["imported"]


def _cli(args):
    """(exit code, stdout) of one in-process CLI run."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = lint_main(list(args))
    return rc, buf.getvalue()


def _fixture(code, tmp_path) -> str:
    """The path of `code`'s fixture: the reference's file, or the torch
    source above written into tmp_path."""
    if code in TORCH_FIXTURES:
        p = tmp_path / f"{code.lower()}_bad.py"
        p.write_text(TORCH_FIXTURES[code])
        return str(p)
    return os.path.join(REPO, FIXTURES, f"{code.lower()}_bad.py")


def _line_of(rel: str, text: str) -> int:
    with open(os.path.join(REPO, rel), encoding="utf-8") as f:
        lines = [i for i, ln in enumerate(f, start=1) if text in ln]
    assert len(lines) == 1, (rel, text, lines)
    return lines[0]


# -- the port's gate -----------------------------------------------------


def test_port_is_clean_with_an_empty_baseline(whole_tree):
    """`python -m presto_tpu_torch.lint` exits 0: no finding is left
    (each was fixed or suppressed at its line with a reason), the
    committed baseline has no entry, and the run imported neither jax
    nor presto_tpu."""
    rc, doc, imported = whole_tree
    assert doc["findings"] == [], doc["findings"]
    assert rc == 0 and imported == []
    assert doc["passes"] == list(ALL_CODES)
    assert doc["filesScanned"] > 60
    assert doc["baselined"] == 0 and doc["staleBaseline"] == []
    assert doc["suppressed"] >= 40
    assert load_baseline(DEFAULT_BASELINE) == {}


def test_list_passes_names_the_eleven_codes():
    rc, out = _cli(["--list-passes"])
    assert rc == 0
    assert [ln.split()[0] for ln in out.splitlines()] == list(ALL_CODES)


# -- parity with the reference on its fixtures ---------------------------


def _shape(findings):
    return [(f.code, f.path, f.line, f.col, f.context, f.message,
             f.fingerprint) for f in findings]


@pytest.mark.parametrize("code", SHARED_CODES)
def test_fixture_findings_equal_the_reference(code):
    """The reference's fixture through both packages' passes: equal in
    code, line, context, message and fingerprint, and equally many
    suppressed."""
    from presto_tpu.lint import run_passes as ref_run_passes
    fixture = os.path.join(REPO, FIXTURES, f"{code.lower()}_bad.py")
    mine = run_passes(codes=[code], paths=[fixture])
    ref = ref_run_passes(codes=[code], paths=[fixture])
    assert len(ref.findings) >= 3
    assert _shape(mine.findings) == _shape(ref.findings)
    assert mine.suppressed == ref.suppressed == 1


# -- every pass fires on its fixture; known-good stays clean -------------


@pytest.mark.parametrize("code", ALL_CODES)
def test_pass_detects_seeded_fixture(code, tmp_path):
    """Each pass fires on its fixture and the CLI exits 1; exactly one
    site is suppressed inline."""
    rc, out = _cli(["--select", code, "--no-baseline", "--json",
                    _fixture(code, tmp_path)])
    assert rc == 1
    doc = json.loads(out)
    assert {f["code"] for f in doc["findings"]} == {code}
    assert len(doc["findings"]) >= 3
    assert doc["suppressed"] == 1


@pytest.mark.parametrize("code", ALL_CODES)
def test_fixture_known_good_sections_stay_clean(code, tmp_path):
    result = run_passes(codes=[code], paths=[_fixture(code, tmp_path)])
    for f in result.findings:
        assert "good" not in f.context and "ok" not in f.context, \
            f"{code} false positive in {f.context}: {f.message}"


def test_h001_torch_fixture_finds_each_seeded_read(tmp_path):
    findings = run_passes(codes=["H001"],
                          paths=[_fixture("H001", tmp_path)]).findings
    assert {f.context for f in findings} == {"kernel"}
    bad = [i for i, ln in enumerate(H001_SRC.splitlines(), start=1)
           if "# BAD" in ln]
    assert sorted({f.line for f in findings}) == bad


def test_w001_torch_fixture_finds_each_seeded_lane(tmp_path):
    findings = run_passes(codes=["W001"],
                          paths=[_fixture("W001", tmp_path)]).findings
    bad = [i for i, ln in enumerate(W001_SRC.splitlines(), start=1)
           if "# BAD" in ln]
    assert sorted({f.line for f in findings}) == bad
    msgs = [f.message for f in findings]
    assert sum("without an explicit dtype" in m for m in msgs) == 3
    assert any(m.startswith(".double() makes float64") for m in msgs)


# -- the cross-check: the reference's passes over the port ---------------

# sites the reference's passes flag over the port although the port's
# lint does not: C003's ALLOWED (keyed by presto_tpu/ paths in the
# reference, by the port's in the port), and two env reads the port's
# R001 resolves through a module constant to a keyed knob (the
# reference's pass reads only literal names)
_CROSS_EXPECTED = {
    ("C003", "presto_tpu_torch/server/history.py",
     "QueryHistoryArchive._persist"),
    ("C003", "presto_tpu_torch/server/history.py",
     "QueryHistoryArchive.load"),
    ("R001", "presto_tpu_torch/exec/batching.py", "batching_enabled"),
    ("R001", "presto_tpu_torch/exec/regions.py", "fusion_enabled"),
}


@pytest.mark.parametrize("code", SHARED_CODES)
def test_reference_passes_over_the_port_find_nothing_left(code):
    """The reference's own pass, unmodified, over the port's files at
    its mapped targets."""
    from presto_tpu.lint import get_pass as ref_get_pass
    from presto_tpu.lint import run_passes as ref_run_passes
    from presto_tpu.lint.core import REPO as REF_REPO
    import glob
    files = []
    for pat in ref_get_pass(code).TARGETS:
        pat = pat.replace("presto_tpu/", "presto_tpu_torch/", 1)
        files += sorted(os.path.relpath(p, REF_REPO) for p in
                        glob.glob(os.path.join(REF_REPO, pat))
                        if p.endswith(".py"))
    assert files
    result = ref_run_passes(codes=[code],
                            paths=[os.path.join(REF_REPO, f) for f in files])
    left = {(f.code, f.path, f.context) for f in result.findings}
    assert left <= _CROSS_EXPECTED, sorted(left - _CROSS_EXPECTED)
    if code == "C003":
        from presto_tpu_torch.lint.passes.blocking import ALLOWED
        assert left == {(code, p, c) for p, c, _ in ALLOWED}
        assert len(result.findings) == 3  # `load` opens the ring twice


# -- H001 against the kernel audit's K002 --------------------------------


def _k002_lines(kernels):
    from presto_tpu_torch.audit.passes.host_callback import \
        is_host_round_trip
    return {(r.src, r.line) for k in kernels for r in k.records
            if is_host_round_trip(r)}


def test_h001_holds_every_k002_site_of_the_cpu_traces():
    """The corpus gate's closures (q1, q3, q6, q9, both tiers, sf 0.01)
    and the hash-slot group-by's (agg_hash, whose exit-flag read K002
    whitelists): each K002 site is an H001 site, reported, suppressed
    or whitelisted; the exit-flag read is whitelisted for the reason
    K002 gives."""
    from presto_tpu_torch.audit.cli import (DEFAULT_FOOTPRINT_BUDGET,
                                            corpus_kernels)
    from presto_tpu_torch.audit.passes.host_callback import SYNC_OK_SITES
    from presto_tpu_torch.audit.staged import trace_closure
    from presto_tpu_torch.exec.runner import (_fitted_capacities, _lower,
                                              prepare_plan, stage_scans)
    from presto_tpu_torch.lint.passes.host_sync import sites
    from presto_tpu_torch.queries import load_corpus
    from presto_tpu_torch.sql import plan_sql
    traced = corpus_kernels([1, 3, 6, 9], 0.01, "both", "cpu",
                            DEFAULT_FOOTPRINT_BUDGET)
    assert len(traced) == 8
    k002 = _k002_lines(traced)
    agg = load_corpus()["agg_hash"]
    root = prepare_plan(plan_sql(agg["sql"], max_groups=agg["max_groups"]),
                        sf=0.01)
    batches = stage_scans(root, 0.01, torch.device("cpu"))
    _, ids, factors = _fitted_capacities(root)
    plan, _ = _lower(root, ids, factors, None, "narrow", 1 << 16, 1, True)
    hashed = _k002_lines([trace_closure(plan.fn, batches, "agg_hash")])
    rel = "presto_tpu_torch/ops/aggregation.py"
    exit_flag = (rel, _line_of(rel, "if not bool(unres.any()):"))
    assert hashed == {exit_flag}
    h001 = sites()
    assert k002 | hashed <= set(h001), sorted((k002 | hashed) - set(h001))
    (site,) = h001[exit_flag]
    assert site["standing"] == "whitelisted"
    assert site["context"] == "_group_ids_hash"
    assert site["reason"] == SYNC_OK_SITES[rel]["_group_ids_hash"]


def test_h001_whitelist_is_k002s():
    from presto_tpu_torch.audit.passes.host_callback import SYNC_OK_SITES
    from presto_tpu_torch.lint.passes.host_sync import sync_ok_sites
    assert sync_ok_sites() is SYNC_OK_SITES


def test_h001_scope_is_the_lowered_closure():
    """In exec/planner.py only the closures compile_plan builds are in
    scope, not its own body (it runs once per lowering); in ops/ every
    function is."""
    text = ("import torch\n"
            "def compile_plan(root):\n"
            "    n = root.sum().item()\n"
            "    def run(batches):\n"
            "        return batches[0].sum().item()\n"
            "    return run\n")
    p = get_pass("H001")
    ms = ModuleSource("presto_tpu_torch/exec/planner.py", REPO, text=text)
    assert [(f.context, f.line) for f in p.run(ms)] == [
        ("compile_plan.run", 5)]
    ms = ModuleSource("presto_tpu_torch/ops/sort.py", REPO, text=text)
    assert [f.line for f in p.run(ms)] == [3, 5]


# -- W001 against the kernel audit's K001 --------------------------------


def test_w001_whitelist_is_k001s():
    """An int64 lane inside a function K001 sanctions for its file is
    not a finding; the same lane elsewhere is; WIDE_OK_FILES are
    exempt whole."""
    from presto_tpu_torch.audit.passes.wide_lanes import (WIDE_OK_FILES,
                                                          WIDE_OK_SITES)
    text = ("import torch\n"
            "def lex_permutation(keys):\n"
            "    return keys.to(torch.int64)\n"
            "def elsewhere(keys):\n"
            "    return keys.to(torch.int64)\n")
    assert "lex_permutation" in WIDE_OK_SITES["presto_tpu_torch/ops/sort.py"]
    p = get_pass("W001")
    ms = ModuleSource("presto_tpu_torch/ops/sort.py", REPO, text=text)
    assert [f.context for f in p.run(ms)] == ["elsewhere"]
    (whole,) = WIDE_OK_FILES
    assert p.run(ModuleSource(whole, REPO, text=text)) == []


# -- R001 in torch terms ---------------------------------------------------


def test_r001_keyed_envs_are_the_plan_caches():
    from presto_tpu_torch.exec.plan_cache import KERNEL_MODE_ENVS
    from presto_tpu_torch.lint.passes.retrace import kernel_mode_envs
    assert set(kernel_mode_envs()) == {n for n, _ in KERNEL_MODE_ENVS}


def test_r001_resolves_names_read_through_module_constants():
    text = ("import os\n"
            "KEYED = 'PRESTO_TPU_FUSION'\n"
            "OTHER = 'SOME_UNKEYED_KNOB'\n"
            "def a():\n"
            "    return os.environ.get(KEYED, '1')\n"
            "def b():\n"
            "    return os.environ.get(OTHER, '1')\n"
            "def c(name):\n"
            "    return os.environ.get(name)\n")
    ms = ModuleSource("presto_tpu_torch/exec/knobs.py", REPO, text=text)
    found = get_pass("R001").run(ms)
    assert [(f.context, f.message.split("'")[1]) for f in found] == [
        ("b", "SOME_UNKEYED_KNOB"), ("c", "<dynamic>")]


def test_r001_flags_what_the_lowering_keeps_in_the_closure():
    """A clock, a random draw or a mutable global read while
    compile_plan lowers is kept by the cached closure; the same reads
    inside the closure run on every dispatch and are not findings."""
    text = ("import time\n"
            "import torch\n"
            "_MODES = {'x': 1}\n"
            "def compile_plan(root):\n"
            "    t0 = time.time()\n"
            "    mode = _MODES['x']\n"
            "    noise = torch.rand(1)\n"
            "    def run(batches):\n"
            "        return time.time(), _MODES['x'], torch.rand(1)\n"
            "    return run\n")
    ms = ModuleSource("presto_tpu_torch/exec/planner.py", REPO, text=text)
    found = get_pass("R001").run(ms)
    assert [(f.line, f.context) for f in found] == [
        (5, "compile_plan"), (6, "compile_plan"), (7, "compile_plan")]
    assert all("compile_plan lowers the closure" in f.message
               for f in found)


# -- suppressions ----------------------------------------------------------

_W001_ONE = "import torch\n\ndef f(n):\n    return torch.arange(n)\n"
_W001_FIXED = _W001_ONE.replace("torch.arange(n)",
                                "torch.arange(n, dtype=torch.int32)")


@pytest.mark.parametrize("comment", ["# tpulint: disable=W001",
                                     "# tpulint: disable=H001,W001",
                                     "# tpulint: disable=all"])
def test_inline_suppression_drops_finding(tmp_path, comment):
    p = tmp_path / "mod.py"
    p.write_text(_W001_ONE)
    r1 = run_passes(codes=["W001"], paths=[str(p)])
    assert len(r1.findings) == 1 and r1.suppressed == 0
    p.write_text(_W001_ONE.replace("torch.arange(n)",
                                   f"torch.arange(n)  {comment}"))
    r2 = run_passes(codes=["W001"], paths=[str(p)])
    assert r2.findings == [] and r2.suppressed == 1


# -- the baseline ratchet ----------------------------------------------------


def test_baseline_add_then_expire(tmp_path):
    mod = tmp_path / "mod.py"
    bl = str(tmp_path / "baseline.json")
    mod.write_text(_W001_ONE)
    rc, _ = _cli(["--select", "W001", "--baseline", bl, str(mod)])
    assert rc == 1
    rc, _ = _cli(["--select", "W001", "--baseline", bl,
                  "--update-baseline", str(mod)])
    assert rc == 0
    (entry,) = load_baseline(bl).values()
    assert entry["code"] == "W001" and entry["count"] == 1
    rc, out = _cli(["--select", "W001", "--baseline", bl, "--json",
                    str(mod)])
    assert rc == 0 and json.loads(out)["baselined"] == 1
    mod.write_text(_W001_FIXED)
    rc, out = _cli(["--select", "W001", "--baseline", bl, "--json",
                    str(mod)])
    assert rc == 1
    doc = json.loads(out)
    assert doc["findings"] == [] and len(doc["staleBaseline"]) == 1
    assert doc["staleBaseline"][0]["countFound"] == 0
    rc, _ = _cli(["--select", "W001", "--baseline", bl,
                  "--update-baseline", str(mod)])
    assert rc == 0 and load_baseline(bl) == {}


def test_baseline_excess_copies_are_new_findings(tmp_path):
    mod = tmp_path / "mod.py"
    mod.write_text(_W001_ONE)
    entries = build_baseline(run_passes(codes=["W001"],
                                        paths=[str(mod)]).findings)
    mod.write_text(_W001_ONE.replace(
        "    return torch.arange(n)\n",
        "    a = torch.arange(n)\n    return a + torch.arange(n)\n"))
    findings = run_passes(codes=["W001"], paths=[str(mod)]).findings
    assert len(findings) == 2
    new, baselined, stale = apply_baseline(findings, entries)
    assert baselined == 1 and len(new) == 1 and stale == []


def test_partial_run_preserves_out_of_scope_baseline(tmp_path):
    bl = str(tmp_path / "baseline.json")
    mod_a, mod_b = tmp_path / "a.py", tmp_path / "b.py"
    mod_a.write_text(_W001_ONE)
    mod_b.write_text(_W001_ONE)
    rc, _ = _cli(["--select", "W001", "--baseline", bl,
                  "--update-baseline", str(mod_a), str(mod_b)])
    assert rc == 0 and len(load_baseline(bl)) == 2
    mod_a.write_text(_W001_FIXED)
    rc, out = _cli(["--select", "W001", "--baseline", bl, "--json",
                    str(mod_b)])
    assert rc == 0 and json.loads(out)["staleBaseline"] == []
    rc, _ = _cli(["--select", "W001", "--baseline", bl,
                  "--update-baseline", str(mod_b)])
    assert rc == 0 and len(load_baseline(bl)) == 2
    rc, out = _cli(["--select", "W001", "--baseline", bl, "--json",
                    str(mod_a), str(mod_b)])
    assert rc == 1 and len(json.loads(out)["staleBaseline"]) == 1


def test_baseline_reasons_survive_update(tmp_path):
    mod = tmp_path / "mod.py"
    bl = str(tmp_path / "baseline.json")
    mod.write_text(_W001_ONE)
    entries = build_baseline(run_passes(codes=["W001"],
                                        paths=[str(mod)]).findings)
    (fp,) = entries
    entries[fp]["reason"] = "tracked elsewhere"
    save_baseline(entries, bl)
    rc, _ = _cli(["--select", "W001", "--baseline", bl,
                  "--update-baseline", str(mod)])
    assert rc == 0
    assert load_baseline(bl)[fp]["reason"] == "tracked elsewhere"


def test_select_only_run_preserves_out_of_target_baseline(tmp_path):
    bl = str(tmp_path / "baseline.json")
    ghost = {"code": "W001", "path": "not/in/any/target.py",
             "context": "f", "message": "torch.arange() without an "
             "explicit dtype", "count": 1, "reason": "out-of-target debt"}
    fp = hashlib.sha1(
        f"{ghost['code']}|{ghost['path']}|{ghost['context']}|"
        f"{ghost['message']}".encode()).hexdigest()[:16]
    save_baseline({fp: ghost}, bl)
    rc, out = _cli(["--select", "W001", "--baseline", bl, "--json"])
    assert rc == 0, out
    assert json.loads(out)["staleBaseline"] == []
    rc, _ = _cli(["--select", "W001", "--baseline", bl,
                  "--update-baseline"])
    assert rc == 0 and fp in load_baseline(bl)


def test_each_package_reads_the_others_baseline(tmp_path):
    """The same findings through both packages' baselines: one file,
    written by either, ratchets in the other."""
    from presto_tpu.lint.baseline import load_baseline as ref_load
    from presto_tpu.lint.baseline import save_baseline as ref_save
    fixture = os.path.join(REPO, FIXTURES, "s001_bad.py")
    findings = run_passes(codes=["S001"], paths=[fixture]).findings
    path = str(tmp_path / "b.json")
    ref_save(build_baseline(findings), path)
    assert ref_load(path) == load_baseline(path)
    rc, out = _cli(["--select", "S001", "--baseline", path, "--json",
                    fixture])
    assert rc == 0 and json.loads(out)["baselined"] == len(findings)


# -- the CLI contract ------------------------------------------------------


@pytest.mark.parametrize("args", [["--no-baseline", "no/such/file.py"],
                                  ["--select", "X999"], ["BROKEN"]])
def test_bad_input_is_an_error_not_clean(tmp_path, args):
    """A typo'd path, an unknown code or an unparseable file exits 2,
    never 'ok across 0 files'."""
    if args == ["BROKEN"]:
        p = tmp_path / "broken.py"
        p.write_text("def f(:\n")
        args = ["--no-baseline", str(p)]
    assert _cli(args)[0] == 2


def test_bad_baseline_version_is_an_error(tmp_path):
    bl = tmp_path / "b.json"
    bl.write_text(json.dumps({"version": 99, "entries": {}}))
    assert _cli(["--select", "S001", "--baseline", str(bl)])[0] == 2


def test_json_schema_is_stable():
    fixture = os.path.join(REPO, FIXTURES, "s001_bad.py")
    rc, out = _cli(["--select", "S001", "--no-baseline", "--json",
                    fixture])
    assert rc == 1
    doc = json.loads(out)
    assert set(doc) == {"version", "passes", "filesScanned", "findings",
                        "baselined", "suppressed", "staleBaseline"}
    assert doc["version"] == 1
    for f in doc["findings"]:
        assert set(f) == {"code", "path", "line", "col", "context",
                          "message", "fingerprint"}
    assert _cli(["--select", "S001", "--no-baseline", "--json",
                 fixture])[1] == out


def test_json_document_equals_the_references():
    """One fixture through both CLIs' --json: the same document."""
    from presto_tpu.lint.cli import main as ref_main
    fixture = os.path.join(REPO, FIXTURES, "m003_bad.py")
    args = ["--select", "M003", "--no-baseline", "--json", fixture]
    buf = io.StringIO()
    with redirect_stdout(buf):
        ref_rc = ref_main(list(args))
    assert _cli(args) == (ref_rc, buf.getvalue())


def test_fingerprint_is_line_independent():
    from presto_tpu_torch.lint.passes.wide_lanes import scan_module
    a = scan_module(ModuleSource("mod.py", REPO, text=W001_SRC))
    b = scan_module(ModuleSource("mod.py", REPO, text="# pad\n\n" + W001_SRC))
    assert len(a) == 7  # scan_module leaves suppression to the engine
    assert [f.fingerprint for f in a] == [f.fingerprint for f in b]
    assert [f.line for f in a] != [f.line for f in b]


def test_format_github_annotations():
    fixture = os.path.join(FIXTURES, "s001_bad.py")
    rc, out = _cli(["--select", "S001", "--no-baseline", "--format",
                    "github", os.path.join(REPO, fixture)])
    assert rc == 1
    lines = [ln for ln in out.splitlines() if ln]
    assert len(lines) >= 3
    pat = re.compile(r"^::error file=([^,]+),line=(\d+),"
                     r"title=tpulint S001::(.+)$")
    for line in lines:
        m = pat.match(line)
        assert m, line
        assert m.group(1) == fixture.replace(os.sep, "/")
        assert int(m.group(2)) > 0


def test_explicit_path_honors_pass_targets(tmp_path):
    """A file inside some pass's targets runs only the passes that own
    it; a file outside every target runs through all of them."""
    result = run_passes(paths=[os.path.join(
        REPO, "presto_tpu_torch/server/worker.py")])
    assert set(result.pass_codes) == set(ALL_CODES)
    assert result.findings == []
    owners = {p.code for p in [get_pass(c) for c in ALL_CODES]
              if "presto_tpu_torch/server/worker.py" in p.target_files()}
    assert owners == {"C001", "C002", "C003", "C004", "M001", "M002",
                      "S001"}
    codes = {f.code for f in run_passes(
        paths=[_fixture("W001", tmp_path)]).findings}
    assert "W001" in codes


# -- pass-specific pins ------------------------------------------------------


def test_c001_declarations_are_the_references():
    """Every _GUARDED_BY / _GUARDED_BY_SHARED declaration of the
    reference is on the port's counterpart class or module, guarding
    the same names (less `_vmapped`: the port batches without vmap)."""
    import ast
    import glob

    def decls(pkg):
        out = {}
        for path in glob.glob(os.path.join(REPO, pkg, "**", "*.py"),
                              recursive=True):
            rel = os.path.relpath(path, os.path.join(REPO, pkg))
            if rel.startswith("lint"):
                continue
            tree = ast.parse(open(path, encoding="utf-8").read())
            for node in ast.walk(tree):
                if not isinstance(node, (ast.Module, ast.ClassDef)):
                    continue
                for st in node.body:
                    if isinstance(st, ast.Assign) and \
                            len(st.targets) == 1 and \
                            isinstance(st.targets[0], ast.Name) and \
                            "GUARDED_BY" in st.targets[0].id:
                        key = (rel, getattr(node, "name", "<module>"),
                               st.targets[0].id)
                        out[key] = sorted(
                            c.value for c in ast.walk(st.value)
                            if isinstance(c, ast.Constant))
        return out
    ref, mine = decls("presto_tpu"), decls("presto_tpu_torch")
    assert len(ref) == 32
    ref[("exec/batching.py", "BatchingExecutor", "_GUARDED_BY")].remove(
        "_vmapped")
    assert mine == ref


def test_c001_respects_locked_suffix_and_init():
    fixture = os.path.join(REPO, FIXTURES, "c001_bad.py")
    contexts = {f.context for f in
                run_passes(codes=["C001"], paths=[fixture]).findings}
    assert "Registry.__init__" not in contexts
    assert "Registry._reset_locked" not in contexts
    assert {"Registry.wrong_lock", "helper_bad", "deferred_bad.cb",
            "__init__.warm"} <= contexts


_C001_CASES = {
    "module": ("import threading\n"
               "_L = threading.Lock()\n"
               "_T = {'n': 0}\n"
               "_GUARDED_BY = {'_L': ('_T',)}\n"
               "def bad():\n"
               "    _T['n'] += 1\n"
               "def bad_rebind():\n"
               "    global _T\n"
               "    _T = {}\n"
               "def good():\n"
               "    with _L:\n"
               "        _T['n'] += 1\n", ["bad", "bad_rebind"]),
    "shared": ("class Tree:\n"
               "    _GUARDED_BY = {'_cv': ('_ticket',)}\n"
               "    _GUARDED_BY_SHARED = ('_cv',)\n"
               "    def good_via_self(self, root):\n"
               "        with self._cv:\n"
               "            root._ticket += 1\n"
               "    def bad_unlocked(self, root):\n"
               "        root._ticket += 1\n", ["Tree.bad_unlocked"]),
    "caller": ("import threading\n"
               "class Buf:\n"
               "    _GUARDED_BY = {'<caller>': ('_pages',)}\n"
               "    def ok_push(self, x):\n"
               "        self._pages = [x]\n"
               "def bad_helper(buf):\n"
               "    buf._pages = []\n"
               "def good_helper(buf, task):\n"
               "    with task.lock:\n"
               "        buf._pages = []\n", ["bad_helper"]),
}


@pytest.mark.parametrize("case", sorted(_C001_CASES))
def test_c001_declaration_forms(tmp_path, case):
    """Module-level guards, shared locks and caller-held locks: the
    same contexts through both packages."""
    from presto_tpu.lint import run_passes as ref_run_passes
    text, want = _C001_CASES[case]
    p = tmp_path / f"{case}.py"
    p.write_text(text)
    mine = run_passes(codes=["C001"], paths=[str(p)]).findings
    assert sorted(f.context for f in mine) == want
    assert _shape(mine) == _shape(
        ref_run_passes(codes=["C001"], paths=[str(p)]).findings)


def test_c001_targets_cover_threaded_exec_modules():
    files = set(get_pass("C001").target_files())
    assert {"presto_tpu_torch/exec/batching.py",
            "presto_tpu_torch/exec/regions.py",
            "presto_tpu_torch/exec/progress.py",
            "presto_tpu_torch/server/dispatcher.py",
            "presto_tpu_torch/server/buffers.py"} <= files


_C002_CASES = {
    "consistent": ("import threading\n"
                   "_a = threading.Lock()\n"
                   "_b = threading.Lock()\n"
                   "def one():\n"
                   "    with _a:\n"
                   "        with _b:\n"
                   "            pass\n"
                   "def two():\n"
                   "    with _a:\n"
                   "        with _b:\n"
                   "            pass\n", 0),
    "viacall": ("import threading\n"
                "_a = threading.Lock()\n"
                "_b = threading.Lock()\n"
                "def helper_takes_b():\n"
                "    with _b:\n"
                "        pass\n"
                "def forward():\n"
                "    with _a:\n"
                "        helper_takes_b()\n"
                "def reverse():\n"
                "    with _b:\n"
                "        with _a:\n"
                "            pass\n", 1),
}


@pytest.mark.parametrize("case", sorted(_C002_CASES))
def test_c002_cycles_through_call_edges(tmp_path, case):
    text, n = _C002_CASES[case]
    p = tmp_path / f"{case}.py"
    p.write_text(text)
    findings = run_passes(codes=["C002"], paths=[str(p)]).findings
    assert len(findings) == n
    if n:
        assert "viacall._a -> viacall._b -> viacall._a" in \
            findings[0].message


def test_c002_reports_both_acquisition_paths():
    fixture = os.path.join(REPO, FIXTURES, "c002_bad.py")
    msgs = {f.message for f in
            run_passes(codes=["C002"], paths=[fixture]).findings}
    assert len(msgs) == 3
    assert any("_reg" in m and "_stats" in m and "reg_then_stats" in m
               and "stats_then_reg" in m for m in msgs), msgs


def test_c003_transitive_blocking_and_torch_synchronize(tmp_path):
    """A helper that sleeps, called under a lock, is flagged at the call
    site; torch's synchronize under a lock is a device sync."""
    p = tmp_path / "indirect.py"
    p.write_text("import threading\n"
                 "import time\n"
                 "import torch\n"
                 "_l = threading.Lock()\n"
                 "def slow_flush():\n"
                 "    time.sleep(0.1)\n"
                 "def bad_caller():\n"
                 "    with _l:\n"
                 "        slow_flush()\n"
                 "def bad_sync():\n"
                 "    with _l:\n"
                 "        torch.cuda.synchronize()\n")
    findings = run_passes(codes=["C003"], paths=[str(p)]).findings
    assert {f.context for f in findings} == {"bad_caller", "bad_sync"}
    assert any("slow_flush" in f.message for f in findings)
    assert any("(device_sync)" in f.message for f in findings)


def test_c003_allowlist_names_real_sites():
    from presto_tpu_torch.lint.passes.blocking import ALLOWED
    for rel, context, _detail in ALLOWED:
        cls, method = context.split(".", 1)
        src = open(os.path.join(REPO, rel), encoding="utf-8").read()
        assert f"class {cls}" in src and f"def {method}" in src, context


def test_c004_stop_flag_loop_and_daemon_are_silent():
    fixture = os.path.join(REPO, FIXTURES, "c004_bad.py")
    contexts = {f.context for f in
                run_passes(codes=["C004"], paths=[fixture]).findings}
    assert contexts == {"LeakyService.start_bad_attr",
                        "LeakyService.start_bad_local",
                        "LeakyService.start_bad_anonymous",
                        "LeakyService._spin"}


def test_s001_flags_bare_return_not_value_return():
    fixture = os.path.join(REPO, FIXTURES, "s001_bad.py")
    contexts = {f.context for f in
                run_passes(codes=["S001"], paths=[fixture]).findings}
    assert "handler_bare_return" in contexts
    assert "handler_returns" not in contexts


@pytest.mark.parametrize("code,contexts", [
    ("M001", {"collect_bad", "index_bad"}),
    ("M002", {"gather_unreserved", "flatten_rows", "read_footer"}),
    ("M003", {"stage_bad", "cast_then_pad_bad", "double_cast_bad"}),
])
def test_alloc_fixture_contexts(code, contexts):
    fixture = os.path.join(REPO, FIXTURES, f"{code.lower()}_bad.py")
    findings = run_passes(codes=[code], paths=[fixture]).findings
    assert {f.context for f in findings} == contexts


def test_m003_torch_transfer_keeps_the_chain(tmp_path):
    """torch.as_tensor / torch.from_numpy are the transfer terminal: a
    cast, the transfer and another cast are still two host copies."""
    p = tmp_path / "stage.py"
    p.write_text("import numpy as np\n"
                 "import torch\n"
                 "def stage_bad(x):\n"
                 "    return torch.as_tensor(x.astype(np.int32)"
                 ".astype(np.int64))\n"
                 "def stage_ok(x):\n"
                 "    return torch.from_numpy(x.astype(np.int32))\n")
    findings = run_passes(codes=["M003"], paths=[str(p)]).findings
    assert [f.context for f in findings] == ["stage_bad"]


def test_block_string_decode_is_one_conversion():
    """block.py's ASCII string fetch (M003's fixed site): object arrays
    of str, equal to a row-by-row UTF-8 decode."""
    import numpy as np

    from presto_tpu_torch.block import _decode_strings
    rng = np.random.default_rng(0)
    n, w = 64, 9
    lengths = rng.integers(0, w + 1, n)
    chars = rng.integers(97, 123, (n, w)).astype(np.uint8)
    got = _decode_strings(chars, lengths)
    want = [chars[i, :lengths[i]].tobytes().decode() for i in range(n)]
    assert got.dtype == object and list(got) == want
    assert all(type(v) is str for v in got)
