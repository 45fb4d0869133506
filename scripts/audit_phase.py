"""chip_smoke.py's phase_audit: the kernel audit, buffer donation and the
lock-order witness on one CUDA card.

    python3 scripts/audit_phase.py [--corpus-sf SF] [--out PATH]

Alone it builds the kernels (chip_smoke.phase_environment) first, then
runs the phase with the witness armed around it; chip_smoke.py runs
`phase_audit(chip_smoke_module)` after phase_batching and arms the
witness around phase_cluster and phase_fleet. On `cuda:0`:

  q1         TPC-H q1 at SF1 through run_query with `kernel_audit` on:
             the audit's seconds on a memo miss (the process's first
             audit, which imports torch's dispatch machinery, and a
             second miss after clearing the memo) and on a hit; its
             rows equal the unaudited run's; the audited run and the
             dispatch each launch fused_limb_sums (2 launches), and the
             trace holds the launch as a record.
  syncs      the same closure traced once more under torch's sync debug
             mode: K002's host round trips (every site, whitelisted or
             not) against the synchronizations torch counts; and so
             the closure of the corpus's `agg_hash` (the hash-slot
             group-by, whose exit flag is read every 4 probe rounds)
             at sf 0.1.
  footprint  K005's estimate against torch.cuda.max_memory_allocated of
             that traced run, after reset_peak_memory_stats: above 1.0
             is a fault of the pass.
  h001       every K002 site of those two traces (source file and line)
             against the static lint's H001 sites over the port
             (lint/passes/host_sync.py::sites): each must be one,
             reported, suppressed or whitelisted; the H001 scan's
             seconds are printed.
  corpus     the gate over the 22 TPC-H queries, local, mesh and batch
             tiers, at `--corpus-sf` (0.1: q1 runs at SF1 above) against
             presto_tpu_torch/audit/baseline.json: no new finding, no
             stale entry; q1's batch trace (its template as one program
             of two members) holds the launch of
             fused_limb_sums_batched as a record, and none of
             fused_limb_sums.
  donation   the dashboard of phase_batching with fusion off (4 regions)
             and TPC-H q10 with fusion off, each with donation on and
             off in turns: rows equal, the peak MB of each, the
             donations and bytes handed over.

Every check raises on failure.
"""

import argparse
import json
import os
import sys
import time

SF = 1.0
CORPUS_SF = 0.1
DEVICE = "cuda:0"
PAIRS = 2


def _q1(C):
    """q1 at SF1 audited: miss (cold and warm), hit, rows, launches."""
    import torch
    from presto_tpu_torch import sql
    from presto_tpu_torch.audit.cli import corpus_queries
    from presto_tpu_torch.audit.staged import (clear_audit_memo,
                                               kernel_audit_totals)
    from presto_tpu_torch.ops import kernels as K
    text, max_groups, _jc = corpus_queries()[1]
    on = {"kernel_audit": True}
    plain = sql(text, sf=SF, device=DEVICE, max_groups=max_groups)
    out = {"miss_s": [], "hit_s": []}
    for i in range(2):
        clear_audit_memo()
        C._reset_launches()
        res = sql(text, sf=SF, device=DEVICE, max_groups=max_groups,
                  session=on, query_id=f"audit_q1_miss{i}")
        torch.cuda.synchronize()
        out["miss_s"].append(res.stats["kernel_audit_s"])
        if C._exact_rows(res) != C._exact_rows(plain):
            raise AssertionError("audited q1's rows differ from q1's")
        if K.LAUNCHES["fused_limb_sums"] != 2:
            raise AssertionError(f"audited q1 launched fused_limb_sums "
                                 f"{K.LAUNCHES['fused_limb_sums']} times, "
                                 f"not 2 (the audit's run and the "
                                 f"dispatch)")
    kernels = kernel_audit_totals()["kernels"]
    for i in range(2):
        hit = sql(text, sf=SF, device=DEVICE, max_groups=max_groups,
                  session=on, query_id=f"audit_q1_hit{i}")
        out["hit_s"].append(hit.stats["kernel_audit_s"])
    if kernel_audit_totals()["kernels"] != kernels:
        raise AssertionError("a memo hit re-ran the audit")
    c = res.query_stats.counters
    out["counters"] = {k: v for k, v in c.items()
                       if k.startswith("kernel_audit")}
    if c.get("kernel_audit_kernels") != 1 or \
            not c.get("kernel_audit_peak_bytes_estimate"):
        raise AssertionError(f"audited q1's counters: {out['counters']}")
    findings = {k: v for k, v in c.items()
                if k.startswith("kernel_audit.")}
    if findings:
        raise AssertionError(f"q1's closure has findings on the card: "
                             f"{findings}")
    print(f"audit q1 SF1: kernel_audit_s miss {out['miss_s']} (the first "
          f"pays the import of torch's dispatch machinery), hit "
          f"{out['hit_s']}; rows equal, fused_limb_sums launched twice "
          f"(audit + dispatch); counters {out['counters']}")
    return out


def _traced(C, label, text, max_groups, sf):
    """A query's closure at `sf`, as its first dispatch runs it, traced
    once under torch's sync debug mode after reset_peak_memory_stats:
    (trace, syncs counted, their sites, the allocator's peak)."""
    import torch
    from presto_tpu_torch.audit.core import run_audit
    from presto_tpu_torch.audit.staged import trace_closure
    from presto_tpu_torch.exec.runner import (_fitted_capacities, _lower,
                                              prepare_plan, stage_scans)
    from presto_tpu_torch.sql import plan_sql
    root = prepare_plan(plan_sql(text, max_groups=max_groups), sf=sf)
    batches = stage_scans(root, sf, torch.device(DEVICE))
    _, ids, factors = _fitted_capacities(root)
    plan, _ = _lower(root, ids, factors, None, "narrow", 1 << 16, 1, True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sites = []
    kernel, syncs = C._count_syncs(
        lambda: trace_closure(plan.fn, batches, label), sites)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    run_audit([kernel])
    return kernel, syncs, sites, peak


def _sync_check(label, kernel, syncs, sites) -> dict:
    """K002's host round trips (whitelisted or not) against the syncs
    torch counted in the same run; they must be equal."""
    from presto_tpu_torch.audit.passes.host_callback import \
        is_host_round_trip
    trips = [r for r in kernel.records if is_host_round_trip(r)]
    out = {"ops": len(kernel.records), "k002_sites": len(trips),
           "k002_at": sorted({f"{r.src}:{r.line} {r.op}" for r in trips}),
           "k002_lines": sorted({(r.src, r.line) for r in trips}),
           "syncs": syncs, "sync_sites": sites}
    print(f"audit trace {label}: {out['ops']} ops; K002 host round trips "
          f"{len(trips)} {out['k002_at']} against {syncs} syncs counted "
          f"by torch's sync debug mode")
    if len(trips) != syncs:
        raise AssertionError(f"{label}: K002 saw {len(trips)} host round "
                             f"trips, torch counted {syncs} syncs: "
                             f"{out['k002_at']} against {sites}")
    return out


def _trace_q1(C):
    """q1's SF1 closure traced once more: K002 against torch's sync
    count, K005 against the allocator's peak, the launch record; then
    agg_hash's closure at sf 0.1, K002 against the syncs."""
    import torch
    from presto_tpu_torch.audit.cli import corpus_queries
    from presto_tpu_torch.ops.aggregation import HASH_STATS
    from presto_tpu_torch.queries import load_corpus
    text, max_groups, _jc = corpus_queries()[1]
    kernel, syncs, sites, peak = _traced(C, "q1@SF1", text, max_groups, SF)
    out = _sync_check("q1 SF1", kernel, syncs, sites)
    est = kernel.notes["peak_bytes_estimate"]
    launches = [r for r in kernel.records
                if r.op == "kernel.fused_limb_sums"]
    out.update(peak_bytes_estimate=est, max_memory_allocated=peak,
               ratio=est / peak, launch_records=len(launches))
    print(f"audit trace q1 SF1: K005 estimate {est} B against "
          f"max_memory_allocated {peak} B (ratio {out['ratio']:.3f}); "
          f"fused_limb_sums records {len(launches)}")
    if len(launches) != 1:
        raise AssertionError("the trace does not hold q1's fused_limb_sums "
                             "launch as one record")
    if out["ratio"] > 1.0:
        raise AssertionError(f"K005's estimate {est} exceeds the "
                             f"allocator's peak {peak}")
    del kernel
    agg = load_corpus()["agg_hash"]
    checks0 = HASH_STATS["exit_checks"]
    kernel, syncs, sites, _ = _traced(C, "agg_hash@sf0.1", agg["sql"],
                                      agg["max_groups"], CORPUS_SF)
    out["agg_hash"] = _sync_check("agg_hash sf 0.1", kernel, syncs, sites)
    if HASH_STATS["exit_checks"] != checks0:
        raise AssertionError("the audited run changed HASH_STATS")
    del kernel
    torch.cuda.empty_cache()
    return out


def _h001_check(trace) -> dict:
    """Every K002 site of the traced closures is an H001 site of the
    port's static lint (reported, suppressed or whitelisted)."""
    from presto_tpu_torch.lint.passes.host_sync import sites
    t0 = time.perf_counter()
    h001 = sites()
    seconds = time.perf_counter() - t0
    k002 = sorted(set(trace["k002_lines"]) |
                  set(trace["agg_hash"]["k002_lines"]))
    standing = {f"{src}:{line}": [s["standing"] for s in h001[(src, line)]]
                for src, line in k002 if (src, line) in h001}
    missing = [f"{src}:{line}" for src, line in k002
               if (src, line) not in h001]
    out = {"h001_s": seconds, "h001_sites": len(h001), "k002": standing,
           "missing": missing}
    print(f"audit h001: the static H001 scan took {seconds:.3f} s and "
          f"found {len(h001)} sites; the traces' K002 sites {standing}; "
          f"{len(missing)} not among them")
    if missing:
        raise AssertionError(f"K002 sites that H001 does not find: "
                             f"{missing}")
    return out


def _corpus(sf):
    """The gate over the 22 queries, all three tiers, against the
    committed baseline; q1's batch trace records the batched launch."""
    from presto_tpu_torch.audit.cli import (DEFAULT_BASELINE,
                                            DEFAULT_FOOTPRINT_BUDGET,
                                            corpus_kernels)
    from presto_tpu_torch.audit.core import run_audit
    from presto_tpu_torch.lint.baseline import apply_baseline, load_baseline
    t0 = time.perf_counter()
    kernels = corpus_kernels(list(range(1, 23)), sf, "all", DEVICE,
                             DEFAULT_FOOTPRINT_BUDGET)
    q1_batch = next(k for k in kernels if k.label == "tpch/q01.batch")
    ops = {r.base for r in q1_batch.records}
    if "kernel.fused_limb_sums_batched" not in ops or \
            "kernel.fused_limb_sums" in ops:
        raise AssertionError("q1's batch trace does not record one "
                             "fused_limb_sums_batched launch: "
                             f"{sorted(o for o in ops if 'kernel' in o)}")
    result = run_audit(kernels)
    new, baselined, stale = apply_baseline(result.findings,
                                           load_baseline(DEFAULT_BASELINE))
    out = {"sf": sf, "kernels": result.kernels_audited,
           "ops": sum(len(k.records) for k in kernels),
           "new": [f.render() for f in new], "baselined": baselined,
           "stale": stale, "suppressed": result.suppressed,
           "peak_bytes": {k.label: k.notes.get("peak_bytes_estimate")
                          for k in kernels},
           "s": time.perf_counter() - t0}
    print(f"audit corpus at sf {sf}: {out['kernels']} kernels, "
          f"{out['ops']} ops, {len(new)} new finding(s), {baselined} "
          f"baselined, {len(stale)} stale, {result.suppressed} "
          f"suppressed, {out['s']:.1f} s")
    for line in out["new"]:
        print(f"  {line}")
    if new or stale:
        raise AssertionError(f"the corpus gate on the card: {len(new)} new "
                             f"finding(s), {len(stale)} stale entries")
    return out


def _donation_pair(C, name, text, max_groups, join_capacity):
    """One query with fusion off, donation on and off in turns: rows
    equal, each run's peak MB above the memory live before it."""
    import torch
    from presto_tpu_torch import sql
    rep = {"query": name, "on_mb": [], "off_mb": []}
    rows = {}
    for i in range(PAIRS):
        for mode in (("on", "off") if i % 2 == 0 else ("off", "on")):
            session = {"fusion": False, "query_batching": False,
                       "buffer_donation": mode == "on"}
            peak = {}
            with C._peak_mb(peak):
                res = sql(text, sf=SF, device=DEVICE, max_groups=max_groups,
                          join_capacity=join_capacity, session=session)
            rep[f"{mode}_mb"].append(peak["peak_mb"])
            rows.setdefault(mode, C._exact_rows(res))
            if mode == "on":
                rep["regions"] = res.stats["fusion_regions"]
                rep["donations"] = res.stats.get("donations", 0)
                rep["donated_bytes"] = res.stats.get("donated_bytes", 0)
            del res
            torch.cuda.empty_cache()
    if rows["on"] != rows["off"]:
        raise AssertionError(f"{name}: rows with donation differ")
    if not rep["donations"]:
        raise AssertionError(f"{name}: no region was handed an input")
    print(f"audit donation {name}: {rep['regions']} regions, "
          f"{rep['donations']} donations of {rep['donated_bytes']} B; "
          f"peak MB on {rep['on_mb']} off {rep['off_mb']}; rows equal")
    return rep


def phase_audit(C, corpus_sf=CORPUS_SF):
    """The phase (module docstring). `C` is chip_smoke's module. Returns
    the report, with the phase's seconds."""
    import numpy as np
    import torch
    from presto_tpu_torch.audit.cli import corpus_queries
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import batching_phase
    t0 = time.perf_counter()
    out = {"q1": _q1(C), "trace": _trace_q1(C)}
    out["h001"] = _h001_check(out["trace"])
    out["corpus"] = _corpus(corpus_sf)
    oracles = batching_phase.Oracles(C)
    key = batching_phase._keys(np.random.default_rng(0), oracles)[
        "dashboard"][0]
    out["donation"] = [
        _donation_pair(C, "dashboard", batching_phase.DASH.format(key), 16,
                       None),
        _donation_pair(C, "q10", *corpus_queries()[10])]
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    print(f"audit: the phase took {out['s']:.1f} s")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--corpus-sf", type=float, default=CORPUS_SF)
    ap.add_argument("--out", help="also write the report here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("audit_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as C
    from presto_tpu_torch.utils import locks
    t0 = time.perf_counter()
    C.install_host_cache()
    C.phase_environment()
    locks.reset_witness()
    locks.arm_witness()
    try:
        rep = phase_audit(C, args.corpus_sf)
    finally:
        locks.disarm_witness()
    rep["lock_violations"] = locks.witness_violations()
    print(f"lock-order witness: {len(rep['lock_violations'])} violations")
    if rep["lock_violations"]:
        raise AssertionError(rep["lock_violations"])
    gpu = C._run(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"])
    print(gpu)
    rep.update(gen_s=C.GEN_S, total_s=time.perf_counter() - t0, gpu=gpu)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=1, default=str)
    print(f"audit phase {rep['s']:.1f} s; host generation {C.GEN_S}; "
          f"TOTAL {rep['total_s']:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
