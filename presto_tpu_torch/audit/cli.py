"""kernaudit CLI of the port: the ratcheted TPC-H corpus gate.

Counterpart of presto_tpu/audit/cli.py and scripts/kernaudit.py, with
the reference's contract:

  exit 0  clean -- no new findings, no stale baseline entries
  exit 1  new findings and/or stale baseline entries
  exit 2  internal error (a corpus query failed to stage or run, bad
          args, bad baseline)

``--json`` emits the schema-v1 document (``filesScanned`` counts
audited kernels); ``--format github`` emits ``::error`` annotations at
each finding's source site. The baseline is
``presto_tpu_torch/audit/baseline.json``, every entry with its reason.

The corpus is the 22 TPC-H queries of presto_tpu_torch/queries/
tpch_sf1.json (their SQL texts and capacity hints), planned by the
port's own planner, staged at ``--sf`` on ``--device`` (CUDA unless
named) and each lowered closure run once under the recorder: the local
tier as one device, the mesh tier on a one-worker mesh of that device,
and the batch tier as the batched dispatch runs it, the query's
template as one program over a member axis (exec/batching.py, two
members with the query's own parameters), where the group-by's sums
are a launch of fused_limb_sums_batched. `--tier both` stages the
local and mesh tiers, as the reference's does; `--tier all` (the
default) stages the three.

    python -m presto_tpu_torch.audit --device cpu --queries 1,3,6,9
    python -m presto_tpu_torch.audit --device cpu --json
    python -m presto_tpu_torch.audit --list-passes
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from ..lint.baseline import run_scoped_baseline
from ..lint.cli import JSON_SCHEMA_VERSION, emit_report
from .core import KernelTrace, all_passes, run_audit

__all__ = ["main", "DEFAULT_BASELINE", "DEFAULT_FOOTPRINT_BUDGET",
           "JSON_SCHEMA_VERSION", "corpus_queries", "corpus_kernels",
           "emit_report"]

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.json")

# the reference's K005 budget for the corpus gate: far above the sf
# 0.01 corpus's peaks, low enough that a runaway intermediate fails
DEFAULT_FOOTPRINT_BUDGET = 1 << 30

# the corpus tiers: the reference's both/local/mesh, and the batch tier
# beside them; all stages local, mesh and batch
TIERS = ("all", "both", "local", "mesh", "batch")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m presto_tpu_torch.audit",
        description="kernel audit of the port's lowered closures "
                    "(TPC-H corpus gate)")
    p.add_argument("--select", metavar="CODES",
                   help="comma-separated pass codes (e.g. K001,K004)")
    p.add_argument("--queries", metavar="NUMS",
                   help="corpus subset, e.g. 1,5-7,22 or q1,q3 "
                        "(default: 1-22)")
    p.add_argument("--tier", choices=TIERS,
                   default="all",
                   help="which corpus tiers to stage (default all)")
    p.add_argument("--sf", type=float, default=0.01,
                   help="corpus staging scale factor (default 0.01)")
    p.add_argument("--device", default=None,
                   help="device to run on (default: cuda)")
    p.add_argument("--budget-bytes", type=int,
                   default=DEFAULT_FOOTPRINT_BUDGET,
                   help="K005 footprint budget per kernel "
                        f"(default {DEFAULT_FOOTPRINT_BUDGET})")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable output (schema v1)")
    p.add_argument("--format", choices=("text", "github"), default="text",
                   help="human text (default) or GitHub Actions ::error "
                        "annotations; --json takes precedence")
    p.add_argument("--baseline", metavar="PATH", default=None,
                   help=f"baseline file (default {DEFAULT_BASELINE})")
    p.add_argument("--no-baseline", action="store_true",
                   help="report every finding, ignore the baseline")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite the baseline to match current findings "
                        "(keeps the reasons of surviving entries)")
    p.add_argument("--list-passes", action="store_true",
                   help="list registered passes and exit")
    return p


def corpus_queries() -> dict:
    """{number: (sql, max_groups, join_capacity)} of the 22 TPC-H
    queries, from the committed corpus (a query's single entry, else
    its two-stage entry, which carries the same text)."""
    from ..queries import CORPUS_PATH
    with open(CORPUS_PATH, encoding="utf-8") as f:
        entries = json.load(f)["queries"]
    out = {}
    for n in range(1, 23):
        e = entries.get(f"q{n}") or entries[f"q{n}_two_stage"]
        out[n] = (e["sql"], e.get("max_groups") or 1 << 16,
                  e.get("join_capacity"))
    return out


def _parse_queries(spec: Optional[str]) -> List[int]:
    known = corpus_queries()
    if not spec:
        return sorted(known)
    out: List[int] = []
    for part in spec.replace("q", "").split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            lo, hi = part.split("-", 1)
            out.extend(range(int(lo), int(hi) + 1))
        else:
            out.append(int(part))
    unknown = [n for n in out if n not in known]
    if unknown:
        raise ValueError(f"not in the corpus: {unknown}")
    if not out:
        # a reversed range ('7-5') must not give a green gate that
        # audited nothing
        raise ValueError(f"--queries {spec!r} selects no corpus queries")
    return sorted(set(out))


def corpus_kernels(qnums: List[int], sf: float, tier: str, device,
                   budget: int) -> List[KernelTrace]:
    """Plan, stage and trace each query's closure once, per tier: the
    closure at the capacities the ladder last fitted (its own where it
    has not run), not dispatched before."""
    from ..block import resolve_device
    from ..exec.runner import (_fitted_capacities, _lower, prepare_plan,
                               stage_scans)
    from ..parallel.mesh import make_mesh
    from ..sql import plan_sql
    from .staged import trace_closure

    if tier not in TIERS:
        raise ValueError(f"unknown corpus tier {tier!r}; one of {TIERS}")
    dev = resolve_device(device)
    queries = corpus_queries()
    meshes = []
    if tier in ("all", "both", "local"):
        meshes.append(None)
    if tier in ("all", "both", "mesh"):
        meshes.append(make_mesh(1, devices=(str(dev),)))
    kernels: List[KernelTrace] = []
    for mesh in meshes:
        for n in qnums:
            text, max_groups, join_capacity = queries[n]
            root = prepare_plan(plan_sql(text, max_groups=max_groups,
                                         join_capacity=join_capacity),
                                sf=sf, mesh=mesh)
            batches = stage_scans(root, sf, dev, mesh=mesh)
            _, ids, factors = _fitted_capacities(root, mesh)
            plan, _ = _lower(root, ids, factors, mesh, "narrow",
                             join_capacity or 1 << 16)
            label = f"tpch/q{n:02d}" + (".mesh" if mesh is not None else "")
            kernels.append(trace_closure(plan.fn, batches, label, mesh=mesh,
                                         budget=budget))
    if tier in ("all", "batch"):
        from ..exec.batching import BatchingExecutor
        ex = BatchingExecutor()
        for n in qnums:
            text, max_groups, join_capacity = queries[n]
            fn, batches = ex.program([text, text], sf=sf, device=dev,
                                     max_groups=max_groups,
                                     join_capacity=join_capacity)
            kernels.append(trace_closure(fn, batches, f"tpch/q{n:02d}.batch",
                                         budget=budget, members=2))
    return kernels


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)

    if args.list_passes:
        for p in all_passes():
            print(f"{p.code}  {p.name:22s} {p.description}")
        return 0

    codes = None
    if args.select:
        codes = [c.strip().upper() for c in args.select.split(",")
                 if c.strip()]
        known = {p.code for p in all_passes()}
        unknown = [c for c in codes if c not in known]
        if unknown:
            print(f"kernaudit: unknown pass code(s): "
                  f"{', '.join(unknown)} "
                  f"(known: {', '.join(sorted(known))})", file=sys.stderr)
            return 2

    try:
        qnums = _parse_queries(args.queries)
        kernels = corpus_kernels(qnums, args.sf, args.tier, args.device,
                                 args.budget_bytes)
    except Exception as e:  # noqa: BLE001 - a corpus query that stops
        # planning or running turns the gate red-2, never green
        print(f"kernaudit: {type(e).__name__}: {e}", file=sys.stderr)
        return 2

    result = run_audit(kernels, codes=codes)

    # partial runs only ratchet the entries whose (pass, kernel) was
    # audited: the reference's scoped staleness
    partial = bool(args.select) or bool(args.queries) or \
        args.tier != "all"

    def in_scope(entry: dict) -> bool:
        if not partial:
            return True
        return entry.get("code") in result.pass_codes and \
            entry.get("path") in result.kernels

    baselined = 0
    stale: List[dict] = []
    new = result.findings
    if not args.no_baseline:
        try:
            new, baselined, stale = run_scoped_baseline(
                result.findings, args.baseline or DEFAULT_BASELINE,
                args.update_baseline, partial, in_scope)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"kernaudit: bad baseline: {e}", file=sys.stderr)
            return 2

    def github_site(f):
        # a finding without a source site anchors on the gate's module:
        # GitHub drops annotations at a missing file or line 0
        return (getattr(f, "src_path", "") or
                "presto_tpu_torch/audit/cli.py", max(f.line, 1))

    emit_report(new, stale, baselined=baselined,
                suppressed=result.suppressed, pass_codes=result.pass_codes,
                unit_count=result.kernels_audited, unit_noun="kernel",
                as_json=args.as_json, fmt=args.format, tool="kernaudit",
                github_site=github_site,
                github_title=lambda f: f"kernaudit {f.code} [{f.path}]",
                stale_github_file=lambda s:
                "presto_tpu_torch/audit/baseline.json")
    return 1 if (new or stale) else 0


if __name__ == "__main__":
    sys.exit(main())
