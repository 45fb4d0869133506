"""tpulint CLI of the port: human and ``--json`` reporting, baseline
management, and the exit-code contract.

Counterpart of presto_tpu/lint/cli.py, with its flags and contract:

  0  clean -- no new findings, no stale baseline entries
  1  new findings and/or stale baseline entries
  2  internal error (unreadable file, bad baseline version, bad args)

``--json`` emits one schema-versioned document (``JSON_SCHEMA_VERSION``)
and ``--format github`` one ``::error`` annotation a finding. The
baseline is ``presto_tpu_torch/lint/baseline.json``, kept empty. The
report is shared with the kernel audit (``emit_report``).

    python -m presto_tpu_torch.lint                  # the port's gate
    python -m presto_tpu_torch.lint --json           # machine-readable
    python -m presto_tpu_torch.lint --select H001 presto_tpu_torch/ops/sort.py
    python -m presto_tpu_torch.lint --list-passes
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from .baseline import DEFAULT_BASELINE, run_scoped_baseline
from .core import all_passes, github_annotation, run_passes

__all__ = ["main", "JSON_SCHEMA_VERSION", "emit_report"]

JSON_SCHEMA_VERSION = 1


def emit_report(new, stale, *, baselined: int, suppressed: int,
                pass_codes, unit_count: int, unit_noun: str,
                as_json: bool, fmt: str, tool: str,
                github_site=None, github_title=None,
                stale_github_file=None) -> None:
    """One gate run in the shared output contract: the schema-v1
    ``--json`` document, ``--format github`` annotations, or the human
    report and its summary line, for tpulint and kernaudit alike.
    ``github_site(f) -> (file, line)``, ``github_title(f)`` and
    ``stale_github_file(s)`` place the annotations."""
    if as_json:
        doc = {
            "version": JSON_SCHEMA_VERSION,
            "passes": list(pass_codes),
            "filesScanned": unit_count,
            "findings": [f.to_json() for f in new],
            "baselined": baselined,
            "suppressed": suppressed,
            "staleBaseline": stale,
        }
        print(json.dumps(doc, indent=2, sort_keys=True))
    elif fmt == "github":
        for f in new:
            site = github_site(f) if github_site else (f.path, f.line)
            title = github_title(f) if github_title else \
                f"{tool} {f.code}"
            print(github_annotation(site[0], site[1], title, f.message))
        for s in stale:
            anchor = stale_github_file(s) if stale_github_file else \
                (s.get("path") or f"{tool}_baseline.json")
            print(github_annotation(
                anchor, 1, f"{tool} stale-baseline {s['fingerprint']}",
                f"expected {s['countExpected']}, found "
                f"{s['countFound']} -- debt paid, run "
                f"--update-baseline"))
    else:
        for f in new:
            print(f.render())
        for s in stale:
            print(f"stale baseline entry {s['fingerprint']} "
                  f"({s['code']} {s['path']}): expected "
                  f"{s['countExpected']}, found {s['countFound']} -- "
                  f"debt paid, run --update-baseline")
        summary = (f"{len(new)} finding(s), {baselined} baselined, "
                   f"{suppressed} suppressed, {len(stale)} stale "
                   f"baseline entr(ies) across "
                   f"{unit_count} {unit_noun}(s) "
                   f"[{','.join(pass_codes)}]")
        print(("FAIL " if (new or stale) else "ok ") + summary)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m presto_tpu_torch.lint",
        description="static analysis of the port (hot-path and "
                    "server-tier discipline)")
    p.add_argument("paths", nargs="*",
                   help="explicit files to lint (default: every pass's "
                        "own target modules)")
    p.add_argument("--select", metavar="CODES",
                   help="comma-separated pass codes to run "
                        "(e.g. W001,H001)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable output (schema-versioned)")
    p.add_argument("--format", choices=("text", "github"), default="text",
                   help="finding rendering: human text (default) or "
                        "GitHub Actions ::error annotations (CI); "
                        "--json takes precedence")
    p.add_argument("--baseline", metavar="PATH", default=None,
                   help=f"baseline file (default {DEFAULT_BASELINE})")
    p.add_argument("--no-baseline", action="store_true",
                   help="report every finding, ignore the baseline")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite the baseline to match current findings "
                        "(preserves reasons for surviving entries)")
    p.add_argument("--list-passes", action="store_true",
                   help="list registered passes and exit")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)

    if args.list_passes:
        for p in all_passes():
            print(f"{p.code}  {p.name:26s} {p.description}")
        return 0

    codes = None
    if args.select:
        codes = [c.strip().upper() for c in args.select.split(",")
                 if c.strip()]
        known = {p.code for p in all_passes()}
        unknown = [c for c in codes if c not in known]
        if unknown:
            print(f"tpulint: unknown pass code(s): {', '.join(unknown)} "
                  f"(known: {', '.join(sorted(known))})", file=sys.stderr)
            return 2

    try:
        result = run_passes(codes=codes, paths=args.paths or None)
    except (OSError, SyntaxError) as e:
        print(f"tpulint: {type(e).__name__}: {e}", file=sys.stderr)
        return 2

    # a partial run (explicit paths and/or --select) judges staleness
    # and rewrites only the in-scope entries (scanned file x selected
    # pass); everything else is kept untouched
    partial = bool(args.paths) or bool(args.select)

    def in_scope(entry: dict) -> bool:
        if not partial:
            return True
        return entry.get("code") in result.pass_codes and \
            entry.get("path") in result.files

    baselined = 0
    stale: List[dict] = []
    new = result.findings
    if not args.no_baseline:
        try:
            new, baselined, stale = run_scoped_baseline(
                result.findings, args.baseline or DEFAULT_BASELINE,
                args.update_baseline, partial, in_scope)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"tpulint: bad baseline: {e}", file=sys.stderr)
            return 2

    emit_report(new, stale, baselined=baselined,
                suppressed=result.suppressed,
                pass_codes=result.pass_codes,
                unit_count=result.files_scanned, unit_noun="file",
                as_json=args.as_json, fmt=args.format, tool="tpulint",
                stale_github_file=lambda s: s.get("path") or
                "presto_tpu_torch/lint/baseline.json")
    return 1 if (new or stale) else 0


if __name__ == "__main__":
    sys.exit(main())
