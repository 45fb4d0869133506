"""Grandfathered findings with reasons, committed: the ratchet.

Counterpart of presto_tpu/lint/baseline.py and of the scoped ratchet
sequence of presto_tpu/lint/cli.py (`run_scoped_baseline`), with the
reference's file format, so either package reads and rewrites the
other's file. The file maps fingerprints (line-independent, see
core.Finding.fingerprint) to ``{code, path, context, message, count,
reason}``. The port's lint keeps its baseline at
``presto_tpu_torch/lint/baseline.json`` (``DEFAULT_BASELINE``), with no
entry: its findings are fixed or suppressed at their line; the kernel
audit keeps its own (audit/baseline.json).

Semantics:

  * A current finding whose fingerprint has baseline budget left is
    *baselined* (not reported, counted separately).
  * More current findings than the baselined count -> the EXCESS are
    reported as new (a second copy of a grandfathered finding is new).
  * Fewer current findings than the baselined count -> the entry is
    *stale* and reported (exit non-zero): the debt was paid, so the
    baseline must shrink with it. ``--update-baseline`` rewrites the
    file to match, keeping the reasons of surviving entries.
  * A partial run (a subset of passes or units) judges staleness only
    for the entries in its scope.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Tuple

from .core import Finding

__all__ = ["BASELINE_VERSION", "DEFAULT_BASELINE", "load_baseline",
           "save_baseline", "apply_baseline", "build_baseline",
           "run_scoped_baseline"]

BASELINE_VERSION = 1
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.json")


def load_baseline(path: str) -> Dict[str, dict]:
    """-> {fingerprint: {code, path, context, message, count, reason}}.
    A missing file is an empty baseline."""
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if doc.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"baseline {path}: unsupported version {doc.get('version')!r}")
    return dict(doc.get("entries", {}))


def save_baseline(entries: Dict[str, dict], path: str) -> None:
    doc = {"version": BASELINE_VERSION,
           "entries": {fp: entries[fp] for fp in sorted(entries)}}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")


def apply_baseline(findings: List[Finding], entries: Dict[str, dict]
                   ) -> Tuple[List[Finding], int, List[dict]]:
    """-> (new_findings, baselined_count, stale_entries); stale entries
    carry ``countExpected``/``countFound``."""
    by_fp: Dict[str, List[Finding]] = {}
    for f in findings:
        by_fp.setdefault(f.fingerprint, []).append(f)
    new: List[Finding] = []
    baselined = 0
    for fp, group in by_fp.items():
        budget = int(entries.get(fp, {}).get("count", 0))
        baselined += min(budget, len(group))
        new.extend(group[budget:])
    stale: List[dict] = []
    for fp, e in entries.items():
        found = len(by_fp.get(fp, ()))
        if found < int(e.get("count", 0)):
            stale.append({"fingerprint": fp, "code": e.get("code"),
                          "path": e.get("path"),
                          "message": e.get("message"),
                          "reason": e.get("reason", ""),
                          "countExpected": int(e.get("count", 0)),
                          "countFound": found})
    new.sort(key=Finding.sort_key)
    stale.sort(key=lambda s: (s.get("path") or "", s["fingerprint"]))
    return new, baselined, stale


def build_baseline(findings: List[Finding],
                   old_entries: Optional[Dict[str, dict]] = None,
                   default_reason: str = "grandfathered"
                   ) -> Dict[str, dict]:
    """The baseline of exactly these findings; reasons carry over from
    ``old_entries`` where the fingerprint survives."""
    old_entries = old_entries or {}
    out: Dict[str, dict] = {}
    for f in findings:
        e = out.get(f.fingerprint)
        if e is not None:
            e["count"] += 1
            continue
        out[f.fingerprint] = {
            "code": f.code, "path": f.path, "context": f.context,
            "message": f.message, "count": 1,
            "reason": old_entries.get(f.fingerprint, {}).get(
                "reason", default_reason)}
    return out


def run_scoped_baseline(findings: List[Finding], baseline_path: str,
                        update: bool, partial: bool,
                        in_scope: Callable[[dict], bool]):
    """Load, optionally rewrite (keeping out-of-scope entries), apply,
    and scope stale detection to what was actually scanned. Raises the
    underlying OSError/ValueError/JSONDecodeError for the caller's
    exit-2 path. -> (new, baselined, stale)."""
    entries = load_baseline(baseline_path)
    if update:
        kept = {fp: e for fp, e in entries.items()
                if not in_scope(e)} if partial else {}
        rebuilt = build_baseline(findings, entries)
        rebuilt.update(kept)
        save_baseline(rebuilt, baseline_path)
        entries = rebuilt
    new, baselined, stale = apply_baseline(findings, entries)
    if partial:
        stale = [s for s in stale
                 if in_scope(entries.get(s["fingerprint"], {}))]
    return new, baselined, stale
