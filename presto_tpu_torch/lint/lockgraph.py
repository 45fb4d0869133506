"""lockgraph: the port's lock-acquisition-order graph as a reviewable
artifact.

Counterpart of scripts/lockgraph.py. It builds the whole-program graph
C002 checks (lint/lockmodel.py has the extraction rules) over the
port's concurrency targets and:

  * writes/refreshes the committed ``presto_tpu_torch/lint/
    LOCK_ORDER.json`` (``--update``), so every change of acquisition
    order shows in review;
  * renders GraphViz DOT (``--dot [PATH]``, '-' for stdout);
  * gates (``--check``): exit 2 when the CURRENT graph has a cycle (a
    potential deadlock), exit 1 when it drifts from the committed
    artifact (lock set or ordered pairs; evidence lines may move), 0
    when clean.

    python -m presto_tpu_torch.lint.lockgraph --check
    python -m presto_tpu_torch.lint.lockgraph --update
    python -m presto_tpu_torch.lint.lockgraph --dot graph.dot

The runtime complement is the lock-order witness (utils/locks.py):
same node names; chip_smoke.py holds every ordered pair the armed
witness sees on the card to an edge of this artifact.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .core import REPO, get_pass
from .passes.lock_order import program_for_targets

__all__ = ["DEFAULT_ARTIFACT", "build_doc", "render_dot", "main"]

DEFAULT_ARTIFACT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "LOCK_ORDER.json")
_UPDATE = "python -m presto_tpu_torch.lint.lockgraph --update"


def build_doc() -> dict:
    """The LOCK_ORDER.json document of the port's current source."""
    targets = get_pass("C002").target_files()
    return program_for_targets(targets).to_doc()


def render_dot(doc: dict) -> str:
    """GraphViz digraph: one node per lock (colored by module), one
    edge per established order, cycles (if any) in red."""
    cyc_edges = set()
    for cyc in doc.get("cycles", []):
        ring = cyc + [cyc[0]]
        cyc_edges.update(zip(ring, ring[1:]))
    lines = ["digraph lock_order {",
             '  rankdir=LR; node [shape=box, fontsize=10];']
    mods = {}
    for n in doc["nodes"]:
        mod = n["id"].split(".")[0]
        mods.setdefault(mod, []).append(n)
    used = {e["from"] for e in doc["edges"]} | \
           {e["to"] for e in doc["edges"]}
    for mod, nodes in sorted(mods.items()):
        shown = [n for n in nodes if n["id"] in used]
        if not shown:
            continue
        lines.append(f'  subgraph "cluster_{mod}" {{ label="{mod}";')
        for n in shown:
            lines.append(f'    "{n["id"]}" [label="{n["id"]}"];')
        lines.append("  }")
    for e in doc["edges"]:
        attrs = [f'label="{os.path.basename(e["file"])}:{e["line"]}"',
                 "fontsize=8"]
        if (e["from"], e["to"]) in cyc_edges:
            attrs.append("color=red penwidth=2")
        lines.append(f'  "{e["from"]}" -> "{e["to"]}" '
                     f'[{" ".join(attrs)}];')
    lines.append("}")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m presto_tpu_torch.lint.lockgraph",
        description="server-tier lock-order graph: artifact, DOT, gate")
    ap.add_argument("--artifact", default=DEFAULT_ARTIFACT,
                    help=f"graph artifact path (default "
                         f"{os.path.relpath(DEFAULT_ARTIFACT, REPO)})")
    ap.add_argument("--update", action="store_true",
                    help="rewrite the committed artifact from source")
    ap.add_argument("--check", action="store_true",
                    help="gate: exit 2 on cycle, 1 on drift vs the "
                         "committed artifact, 0 clean")
    ap.add_argument("--dot", nargs="?", const="-", metavar="PATH",
                    help="render GraphViz DOT to PATH ('-' = stdout)")
    args = ap.parse_args(argv)

    try:
        doc = build_doc()
    except (OSError, SyntaxError) as e:
        print(f"lockgraph: {type(e).__name__}: {e}", file=sys.stderr)
        return 2

    if args.dot is not None:
        dot = render_dot(doc)
        if args.dot == "-":
            sys.stdout.write(dot)
        else:
            with open(args.dot, "w", encoding="utf-8") as f:
                f.write(dot)
            print(f"lockgraph: wrote {args.dot}")

    if args.update:
        with open(args.artifact, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"lockgraph: wrote {args.artifact} "
              f"({len(doc['nodes'])} locks, {len(doc['edges'])} edges, "
              f"{len(doc['cycles'])} cycles)")

    if args.check:
        if doc["cycles"]:
            for cyc in doc["cycles"]:
                print(f"lockgraph: CYCLE {' -> '.join(cyc + [cyc[0]])}",
                      file=sys.stderr)
            return 2
        try:
            with open(args.artifact, encoding="utf-8") as f:
                committed = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"lockgraph: cannot read committed artifact: {e} "
                  f"-- run {_UPDATE}",
                  file=sys.stderr)
            return 1
        # STRUCTURAL drift only (lock set + edge set): evidence line
        # numbers move on every unrelated edit and must not fail CI
        cn = {n["id"] for n in committed.get("nodes", [])}
        dn = {n["id"] for n in doc["nodes"]}
        ce = {(e["from"], e["to"]) for e in committed.get("edges", [])}
        de = {(e["from"], e["to"]) for e in doc["edges"]}
        if cn != dn or ce != de:
            for x in sorted(dn - cn):
                print(f"lockgraph: new lock {x}", file=sys.stderr)
            for x in sorted(cn - dn):
                print(f"lockgraph: removed lock {x}", file=sys.stderr)
            for a, b in sorted(de - ce):
                print(f"lockgraph: new edge {a} -> {b}", file=sys.stderr)
            for a, b in sorted(ce - de):
                print(f"lockgraph: removed edge {a} -> {b}",
                      file=sys.stderr)
            print(f"lockgraph: drift vs committed artifact -- run "
                  f"{_UPDATE} and review the diff", file=sys.stderr)
            return 1
        print(f"lockgraph: ok ({len(doc['nodes'])} locks, "
              f"{len(doc['edges'])} edges, cycle-free, matches "
              f"{os.path.relpath(args.artifact, os.getcwd())})")
        return 0

    if not (args.update or args.dot):
        # default: print the doc (machine-readable, like --json tools)
        json.dump(doc, sys.stdout, indent=1, sort_keys=True)
        sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
