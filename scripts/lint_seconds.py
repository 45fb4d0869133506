"""The port's static lint timed on this host's CPU: the whole run of the
eleven passes over the port's files (the first run of the process, and
a second), each pass alone, the lock graph's build and H001's site scan
(what chip_smoke.py's cross-checks read).

    python3 scripts/lint_seconds.py [--repeats N]

Prints one JSON line: seconds by measurement, the files scanned, the
findings and suppressed sites, and the host's CPU count. It reads
source only and needs no device.
"""

import argparse
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=2,
                    help="whole-tree runs after the first (default 2)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    t0 = time.perf_counter()
    from presto_tpu_torch.lint import all_passes, run_passes
    from presto_tpu_torch.lint.lockgraph import build_doc
    from presto_tpu_torch.lint.passes.host_sync import sites
    out = {"import_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    first = run_passes()
    out["first_run_s"] = time.perf_counter() - t0
    runs = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        run_passes()
        runs.append(time.perf_counter() - t0)
    out["runs_s"] = runs
    out["per_pass_s"] = {}
    for p in all_passes():
        t0 = time.perf_counter()
        run_passes(codes=[p.code])
        out["per_pass_s"][p.code] = time.perf_counter() - t0
    from presto_tpu_torch.lint.passes import lock_order
    lock_order._PROGRAM_CACHE.clear()  # a cold build, as the CLI's
    t0 = time.perf_counter()
    doc = build_doc()
    out["lockgraph_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    h001 = sites()
    out["h001_sites_s"] = time.perf_counter() - t0
    out.update(files=first.files_scanned, findings=len(first.findings),
               suppressed=first.suppressed, locks=len(doc["nodes"]),
               edges=len(doc["edges"]), h001_sites=len(h001),
               cpus=os.cpu_count())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
