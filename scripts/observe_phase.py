"""chip_smoke.py's phase_observe alone, on one CUDA card, with the two
phases that read the ledgers' routes after their q1.

    python3 scripts/observe_phase.py [--parts statement,observe,cluster]
                                     [--out PATH]

Builds the kernels (phase_environment), then runs the named phases of
chip_smoke.py in order (all three by default): phase_statement (q1 at
SF1 over POST /v1/statement, then the server's ledger routes and q1's
trace), phase_observe (q1 at SF1 through run_query with every ledger
on: stage walls, datapath hops, timeline, profiler row and accuracy
records; the ledgers on against off in turns with equal host syncs and
launches; EXPLAIN ANALYZE of q1 and q3 from text at SF1) and
phase_cluster (q1 across two workers, the merged QueryStats, the
stitched trace and both workers' ledger routes, then the rest of the
phase). Prints each phase's seconds and the card's name and power
limit; with --out, writes the reports there too.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as C  # noqa: E402

PHASES = {"statement": C.phase_statement, "observe": C.phase_observe,
          "cluster": C.phase_cluster}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parts", default="statement,observe,cluster")
    ap.add_argument("--out", help="also write the report here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("observe_phase: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    C.install_host_cache()
    C.phase_environment()
    rep, secs = {}, {}
    for name in args.parts.split(","):
        t1 = time.perf_counter()
        rep[name] = PHASES[name]()
        secs[name] = time.perf_counter() - t1
    gpu = C._run(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"])
    print(gpu)
    rep.update(phase_s=secs, gen_s=C.GEN_S,
               total_s=time.perf_counter() - t0, gpu=gpu)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=1, default=str)
    print(f"seconds by phase {json.dumps(secs)}; host generation "
          f"{C.GEN_S}; TOTAL {rep['total_s']:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
