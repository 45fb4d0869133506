"""chip_smoke.py's phase_cluster alone, on one CUDA card.

    python3 scripts/cluster_phase.py [--out PATH]

Builds the kernels (phase_environment), then runs the worker tier on
the card: a DiscoveryServer, two HTTP workers on cuda:0 and the
Coordinator (chip_smoke.phase_cluster: q1 at SF1 through
distribute_simple_agg with fused_limb_sums counted per task and in
turns with one device, q3 at SF1 with PARTITIONED joins, q1 from
add_exchanges, "all_at_once", a failover armed through POST
/v1/failpoint, a worker in a child process). With --out, writes the
report, the host generation seconds and the card's name and power
limit to PATH.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as C  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the report here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("cluster_phase: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    C.install_host_cache()
    C.phase_environment()
    rep = C.phase_cluster()
    gpu = C._run(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"])
    print(gpu)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"cluster": rep, "gen_s": C.GEN_S,
                       "total_s": time.perf_counter() - t0, "gpu": gpu},
                      f, indent=1, default=str)
    print(f"host generation {C.GEN_S}; TOTAL {time.perf_counter() - t0:.1f}"
          " s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
