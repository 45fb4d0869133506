"""chip_smoke.py's phase_fleet alone, on one CUDA card.

    python3 scripts/fleet_phase.py [--out PATH]

Builds the kernels (phase_environment), installs the host-table cache
(install_host_cache: each table is generated at its first use), then
runs the cluster operations on the card
(chip_smoke.phase_fleet, q1 at SF1 throughout): a secured cluster (one
shared secret, TLS where cryptography imports) of discovery, two HTTP
workers on cuda:0 and the Coordinator, its exchange in lz4 pages; a
task's status as thrift; a drain with page migration between q1's
PARTIALs and its FINAL; the router, the resource manager and a
standby's adoption of a wedged primary's q1; the catalog server. With
--out, writes the report, the host generation seconds and the card's
name and power limit to PATH.
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
        print("fleet_phase: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    C.install_host_cache()
    C.phase_environment()
    rep = C.phase_fleet()
    gpu = C._run(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"])
    print(gpu)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"fleet": rep, "gen_s": C.GEN_S,
                       "total_s": time.perf_counter() - t0, "gpu": gpu},
                      f, indent=1, default=str)
    print(f"host generation {C.GEN_S}; TOTAL {time.perf_counter() - t0:.1f}"
          " s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
