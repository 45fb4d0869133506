"""chip_smoke.py's phase_exec alone, on one CUDA card.

    python3 scripts/exec_phase.py [dyn] [stream] [spill] [writes] [--out PATH]

Builds the kernels (phase_environment), then runs the named parts of
phase_exec (all four when none is named) with chip_smoke's host-table
cache, each part's failure printed and the exit code 1 at the end;
with --out, writes the parts' reports, the host generation seconds and
the card's name and power limit to PATH. The host tables start cold,
unlike in chip_smoke.py's full run.
"""

import argparse
import json
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as C  # noqa: E402

PARTS = {"dyn": "exec_dynamic_filters", "stream": "exec_streaming",
         "spill": "exec_spill", "writes": "exec_writes"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parts", nargs="*", choices=sorted(PARTS))
    ap.add_argument("--out", help="also write the reports here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("exec_phase: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    C.install_host_cache()
    C.phase_environment()
    out, rc = {}, 0
    for part in args.parts or list(PARTS):
        t = time.perf_counter()
        try:
            out[part] = getattr(C, PARTS[part])()
        except Exception:  # report every part, then fail
            traceback.print_exc()
            rc = 1
        print(f"PART {part}: {time.perf_counter() - t:.1f} s", flush=True)
    gpu = C._run(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"])
    print(gpu)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"parts": out, "gen_s": C.GEN_S,
                       "total_s": time.perf_counter() - t0, "gpu": gpu},
                      f, indent=1, default=str)
    print(f"TOTAL {time.perf_counter() - t0:.1f} s")
    return rc


if __name__ == "__main__":
    sys.exit(main())
