"""chip_smoke.py's phase_files and phase_statement alone, on one CUDA
card.

    python3 scripts/front_tier_phase.py [--out PATH]

Builds the kernels (phase_environment), then runs the file connectors
(chip_smoke.phase_files: SF1 customer as CSV through localfile joined
with SF1 orders; where pyarrow imports, SF1 lineitem as parquet with q1,
q6, a pruned count, a CTAS and q6 over ORC) and the statement tier
(chip_smoke.phase_statement: q1 at SF1 over POST /v1/statement against
numpy_q1 with one fused_limb_sums launch, timed against sql() in turns;
q6 through a DB-API cursor; a transaction; SHOW CATALOGS;
system.queries; a full resource-group queue). Prints each phase's
seconds and the card's name and power limit; with --out, writes the
reports there too.
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
        print("front_tier_phase: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    C.install_host_cache()
    C.phase_environment()
    rep = {"files": C.phase_files(), "statement": C.phase_statement()}
    gpu = C._run(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"])
    print(gpu)
    rep.update(gen_s=C.GEN_S, total_s=time.perf_counter() - t0, gpu=gpu)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=1, default=str)
    print(f"phase_files {rep['files']['s']:.1f} s, phase_statement "
          f"{rep['statement']['s']:.1f} s; host generation {C.GEN_S}; "
          f"TOTAL {rep['total_s']:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
