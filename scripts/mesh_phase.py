"""chip_smoke.py's phase_mesh alone, on one CUDA card.

    python3 scripts/mesh_phase.py [--out PATH] [--parts q1,joins,two_stage]

Builds the kernels (phase_environment), then runs the mesh on four
workers of the card (`make_mesh(4, devices=("cuda:0",) * 4)`):
`q1` (chip_smoke.mesh_q1: q1 at SF1 through the port's add_exchanges,
fused_limb_sums in each worker's PARTIAL, execute in turns with
one-device q1), `joins` (chip_smoke.mesh_join: q3 and q14 at SF10 with
PARTITIONED joins, the rows each worker received per exchange, the
reruns, the peak, execute) and `two_stage` (chip_smoke.mesh_two_stage:
the 22 committed two-stage plans at SF1 against the committed rows),
all three unless --parts names some. The host tables start cold,
unlike in chip_smoke.py's full run. With --out, writes the reports,
the host generation seconds and the card's name and power limit to
PATH.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as C  # noqa: E402

PARTS = ("q1", "joins", "two_stage")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the report here")
    ap.add_argument("--parts", default=",".join(PARTS),
                    help="comma-separated subset of " + ", ".join(PARTS))
    args = ap.parse_args()
    parts = args.parts.split(",")
    if set(parts) - set(PARTS):
        ap.error(f"unknown parts {sorted(set(parts) - set(PARTS))}")
    import torch
    if not torch.cuda.is_available():
        print("mesh_phase: no CUDA device", file=sys.stderr)
        return 2
    from presto_tpu_torch.parallel import make_mesh
    t0 = time.perf_counter()
    C.install_host_cache()
    C.phase_environment()
    mesh = make_mesh(C.MESH_WORKERS, devices=("cuda:0",) * C.MESH_WORKERS)
    rep = {}
    if "q1" in parts:
        rep["q1"] = C.mesh_q1(mesh)
        torch.cuda.empty_cache()
    if "joins" in parts:
        for name, plan_fn, oracle, tables in (
                ("q3", C.q3_plan, C.numpy_q3, C.Q3_TABLES),
                ("q14", C.q14_plan, C.numpy_q14, C.Q14_TABLES)):
            t1 = time.perf_counter()
            rep[name] = C.mesh_join(mesh, name, plan_fn, oracle, tables)
            rep[name]["s"] = time.perf_counter() - t1
    if "two_stage" in parts:
        t1 = time.perf_counter()
        rep["two_stage"] = C.mesh_two_stage(mesh)
        rep["two_stage_s"] = time.perf_counter() - t1
    gpu = C._run(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"])
    print(gpu)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"mesh": rep, "gen_s": C.GEN_S,
                       "total_s": time.perf_counter() - t0, "gpu": gpu},
                      f, indent=1, default=str)
    print(f"host generation {C.GEN_S}; TOTAL {time.perf_counter() - t0:.1f}"
          " s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
