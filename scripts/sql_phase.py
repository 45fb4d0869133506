"""chip_smoke.py's phase_sql alone, on one CUDA card.

    python3 scripts/sql_phase.py [--out PATH] [--pairs N]

Builds the kernels (phase_environment), runs TPC-DS q47's committed SF1
plan once through run_query for the rows phase_sql holds q47 from text
to (the full run takes them from phase_tpcds), then runs phase_sql with
chip_smoke's host-table cache; with --out, writes its report, the host
generation seconds and the card's name and power limit to PATH. The
host tables start cold, unlike in chip_smoke.py's full run.

With --pairs N, then against_json: q1, q6 and TPC-DS q47 at SF1 typed
as SQL text through presto_tpu_torch.sql against the plans
chip_smoke.py's JSON path runs (q1_plan and q6_plan as built, q47's
committed timed plan; run_query with prepared=True), one run of each,
then N runs of each in turns. Prints, per path, the medians of the
wall, stage, execute and fetch ms and the staged MB.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as C  # noqa: E402


def against_json(pairs):
    """{query: {"text": medians, "json": medians}} of the two paths run
    in turns (module docstring); the rows of both paths must agree."""
    import statistics
    import torch
    from presto_tpu_torch import sql
    from presto_tpu_torch.exec import run_query
    from presto_tpu_torch.plan import from_json
    from presto_tpu_torch.queries import load_corpus, load_tpcds_corpus
    corpus, q47 = load_corpus(), load_tpcds_corpus()["q47"]
    groups = corpus["q1_two_stage"]["max_groups"]
    cases = {
        "q1": (lambda: sql(C.SQL_Q1.format(table="lineitem"), sf=C.SF,
                           max_groups=groups),
               lambda: run_query(C.as_built(C.q1_plan(), C.SF), sf=C.SF,
                                 prepared=True), C._plain_rows),
        "q6": (lambda: sql(corpus["q6_two_stage"]["sql"], sf=C.SF),
               lambda: run_query(C.as_built(C.q6_plan(), C.SF), sf=C.SF,
                                 prepared=True), C._plain_rows),
        "tpcds_q47": (
            lambda: sql(q47["sql"], sf=q47["timed_sf"], catalog="tpcds",
                        max_groups=q47["timed_max_groups"],
                        join_capacity=q47["timed_join_capacity"]),
            lambda: run_query(from_json(q47["plan_timed"]),
                              sf=q47["timed_sf"], prepared=True,
                              default_join_capacity=q47[
                                  "timed_join_capacity"]),
            C._exact_rows)}
    out = {}
    for name, (text, plan, rows) in cases.items():
        runs = {"text": ([], []), "json": ([], [])}
        want = rows(text())
        if not C._close_rows(rows(plan()), want):
            raise AssertionError(f"{name}: text and JSON rows differ")
        for _ in range(pairs):
            for path, fn in (("text", text), ("json", plan)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = fn()
                torch.cuda.synchronize()
                runs[path][0].append((time.perf_counter() - t0) * 1e3)
                runs[path][1].append(res.stats)
        out[name] = {path: {"wall_ms": statistics.median(ms),
                            **C.run_split(stats)}
                     for path, (ms, stats) in runs.items()}
        print(f"against json {name}: {json.dumps(out[name])}", flush=True)
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the report here")
    ap.add_argument("--pairs", type=int, default=0,
                    help="then run against_json with N turns")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sql_phase: no CUDA device", file=sys.stderr)
        return 2
    from presto_tpu_torch.exec import run_query
    from presto_tpu_torch.plan import from_json
    from presto_tpu_torch.queries import load_tpcds_corpus
    t0 = time.perf_counter()
    C.install_host_cache()
    C.phase_environment()
    e = load_tpcds_corpus()["q47"]
    q47 = C._exact_rows(run_query(
        from_json(e["plan_timed"]), sf=e["timed_sf"], prepared=True,
        default_join_capacity=e["timed_join_capacity"]))
    torch.cuda.empty_cache()
    print(f"q47's committed plan: {len(q47)} rows, "
          f"{time.perf_counter() - t0:.1f} s in", flush=True)
    rep = C.phase_sql(q47)
    if args.pairs:
        rep["against_json"] = against_json(args.pairs)
    gpu = C._run(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"])
    print(gpu)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"sql": rep, "gen_s": C.GEN_S,
                       "total_s": time.perf_counter() - t0, "gpu": gpu},
                      f, indent=1, default=str)
    print(f"TOTAL {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
