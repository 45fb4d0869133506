"""Write presto_tpu_torch/queries/tpcds.json from the reference.

    python scripts/make_tpcds_corpus.py [--out PATH] [--jobs N]
                                        [--queries q3,q12]
    python scripts/make_tpcds_corpus.py --add-sql [--out PATH]

For each of the 99 queries of presto_tpu/queries/tpcds_queries.py::
TPCDS_QUERIES the file holds:

* "sql": the query's text, from which chip_smoke.py plans it through
  the port's own front door (`--add-sql` writes only this field into
  the existing file, planning and running nothing);
* "plan": the reference's prepared plan-fragment JSON at the query's
  suite scale factor (tests/test_tpcds_suite.py's FAST_CASES and
  SLOW_CASES, 0.02 for a query they do not list), planned with the
  harness's max_groups=1<<13 and join_capacity=1<<18 (and the
  session of SESSIONS, for q24);
* "rows": the rows the reference's run_query returns for that plan on
  the CPU, in the exact form of presto_tpu_torch.queries (scaled
  integers, days, text, float.hex, null);
* "plan_timed": the reference's prepared plan at "timed_sf", SF1 but
  for the queries of TIMED_SF, planned with max_groups=1<<16 and
  join_capacity=1<<22. This is planning only: the reference cannot run
  SF1 in reasonable time on the CPU, so the card's rows at that scale
  are held to the port's own CPU run of the same plan.

Plans repeat their subtrees and a few queries return thousands of rows
(q59 60,052), so each plan and each query's rows are stored as
zlib-compressed, base64-encoded JSON (`queries.load_tpcds_corpus`
decodes them). With
--queries, only those entries are rewritten in an existing file. The
whole corpus takes about 6 minutes with --jobs 5 on 8 cores (q59 and
the suite's other sf 0.1 and 0.2 queries are the slowest).
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import sys
import time
import zlib
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

DEFAULT_SF = 0.02
# Session properties a query is planned with. The reference's
# cost-based join reordering puts q24's many-to-many join on ca_state =
# s_state first (89.7M rows at sf 0.05), which overflows the capacity
# ladder's ceiling at its suite sf 0.2 and at SF1; in the SQL's own
# join order every join is on keys.
SESSIONS = {"q24": {"join_reordering_strategy": "NONE"}}
# The scale factor the card times a query at, SF1 unless listed. q72's
# plan (in the reference's join order and in the SQL's) joins
# catalog_sales with inventory on the item alone before any filter:
# 5.7M rows at sf 0.05, about 500M at SF1, beyond the join ladder's
# ceiling (1 << 26 rows in the port) and the card's memory; at sf 0.2
# it needs about 46M.
TIMED_SF = {"q72": 0.2}
SMALL_MAX_GROUPS, SMALL_JOIN_CAPACITY = 1 << 13, 1 << 18
SF1, TIMED_MAX_GROUPS, TIMED_JOIN_CAPACITY = 1.0, 1 << 16, 1 << 22


def suite_sf() -> dict:
    """{query name: scale factor} of the reference's TPC-DS suite."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_tpcds_suite import FAST_CASES, SLOW_CASES
    return {name: sf for name, sf, _ in FAST_CASES + SLOW_CASES}


def pack(value) -> str:
    """zlib-compressed, base64-encoded JSON of `value`."""
    raw = json.dumps(value, separators=(",", ":"), sort_keys=True)
    return base64.b64encode(zlib.compress(raw.encode(), 9)).decode()


def prepared(name: str, sf: float, max_groups: int, join_capacity: int):
    from presto_tpu.exec.runner import prepare_plan
    from presto_tpu.queries.tpcds_queries import TPCDS_QUERIES
    from presto_tpu.sql import plan_sql
    return prepare_plan(plan_sql(TPCDS_QUERIES[name], catalog="tpcds",
                                 max_groups=max_groups,
                                 join_capacity=join_capacity), sf=sf,
                        session=SESSIONS.get(name))


def reference_rows(plan, sf: float, join_capacity: int):
    """(names, types, exact rows) of the reference's run of a prepared
    plan, as presto_tpu.sql.sql runs it (the join capacity is also the
    default for joins the plan leaves open)."""
    from presto_tpu.exec import run_query
    from presto_tpu_torch import types as PT
    from presto_tpu_torch.queries import exact_rows
    res = run_query(plan, sf=sf, prepared=True,
                    default_join_capacity=join_capacity)
    types = [PT.parse_type(str(t)) for t in res.types]
    return (list(res.names), [str(t) for t in types],
            exact_rows(res.columns, res.nulls, types, res.row_count))


def make_entry(name: str, sf: float) -> dict:
    import presto_tpu  # noqa: F401  (jax x64 first)
    from presto_tpu.plan import nodes as RN
    t0 = time.perf_counter()
    small = prepared(name, sf, SMALL_MAX_GROUPS, SMALL_JOIN_CAPACITY)
    names, types, rows = reference_rows(small, sf, SMALL_JOIN_CAPACITY)
    timed_sf = TIMED_SF.get(name, SF1)
    big = prepared(name, timed_sf, TIMED_MAX_GROUPS, TIMED_JOIN_CAPACITY)
    print(f"{name}: {len(rows)} rows at sf {sf} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    from presto_tpu.queries.tpcds_queries import TPCDS_QUERIES
    return {"sql": TPCDS_QUERIES[name], "sf": sf,
            "plan": pack(RN.to_json(small)),
            "names": names, "types": types, "rows": pack(rows),
            "max_groups": SMALL_MAX_GROUPS,
            "join_capacity": SMALL_JOIN_CAPACITY,
            "plan_timed": pack(RN.to_json(big)), "timed_sf": timed_sf,
            "timed_max_groups": TIMED_MAX_GROUPS,
            "timed_join_capacity": TIMED_JOIN_CAPACITY}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(
        REPO, "presto_tpu_torch", "queries", "tpcds.json"))
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--queries", default="",
                    help="comma-separated names to rewrite in --out")
    ap.add_argument("--add-sql", action="store_true",
                    help="only write each query's SQL text into --out")
    args = ap.parse_args(argv)

    from presto_tpu.queries.tpcds_queries import TPCDS_QUERIES
    if args.add_sql:
        with open(args.out) as f:
            queries = json.load(f)["queries"]
        for name, q in queries.items():
            q["sql"] = TPCDS_QUERIES[name]
        write(args.out, queries)
        print(f"wrote the SQL texts into {args.out}")
        return 0
    sfs = suite_sf()
    names = (args.queries.split(",") if args.queries
             else sorted(TPCDS_QUERIES, key=lambda q: int(q[1:])))
    queries = {}
    if args.queries and os.path.exists(args.out):
        with open(args.out) as f:
            queries = json.load(f)["queries"]
    # the slowest (largest sf) first, so the pool's tail is short
    order = sorted(names, key=lambda q: -sfs.get(q, DEFAULT_SF))
    # spawn: a forked child of a process that imported jax can hang
    with ProcessPoolExecutor(max_workers=args.jobs, mp_context=multiprocessing
                             .get_context("spawn")) as pool:
        futs = {q: pool.submit(make_entry, q, sfs.get(q, DEFAULT_SF))
                for q in order}
        for q, fut in futs.items():
            queries[q] = fut.result()
            write(args.out, queries)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")
    return 0


def write(path: str, queries: dict) -> None:
    data = {"source": "presto_tpu/queries/tpcds_queries.py::TPCDS_QUERIES "
                      "at tests/test_tpcds_suite.py's scale factors, "
                      "planned (prepare_plan) and run (run_query) by "
                      "presto_tpu on the CPU; plan_timed planned at "
                      "timed_sf",
            "queries": dict(sorted(queries.items(),
                                   key=lambda kv: int(kv[0][1:])))}
    with open(path, "w") as f:
        json.dump(data, f, separators=(",", ":"), sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    sys.exit(main())
