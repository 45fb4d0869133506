"""Write presto_tpu_torch/queries/tpch_sf1.json from the reference.

    python scripts/make_tpch_corpus.py [--out PATH]

For each TPC-H query of presto_tpu/queries/tpch_sql.py::TPCH_QUERIES in
CORPUS_QUERIES (the ones chip_smoke.py does not already check against a
numpy oracle), for each probe of PROBES and for each statement of
STATEMENTS (set operations, count(DISTINCT) over a varchar and outer
joins from presto_tpu/verifier.py::DEFAULT_CORPUS), the reference plans
the SQL with the query's own max_groups and join_capacity (plan_sql's
defaults for a statement), prepares the plan at SF1, runs it through
its own run_query on the CPU, and the file records the plan-fragment
JSON and
the rows in the exact form of presto_tpu_torch.queries (scaled
integers, days, text, float.hex). chip_smoke.py runs each plan through
the port on the card and holds its rows equal to these. A run takes a
few minutes of CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

SF = 1.0
CORPUS_QUERIES = (2, 4, 5, 7, 8, 9, 10, 11, 12, 13, 15, 16, 17, 18, 19,
                  20, 21, 22)
# q11 and q18 return no rows at SF1: q11's HAVING share (0.001 of the
# total) is 200x a part's average share at SF1's 200,000 parts, and no
# order of the generator reaches q18's 210 units. Each probe is the
# query with that constant moved so that rows come back: q11's share
# scaled as TPC-H scales its FRACTION (0.0001 / SF, here from the
# sf 0.01 the CPU tests run), q18's threshold lowered to 185 units
# (about 640 orders at SF1). name -> (query, constant, probe's constant)
PROBES = {"q11_probe": (11, "* 0.001", "* 0.00001"),
          "q18_probe": (18, "> 210.00", "> 185.00")}


# name -> index in presto_tpu/verifier.py::DEFAULT_CORPUS
STATEMENTS = {"set_intersect": 5, "set_union": 6, "count_distinct_str": 8,
              "right_join": 19, "full_join": 20}
# plan_sql's own max_groups and join_capacity, which a statement keeps
STATEMENT_MAX_GROUPS, STATEMENT_JOIN_CAPACITY = 1 << 16, None


def probe_text(name: str) -> str:
    """The probe's SQL: its query's text with the one constant moved."""
    from presto_tpu.queries.tpch_sql import TPCH_QUERIES
    n, old, new = PROBES[name]
    text = TPCH_QUERIES[n].text
    assert text.count(old) == 1, (name, old)
    return text.replace(old, new)


def entry_source(name: str):
    """(SQL text, max_groups, join_capacity) of a corpus entry: a query
    qN, a probe or a statement."""
    from presto_tpu.queries.tpch_sql import TPCH_QUERIES
    from presto_tpu.verifier import DEFAULT_CORPUS
    if name in STATEMENTS:
        return (DEFAULT_CORPUS[STATEMENTS[name]], STATEMENT_MAX_GROUPS,
                STATEMENT_JOIN_CAPACITY)
    q = TPCH_QUERIES[PROBES[name][0] if name in PROBES else int(name[1:])]
    text = probe_text(name) if name in PROBES else q.text
    return text, q.max_groups, q.join_capacity


def entry_names():
    """Every entry of the corpus: the queries, the probes, the
    statements."""
    return [f"q{n}" for n in CORPUS_QUERIES] + sorted(PROBES) + \
        sorted(STATEMENTS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(
        REPO, "presto_tpu_torch", "queries", "tpch_sf1.json"))
    args = ap.parse_args(argv)

    import presto_tpu  # noqa: F401  (jax x64 first)
    from presto_tpu.exec import run_query
    from presto_tpu.exec.runner import prepare_plan
    from presto_tpu.plan import nodes as RN
    from presto_tpu.sql import plan_sql
    from presto_tpu_torch import types as PT
    from presto_tpu_torch.queries import exact_rows

    queries = {}
    for name in entry_names():
        text, max_groups, join_capacity = entry_source(name)
        t0 = time.perf_counter()
        prepared = prepare_plan(plan_sql(text, max_groups=max_groups,
                                         join_capacity=join_capacity),
                                sf=SF)
        res = run_query(prepared, sf=SF, prepared=True)
        types = [PT.parse_type(str(t)) for t in res.types]
        queries[name] = {
            "plan": RN.to_json(prepared), "names": list(res.names),
            "types": [str(t) for t in types],
            "rows": exact_rows(res.columns, res.nulls, types, res.row_count),
            "max_groups": max_groups, "join_capacity": join_capacity}
        print(f"{name}: {res.row_count} rows in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    data = {"sf": SF,
            "source": "presto_tpu/queries/tpch_sql.py::TPCH_QUERIES, "
                      "scripts/make_tpch_corpus.py::PROBES and "
                      "presto_tpu/verifier.py::DEFAULT_CORPUS (STATEMENTS), "
                      "planned and run by presto_tpu (prepare_plan, "
                      "run_query) on the CPU",
            "queries": queries}
    with open(args.out, "w") as f:
        json.dump(data, f, separators=(",", ":"), sort_keys=True)
        f.write("\n")
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
