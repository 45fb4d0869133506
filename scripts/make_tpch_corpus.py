"""Write presto_tpu_torch/queries/tpch_sf1.json from the reference.

    python scripts/make_tpch_corpus.py [--out PATH]
    python scripts/make_tpch_corpus.py --add-sql [--out PATH]

Entries, each with a `kind`:

* "single": each TPC-H query of presto_tpu/queries/tpch_sql.py::
  TPCH_QUERIES in CORPUS_QUERIES (the ones chip_smoke.py does not
  already check against a numpy oracle), each probe of PROBES and each
  statement of STATEMENTS (set operations, count(DISTINCT) over a
  varchar and outer joins from presto_tpu/verifier.py::DEFAULT_CORPUS);
* "two_stage": all 22 TPC-H queries as the reference distributes them,
  `add_exchanges` over the prepared plan (PARTIAL -> REMOTE exchange ->
  FINAL aggregations, partial TopN/Limit under a GATHER, a MERGE over a
  local Sort). They keep the rows of the query's single plan: the
  script first asserts at sf 0.01 that the reference returns the same
  rows for both plans of every query;
* "aggregate": the statements of AGGREGATES (the hash-slot group-by
  with min_by/max_by/checksum/corr/geometric_mean, the variance family
  and bool_or on the sorted path, approx_distinct grouped and global)
  and the two-stage plans of AGGREGATES_TWO_STAGE, each with its own
  rows.

The reference plans the SQL with the query's own max_groups and
join_capacity (plan_sql's defaults for a statement), prepares the plan
at SF1, runs it through its own run_query on the CPU, and the file
records the plan-fragment JSON and the rows in the exact form of
presto_tpu_torch.queries (scaled integers, days, text, float.hex).
chip_smoke.py runs each plan through the port on the card and holds its
rows equal to these. A run takes about a quarter of an hour of CPU.

Each entry also holds its SQL text as "sql" (`entry_source`; a
two-stage entry the text of the statement it distributes), from which
chip_smoke.py plans it through the port's own front door. `--add-sql`
writes only that field into the existing file, planning and running
nothing: every plan and row stays as it is.
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

# every TPC-H query also runs as the reference distributes it
TWO_STAGE_QUERIES = tuple(range(1, 23))
TWO_STAGE = "_two_stage"
# aggregate statements, planned with plan_sql's defaults: name -> SQL,
# or the index of a DEFAULT_CORPUS statement
AGGREGATES = {
    # the hash-slot group-by: 6.0M rows, 200,000 groups
    "agg_hash": "SELECT partkey, min_by(suppkey, extendedprice), "
                "max_by(orderkey, quantity), checksum(orderkey), "
                "corr(quantity, extendedprice), geometric_mean(quantity) "
                "FROM lineitem GROUP BY partkey ORDER BY partkey LIMIT 100",
    # the sorted group-by's moments: 10,000 groups
    "agg_moments": "SELECT suppkey, stddev_samp(extendedprice), "
                   "var_pop(quantity), bool_or(discount > 0.05), count(*) "
                   "FROM lineitem GROUP BY suppkey ORDER BY suppkey "
                   "LIMIT 100",
    "approx_distinct": 9,
    # HLL over 1.5M distinct keys in one group
    "approx_distinct_global": "SELECT approx_distinct(orderkey) FROM "
                              "lineitem",
}
AGGREGATES_TWO_STAGE = ("agg_hash",)


def probe_text(name: str) -> str:
    """The probe's SQL: its query's text with the one constant moved."""
    from presto_tpu.queries.tpch_sql import TPCH_QUERIES
    n, old, new = PROBES[name]
    text = TPCH_QUERIES[n].text
    assert text.count(old) == 1, (name, old)
    return text.replace(old, new)


def base_name(name: str) -> str:
    """The entry whose SQL a two-stage entry distributes (itself for
    the others)."""
    return name[:-len(TWO_STAGE)] if name.endswith(TWO_STAGE) else name


def entry_kind(name: str) -> str:
    if base_name(name) in AGGREGATES:
        return "aggregate"
    return "two_stage" if name.endswith(TWO_STAGE) else "single"


def entry_source(name: str):
    """(SQL text, max_groups, join_capacity) of a corpus entry: a query
    qN, a probe, a statement, an aggregate statement, or the two-stage
    form of one of them."""
    from presto_tpu.queries.tpch_sql import TPCH_QUERIES
    from presto_tpu.verifier import DEFAULT_CORPUS
    name = base_name(name)
    if name in AGGREGATES:
        text = AGGREGATES[name]
        if isinstance(text, int):
            text = DEFAULT_CORPUS[text]
        return text, STATEMENT_MAX_GROUPS, STATEMENT_JOIN_CAPACITY
    if name in STATEMENTS:
        return (DEFAULT_CORPUS[STATEMENTS[name]], STATEMENT_MAX_GROUPS,
                STATEMENT_JOIN_CAPACITY)
    q = TPCH_QUERIES[PROBES[name][0] if name in PROBES else int(name[1:])]
    text = probe_text(name) if name in PROBES else q.text
    return text, q.max_groups, q.join_capacity


def prepared_entry(name: str, sf: float):
    """The reference's prepared plan of an entry at `sf`, through
    add_exchanges for a two-stage entry (one device, no mesh)."""
    from presto_tpu.exec.runner import prepare_plan
    from presto_tpu.plan.distribute import add_exchanges
    from presto_tpu.sql import plan_sql
    text, max_groups, join_capacity = entry_source(name)
    plan = prepare_plan(plan_sql(text, max_groups=max_groups,
                                 join_capacity=join_capacity), sf=sf)
    if name.endswith(TWO_STAGE):
        plan = add_exchanges(plan, sf=sf)
    return plan


def entry_names():
    """Every entry of the corpus: the queries, the probes, the
    statements, the two-stage queries, the aggregate statements."""
    return [f"q{n}" for n in CORPUS_QUERIES] + sorted(PROBES) + \
        sorted(STATEMENTS) + \
        [f"q{n}{TWO_STAGE}" for n in TWO_STAGE_QUERIES] + \
        sorted(AGGREGATES) + [a + TWO_STAGE for a in AGGREGATES_TWO_STAGE]


def _exact(res):
    from presto_tpu_torch import types as PT
    from presto_tpu_torch.queries import exact_rows
    types = [PT.parse_type(str(t)) for t in res.types]
    return types, exact_rows(res.columns, res.nulls, types, res.row_count)


def check_two_stage_rows(sf: float = 0.01) -> None:
    """The reference's two-stage plan of every TPC-H query returns its
    single plan's rows at `sf`, exactly."""
    from presto_tpu.exec import run_query
    for n in TWO_STAGE_QUERIES:
        single = _exact(run_query(prepared_entry(f"q{n}", sf), sf=sf,
                                  prepared=True))
        two = _exact(run_query(prepared_entry(f"q{n}{TWO_STAGE}", sf),
                               sf=sf, prepared=True))
        assert two == single, f"q{n}: two-stage rows differ at sf {sf}"
    print(f"two-stage rows equal the single plans' at sf {sf}", flush=True)


def add_sql(path: str) -> None:
    """Write each entry's SQL text as "sql" into the corpus file at
    `path`, changing nothing else."""
    with open(path) as f:
        data = json.load(f)
    for name, q in data["queries"].items():
        q["sql"] = entry_source(name)[0]
    _write(path, data)


def _write(path: str, data: dict) -> None:
    with open(path, "w") as f:
        json.dump(data, f, separators=(",", ":"), sort_keys=True)
        f.write("\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(
        REPO, "presto_tpu_torch", "queries", "tpch_sf1.json"))
    ap.add_argument("--add-sql", action="store_true",
                    help="only write each entry's SQL text into --out")
    args = ap.parse_args(argv)
    if args.add_sql:
        add_sql(args.out)
        print(f"wrote the SQL texts into {args.out}")
        return 0

    import presto_tpu  # noqa: F401  (jax x64 first)
    from presto_tpu.exec import run_query
    from presto_tpu.plan import nodes as RN

    check_two_stage_rows()
    queries = {}
    for name in entry_names():
        t0 = time.perf_counter()
        prepared = prepared_entry(name, SF)
        single = queries.get(base_name(name))
        if entry_kind(name) == "two_stage" and single is not None:
            # the single plan's rows (equal at sf 0.01, asserted above)
            names, types, rows = (single["names"], single["types"],
                                  single["rows"])
        else:
            # q1, q3, q6 and q14 have no single entry: their two-stage
            # entries take the rows of the single plan
            res = run_query(prepared_entry(base_name(name), SF)
                            if entry_kind(name) == "two_stage" else prepared,
                            sf=SF, prepared=True)
            types, rows = _exact(res)
            names, types = list(res.names), [str(t) for t in types]
        _, max_groups, join_capacity = entry_source(name)
        queries[name] = {
            "sql": entry_source(name)[0],
            "plan": RN.to_json(prepared), "names": names, "types": types,
            "rows": rows, "kind": entry_kind(name),
            "max_groups": max_groups, "join_capacity": join_capacity}
        print(f"{name}: {len(rows)} rows in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    data = {"sf": SF,
            "source": "presto_tpu/queries/tpch_sql.py::TPCH_QUERIES, "
                      "scripts/make_tpch_corpus.py::PROBES, "
                      "presto_tpu/verifier.py::DEFAULT_CORPUS (STATEMENTS) "
                      "and scripts/make_tpch_corpus.py::AGGREGATES, "
                      "planned and run by presto_tpu (prepare_plan, "
                      "add_exchanges for the two-stage entries, "
                      "run_query) on the CPU",
            "queries": queries}
    _write(args.out, data)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
